"""Functional MemN2N — the reference's model assembly
(MemN2N/MemN2N.c:826-912 construction, :1372-1532 forward) re-designed as a
pure batched JAX function over padded/masked memory.

Weight tying is by construction (shared parameters), replacing the
reference's per-batch gradient-accumulate + weight-copy dance
(MemN2N/MemN2N.c:1725-1815).  For the default layer-wise (RNN) tying this
is exactly equivalent: the reference accumulates every hop's delta into
hop 0, updates hop 0, then broadcasts hop 0's weights to all hops — i.e.
one shared matrix updated with the summed gradient, which is what a shared
parameter gives automatically.

Parameter layout (all float32 master weights — the reference keeps float
master weights and quantizes inside forward ops only; weight update runs
f_fixed=false, lib/layer.c:2205-2207):

  tying type 2 (layer-wise, default TYPE_WEIGHT_TYING=2, define.h:287):
    A [D, I]  shared memory embedding (emb_m[*])
    C [D, I]  shared output memory embedding (emb_c[*])
    B [D, I]  query embedding (emb_q)
    H [D, D]  shared linear map (lin_map[*], EN_LINEAR_MAPPING define.h:291)
    W [I, D]  output layer (ds_ans; float)
    scale [K] per-hop scalar before the attention softmax (EN_SC_ATT)

  tying type 1 (adjacent):
    E [K+1, D, I] embedding chain with A_h = E[h], C_h = E[h+1],
    B = E[0], W = E[K]^T   (the clean adjacent scheme of the MemN2N
    paper; the reference's type-1 code path applies the same constraint
    set via copies, MemN2N/MemN2N.c:1643-1724)
    H [K, D, D] per-hop linear maps (not tied in type 1)
    scale [K]

Per-hop Q-format wiring follows MemN2N/MemN2N.c:826-912:
  emb_q / emb_m / emb_c / lin_map use the hop's weight format fmt_w[h]
  (EN_MQ gives hop 0 one more integer bit, hop 2 one less);
  attention uses (fmt_att[h], fmt_bin); weighted sum and residual use
  fmt_act[h]; the output layer runs float.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import jax
import jax.numpy as jnp

from qmann_tpu.config import QmannConfig
from qmann_tpu.ops import (
    activation, apply_softmax, attention_score, cross_entropy, qembed_mat,
    qembed_mat_multi, qmatvec, qscore, qsum, qweighted_sum, scale_apply,
    CEMetrics,
)

Params = Dict[str, jax.Array]


class ForwardResult(NamedTuple):
    logits: jax.Array            # [B, dim_input]
    attention: jax.Array         # [K, B, M] per-hop attention probabilities
    scores: jax.Array            # [K, B, M] per-hop pre-softmax scores


def init_params(cfg: QmannConfig, dims, key: jax.Array) -> Params:
    """Gaussian(0, 0.1) init for every weight matrix (dense_init,
    lib/layer.c:1738; Box-Muller gaussian_random, lib/common.c:31-48)."""
    D, I, K = cfg.dim_emb, dims.dim_input, cfg.num_hops

    def g(key, shape):
        return 0.1 * jax.random.normal(key, shape, jnp.float32)

    keys = jax.random.split(key, 8)
    params: Params = {}
    if cfg.type_weight_tying == 1:
        params["E"] = g(keys[0], (K + 1, D, I))
        if cfg.en_linear_mapping:
            params["H"] = g(keys[1], (K, D, D))
    else:
        params["A"] = g(keys[0], (D, I))
        params["C"] = g(keys[1], (D, I))
        params["B"] = g(keys[2], (D, I))
        params["W"] = g(keys[3], (I, D))
        if cfg.en_linear_mapping:
            params["H"] = g(keys[4], (D, D))
    if cfg.en_sc_att:
        # scale layers initialize their scalar to 1.0 (scale_constructor)
        params["scale"] = jnp.ones((K,), jnp.float32)
    if cfg.test_maxout:
        from qmann_tpu.models.maxout import init_maxout_params
        params["maxout_w"], params["maxout_b"] = init_maxout_params(keys[5])
    return params


def _hop_weights(params: Params, cfg: QmannConfig, h: int):
    if cfg.type_weight_tying == 1:
        a = params["E"][h]
        c = params["E"][h + 1]
        hmat = params["H"][h] if cfg.en_linear_mapping else None
    else:
        a = params["A"]
        c = params["C"]
        hmat = params["H"] if cfg.en_linear_mapping else None
    return a, c, hmat


def _query_weight(params: Params, cfg: QmannConfig):
    return params["E"][0] if cfg.type_weight_tying == 1 else params["B"]


def _output_weight(params: Params, cfg: QmannConfig):
    if cfg.type_weight_tying == 1:
        return jnp.swapaxes(params["E"][cfg.num_hops], 0, 1)
    return params["W"]


def forward(params: Params, memory: jax.Array, question: jax.Array,
            mask: jax.Array, cfg: QmannConfig,
            remove_softmax: bool = False) -> ForwardResult:
    """Batched K-hop forward pass (reference per-sample flow,
    MemN2N/MemN2N.c:1372-1532; SURVEY.md section 3.2).

    memory:   [B, M, dim_input] bag-of-words sentence rows (padded)
    question: [B, dim_input] bag-of-words query
    mask:     [B, M] bool validity of memory rows
    remove_softmax: linear-start mode (MemN2N/MemN2N.c:1080-1099)
    """
    q = cfg.en_fixed_point
    fmt_w = cfg.fmt_w
    K = cfg.num_hops
    # question/memory rows are integer bag-of-words counts unless EN_PE
    # replaces the question counts with position-encoding weights
    # (sample.c:546-547)
    q_integer = not cfg.en_pe and cfg.en_integer_fast_path

    with jax.named_scope("embed"):
        # u = B q  (emb_q: dense with in/w formats both fmt_w[0],
        # MemN2N/MemN2N.c:823; dense backwards are float under every
        # EN_GRAD_QUANT placement — see qlinear.qmatvec's note)
        u = qmatvec(_query_weight(params, cfg), question,
                    fmt_w[0], fmt_w[0], quantized=q, integer_inputs=q_integer)

        # All 2K memory embeddings (A and C per hop, per-hop formats under
        # EN_MQ) in ONE stacked matmul — the reference runs 2K sequential
        # dense_mat_fwd kernels here (MemN2N/MemN2N.c:1372-1532)
        hop_w = [_hop_weights(params, cfg, h) for h in range(K)]
        embeds = qembed_mat_multi(
            memory,
            tuple(w[0] for w in hop_w) + tuple(w[1] for w in hop_w),
            tuple(fmt_w[h] for h in range(K)) * 2,
            quantized=q, integer_inputs=cfg.en_integer_fast_path)

    with jax.named_scope("hop_chain"):
        return _hop_stack(params, cfg, u, embeds, mask, remove_softmax)


def _hop_stack(params: Params, cfg: QmannConfig, u: jax.Array,
               embeds, mask: jax.Array,
               remove_softmax: bool) -> ForwardResult:
    """The K-hop controller loop given the query embedding u and the 2K
    memory embeddings (A_0..A_{K-1}, C_0..C_{K-1}) — shared between the
    training forward and the serving-prepared forward.  Callers run it
    under the "hop_chain" named scope (the output layer is under
    "output"): the names bench.trace_forward attributes device time by."""
    q = cfg.en_fixed_point
    fmt_w, fmt_act, fmt_att = cfg.fmt_w, cfg.fmt_act, cfg.fmt_att
    mask_f = mask.astype(jnp.float32)
    K = cfg.num_hops
    # dot_mat_vec family quantization rules live in ONE place:
    # QmannConfig's dispatch properties (see config.py's dispatch note)
    gq = cfg.grad_quant_backward
    wsum_q = cfg.wsum_quantized
    wsum_gq = cfg.wsum_grad_quantized

    attn, scores_all = [], []
    for h in range(K):
        _, _, h_w = _hop_weights(params, cfg, h)
        m = embeds[h]                                         # [B, M, D]
        c = embeds[K + h]                                     # [B, M, D]

        if cfg.en_cosine_sim and cfg.attention_mode in (1, 2):
            # EN_COSINE_SIM (define.h:200; _cuda_normalize_vec,
            # lib/layer_cuda.cu:1743-1781): L2-normalize both operands
            # before the score
            m_sc = m / jnp.maximum(
                jnp.linalg.norm(m, axis=-1, keepdims=True), 1e-12)
            u_sc = u / jnp.maximum(
                jnp.linalg.norm(u, axis=-1, keepdims=True), 1e-12)
        else:
            m_sc, u_sc = m, u
        scores = attention_score(
            m_sc, u_sc, cfg.attention_mode, fmt_att[h], cfg.fmt_bin,
            num_bit=cfg.num_bits_attention,
            const_scale=cfg.attention_const_scale,
            score_mod=cfg.att_score_mod,
            hamming_weight_para=cfg.hamming_weight_para,
            hamming_weighted=cfg.hamming_weighted,
            grad_quantized=gq)                                # [B, M]
        if cfg.en_sc_att and not remove_softmax:
            scores = scale_apply(params["scale"][h], scores)
        if cfg.test_maxout:
            from qmann_tpu.models.maxout import maxout_attention
            p = maxout_attention(scores, params["maxout_w"],
                                 params["maxout_b"], mask)
        else:
            p = apply_softmax(scores, mask,
                              shift_based=cfg.en_shift_based_sm,
                              use_exp_plan=cfg.en_exp_table_based,
                              remove=remove_softmax)           # [B, M]
        o = qweighted_sum(c, p, mask_f, fmt_act[h], quantized=wsum_q,
                          grad_quantized=wsum_gq)              # [B, D]

        if cfg.en_linear_mapping:
            # lin_map: dense(D->D) with in fmt_bin / w fmt_w[h]
            # (MemN2N/MemN2N.c:860)
            u_mapped = qmatvec(h_w, u, fmt_w[h], cfg.fmt_bin, quantized=q)
        else:
            u_mapped = u
        u = qsum(u_mapped, o, fmt_act[h], quantized=q)         # [B, D]
        if cfg.en_non_linearity:
            u = activation(u, "RELU", fmt_act[h], q, grad_quantized=gq)
        attn.append(p)
        scores_all.append(scores)

    # output layer runs float (MemN2N/MemN2N.c:766-767, 902-906)
    with jax.named_scope("output"):
        logits = qmatvec(_output_weight(params, cfg), u,
                         cfg.fmt_ds_ans, cfg.fmt_ds_ans, quantized=False)
    return ForwardResult(logits, jnp.stack(attn), jnp.stack(scores_all))


def loss_and_metrics(params: Params, memory, question, answer, mask,
                     sample_mask: Optional[jax.Array], cfg: QmannConfig,
                     remove_softmax: bool = False):
    """Total (summed) loss over the valid samples of a batch plus the
    reference's reported metrics.  sample_mask [B] (1 valid / 0 padding)
    supports the final partial batch (MemN2N/MemN2N.c:1222-1227)."""
    out = forward(params, memory, question, mask, cfg, remove_softmax)
    met: CEMetrics = cross_entropy(out.logits, answer)
    if sample_mask is None:
        return met.loss, met
    logp = jax.nn.log_softmax(out.logits, axis=-1)
    per_sample = -jnp.sum(answer * logp, axis=-1)
    loss = jnp.sum(per_sample * sample_mask)
    probs = jax.lax.stop_gradient(jnp.exp(logp))
    cost = -jnp.sum(jnp.sum(answer * probs, axis=-1) * sample_mask)
    hit = jnp.take_along_axis(answer, met.pred[..., None], axis=-1)[..., 0]
    matches = jnp.sum((hit == 1.0).astype(jnp.float32) * sample_mask)
    return loss, CEMetrics(loss=loss, cost=cost,
                           matches=matches.astype(jnp.int32), pred=met.pred)


# ---------------------------------------------------------------------------
# Serving-prepared inference: pre-quantized weights + statically decided
# exact-matmul fast paths
# ---------------------------------------------------------------------------

class PreparedInference(NamedTuple):
    """Inference-layout parameters produced by prepare_inference.

    The regular forward decides the exact-matmul fast paths (qlinear's
    integer-input routes) with per-batch runtime checks under lax.cond —
    correct for training, where weights change every step, but in serving
    the conditionals and the per-call weight quantize/concat/layout work
    are pure fixed cost.  Here the exactness conditions are checked ONCE on
    the host against the frozen weights plus caller-supplied input bounds,
    the fast-path decision becomes trace-time static (no lax.cond), and
    the quantized/stacked/cast weights are computed once and cached.
    """
    raw: Params                        # original parameters (fallback path)
    fast: bool                         # static exact-matmul route decision
    query_wt: Optional[jax.Array]      # [I, D] quantized emb_q, transposed
    embed_wt: Optional[jax.Array]      # [I, 2K*D] stacked quantized A/C


def _max_abs_q(w: jax.Array, fmt) -> float:
    from qmann_tpu.numerics import float_quant
    import numpy as np
    return float(np.max(np.abs(np.asarray(float_quant(w, fmt)))))


def prepare_inference(params: Params, cfg: QmannConfig,
                      max_count: float = 16.0,
                      max_rowsum: float = 128.0) -> PreparedInference:
    """Freeze params into serving layout.

    max_count / max_rowsum bound the incoming bag-of-words features: the
    largest single count and the largest per-row count sum the caller will
    ever submit (bAbI sentences are <= 50 tokens and the vectorizer caps
    stories at 50 rows, so the defaults hold with wide margin; the serving
    engine derives them from its vectorizer).  The fast path is enabled
    only if, under these bounds, every per-product re-quantization in
    qembed_mat/qmatvec is provably the identity and every partial sum is
    f32-exact — the same conditions qlinear checks at runtime
    (_integer_input_fast_path_ok), evaluated once here against the frozen
    weights.
    """
    from qmann_tpu.numerics import fixed_max_float, float_quant
    from qmann_tpu.ops.qlinear import _exact_bf16

    K = cfg.num_hops
    fmt_w = cfg.fmt_w
    fmts = tuple(fmt_w[h] for h in range(K)) * 2 + (fmt_w[0],)
    hop_w = [_hop_weights(params, cfg, h) for h in range(K)]
    mats = ([w[0] for w in hop_w] + [w[1] for w in hop_w]
            + [_query_weight(params, cfg)])

    fast = (cfg.en_fixed_point and not cfg.en_pe
            and not any(f.is_binary for f in fmts))
    if fast:
        for w, fmt in zip(mats, fmts):
            maxf = fixed_max_float(fmt.iwl, fmt.frac)
            max_wq = _max_abs_q(w, fmt)
            ok = (max_count <= maxf and max_count * max_wq <= maxf
                  and max_rowsum * max_wq * 2.0 ** fmt.frac < 2.0 ** 24)
            if not ok:
                fast = False
                break
    if not fast:
        return PreparedInference(params, False, None, None)

    bf16 = all(_exact_bf16(f) for f in fmts)
    dt = jnp.bfloat16 if bf16 else jnp.float32

    def prep(w, fmt):
        return jnp.swapaxes(float_quant(w, fmt), 0, 1).astype(dt)

    embed_wt = jnp.concatenate(
        [prep(w, fmt) for w, fmt in zip(mats[:-1], fmts[:-1])], axis=1)
    query_wt = prep(mats[-1], fmts[-1])
    return PreparedInference(params, True, query_wt, embed_wt)


def forward_prepared(prep: PreparedInference, memory: jax.Array,
                     question: jax.Array, mask: jax.Array,
                     cfg: QmannConfig) -> ForwardResult:
    """Bit-identical to forward() under prepare_inference's bounds, with
    zero per-call weight processing and no runtime fast-path dispatch."""
    if not prep.fast:
        return forward(prep.raw, memory, question, mask, cfg)

    from qmann_tpu.numerics import float_quant, float_quant_blocks
    from qmann_tpu.ops.qlinear import _exact_matmul

    K = cfg.num_hops
    fmt_w = cfg.fmt_w
    bf16 = prep.query_wt.dtype == jnp.bfloat16
    dt = prep.query_wt.dtype
    D = prep.query_wt.shape[1]

    with jax.named_scope("embed"):
        # u = B q: one matmul on the cached quantized transpose (exact
        # under the prepare-time bounds; f32 accumulate)
        u = float_quant(
            _exact_matmul(question.astype(dt), prep.query_wt, bf16),
            fmt_w[0])

        # all 2K hop embeddings in one matmul, requantized per hop format
        flat = _exact_matmul(memory.astype(dt), prep.embed_wt,
                             bf16)                          # [B, M, 2K*D]

        # one fused per-block requant over the stacked matmul output; the
        # per-hop slices then fuse into the hop chain's consumers
        flatq = float_quant_blocks(
            flat, tuple(fmt_w[i % K] for i in range(2 * K)), (D,) * (2 * K))
        embeds = tuple(flatq[..., i * D:(i + 1) * D] for i in range(2 * K))

    with jax.named_scope("hop_chain"):
        return _hop_stack(prep.raw, cfg, u, embeds, mask, False)
