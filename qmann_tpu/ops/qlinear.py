"""Quantized linear-algebra ops with reference-faithful custom VJPs.

These are the JAX equivalents of the reference's CUDA matmul kernels:

  * _cuda_mat_vec_product        (lib/layer_cuda.cu:49-83)    dense fwd
  * _cuda_mat_mat_trans_product  (lib/layer_cuda.cu:105-172)  attention score,
                                                              dense_mat fwd
  * _cuda_mat_trans_mat_product  (lib/layer_cuda.cu:547-635)  weighted sum
  * _cuda_mat_mat_product_accum  (lib/layer_cuda.cu:1465-...) dense bwd w-del
  * XNOR-net L1 scale            (lib/layer_cuda.cu:3188-3200)

Forward semantics (f_fixed=true): each operand is fake-quantized in its own
Q-format, each *product* is re-quantized to the first operand's format
(CUDA_FIXED_MUL, lib/layer_cuda.h:258), products are accumulated in float,
and the row sum is re-quantized to the output format.

Backward semantics: the reference never quantizes gradients (EN_GRAD_QUANT
undefined, MemN2N/define.h:91) — every backward kernel runs in plain float
on the *raw* stored tensors, not their quantized values (e.g.
cuda_dense_bwd passes f_fixed=false and uses dev_in_vec / dev_w_mat
directly, lib/layer_cuda.cu:3266-3284).  That is a straight-through
estimator **through the whole op**, which is why these are custom_vjp ops
rather than compositions of STE quantizers (the latter would differentiate
through the quantized operands instead of the raw ones).

Every backward matmul therefore runs at ``precision=HIGHEST`` (full
float32, never TF32 or bf16): the forward's bf16 exactness argument does
NOT extend to the VJPs, because cotangents are arbitrary float32 values
with full 24-bit significands — there is no integer/grid structure to make
reduced-precision rounding the identity — and raw float weights/inputs
(unquantized in the backward by reference semantics) are equally
off-grid.  A default-precision matmul may round both operands (TF32 on
the GPU); HIGHEST is the faithful choice.

Why the products are requantized elementwise rather than in a matmul: the
per-product truncation is applied *before* the summation, so the reduction
cannot be expressed as a single matmul.  XLA fuses the
broadcast-multiply-quantize-reduce chain into one loop fusion.

All ops accept arbitrary leading batch dimensions; weight gradients are
summed over them — matching the reference's per-sample accumulation into
``w_mat_del`` over a batch (MemN2N/MemN2N.c:1183-1617).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from qmann_tpu.numerics import (QFormat, fixed_max_float, float_quant,
                                float_quant_blocks)


def _qproducts(a: jax.Array, b: jax.Array, fmt_a: QFormat, fmt_b: QFormat,
               fmt_prod: QFormat) -> jax.Array:
    """Per-product quantized multiply: Q(Q(a, fmt_a) * Q(b, fmt_b), fmt_prod).
    Shapes must already be broadcast-compatible."""
    return float_quant(float_quant(a, fmt_a) * float_quant(b, fmt_b), fmt_prod)


def _grad_out_fmt(fmt: QFormat) -> QFormat:
    """Output format of the EN_GRAD_QUANT backward contractions: the
    reference passes (iwl_out, frac_out) = (1, iwl+frac-1) — same word
    length shifted to one integer bit (cuda_dot_mat_vec_bwd,
    lib/layer_cuda.cu:2592-2596, :2605-2609)."""
    return QFormat(1, fmt.iwl + fmt.frac - 1, fmt.mode)


# ---------------------------------------------------------------------------
# qmatvec: out = W @ x   (dense layer forward, lib/layer_cuda.cu:3163-3210)
# ---------------------------------------------------------------------------

def _exact_bf16(fmt: QFormat) -> bool:
    """True when every value representable in ``fmt`` is exactly
    representable in bfloat16: the quantized magnitudes are integers
    <= 2^(iwl+frac)-1 on a power-of-two grid, and bf16's 8-bit significand
    holds every integer up to 256.  The 8-bit reference word (BW_WL=8,
    MemN2N/define.h:21) always qualifies."""
    return 0 < fmt.iwl + fmt.frac <= 8


def _exact_matmul(x, wq_t, exact_bf16: bool):
    """out = x @ wq_t, bit-exact to a real-arithmetic matmul.

    When both operand formats fit bf16 exactly (integer inputs, 8-bit
    Q-format weights), ONE bf16 matmul with an f32 accumulator is exact:
    bf16*bf16 products carry <= 16 significand bits (< f32's 24) and the
    fast-path conditions bound every partial sum under 2^24 grid units.
    Otherwise fall back to f32 HIGHEST to avoid a reduced-precision
    default (TF32 on the GPU) rounding wide Q-formats."""
    if exact_bf16:
        return jnp.matmul(x.astype(jnp.bfloat16), wq_t.astype(jnp.bfloat16),
                          preferred_element_type=jnp.float32)
    return jnp.matmul(x, wq_t, preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3, 4, 5))
def qmatvec(w: jax.Array, x: jax.Array, fmt_w: QFormat, fmt_x: QFormat,
            quantized: bool = True,
            integer_inputs: bool = False) -> jax.Array:
    """Quantized matrix-vector product: out[...,o] = Q(sum_i Q(Q(w)Q(x)))

    w: [O, I]; x: [..., I] -> [..., O].

    quantized=False gives the plain float path (f_fixed=false), used by the
    float output layer ds_ans (MemN2N/MemN2N.c:766-767,902-906) and
    attention mode 1.

    integer_inputs=True (bag-of-words query vectors, e.g. emb_q's input)
    enables the exact matmul fast path when no per-product re-quantization
    can bite — the qmatvec analog of qembed_mat's fast path; falls back
    dynamically otherwise.

    When fmt_w is the binary format (iwl+frac==0), the XNOR-net-style scale
    is applied: the output is multiplied by sum(w)/(O*I).  NB the
    reference's "_cuda_l1_norm" sums the raw weights (no abs),
    lib/layer_cuda.cu:1624-1650 — reproduced as-is.

    EN_GRAD_QUANT note: dense layers have NO live fixed-point backward
    effect in the reference — cuda_dense_bwd invokes the w-del accum with
    f_fixed hardcoded false (lib/layer_cuda.cu:3266), the grad_out matmul
    with f_fixed false (:3284), and the _cuda_grad_mask_fixed saturation
    mask is commented out ('test_170410' block, :3269-3281); only the
    sigmoid/relu activation derivative would quantize, and the model's
    dense layers all run activation "NULL".  So qmatvec's backward is
    float under every placement.
    """
    return _qmatvec_fwd_impl(w, x, fmt_w, fmt_x, quantized, integer_inputs)


def _qmatvec_integer_fast_ok(x, wq, fmt_w: QFormat, fmt_x: QFormat):
    """Exactness condition for collapsing qmatvec's per-product-quantized
    contraction into one matmul for small-integer inputs x (mixed-format
    variant of _integer_input_fast_path_ok):

      * Q(x, fmt_x) == x                  (|x| <= maxf_x; ints sit on any grid)
      * x * wq is on wq's 2^-frac_w grid  (x integer) and no product
        truncates or saturates when re-quantized to fmt_w:
        max|x| * max|wq| <= maxf_w
      * every partial row-sum stays < 2^24 grid units (f32-exact,
        order-independent accumulation)
    """
    maxf_x = fixed_max_float(fmt_x.iwl, fmt_x.frac)
    maxf_w = fixed_max_float(fmt_w.iwl, fmt_w.frac)
    max_x = jnp.max(jnp.abs(x))
    max_wq = jnp.max(jnp.abs(wq))
    max_row_units = (jnp.max(jnp.sum(jnp.abs(x), axis=-1)) * max_wq
                     * jnp.float32(2.0 ** fmt_w.frac))
    return ((max_x <= maxf_x) & (max_x * max_wq <= maxf_w)
            & (max_row_units < jnp.float32(2.0 ** 24)))


def _qmatvec_fwd_impl(w, x, fmt_w, fmt_x, quantized, integer_inputs=False):
    if not quantized:
        return jnp.einsum("oi,...i->...o", w, x,
                          preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)
    if (integer_inputs and not fmt_w.is_binary and not fmt_x.is_binary):
        wq = float_quant(w, fmt_w)

        def fast(_):
            bf16_ok = _exact_bf16(fmt_w) and _exact_bf16(fmt_x)
            return float_quant(
                _exact_matmul(x, jnp.swapaxes(wq, 0, 1), bf16_ok), fmt_w)

        def slow(_):
            prod = _qproducts(w, x[..., None, :], fmt_w, fmt_x, fmt_w)
            return float_quant(jnp.sum(prod, axis=-1), fmt_w)

        out = jax.lax.cond(_qmatvec_integer_fast_ok(x, wq, fmt_w, fmt_x),
                           fast, slow, None)
    else:
        prod = _qproducts(w, x[..., None, :], fmt_w, fmt_x, fmt_w)
        out = float_quant(jnp.sum(prod, axis=-1), fmt_w)
    if fmt_w.is_binary:
        scale = jnp.sum(w) / jnp.float32(w.shape[0] * w.shape[1])
        out = out * scale
    return out


def _qmatvec_fwd(w, x, fmt_w, fmt_x, quantized, integer_inputs):
    return (_qmatvec_fwd_impl(w, x, fmt_w, fmt_x, quantized, integer_inputs),
            (w, x))


def _qmatvec_bwd(fmt_w, fmt_x, quantized, integer_inputs, res, g):
    w, x = res
    # raw-float gradients (cuda_dense_bwd, lib/layer_cuda.cu:3266,3284):
    #   w_del += g (x)^T ; grad_x = W^T g  (float under EVERY placement —
    #   see the EN_GRAD_QUANT note in the op docstring)
    dw = jnp.einsum("...o,...i->oi", g, x, preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)
    dx = jnp.einsum("oi,...o->...i", w, g, preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)
    return dw, dx


qmatvec.defvjp(_qmatvec_fwd, _qmatvec_bwd)


# ---------------------------------------------------------------------------
# qembed_mat: M = S @ A^T  (dense_mat forward, lib/layer_cuda.cu:3512-3569)
# ---------------------------------------------------------------------------

@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3, 4))
def qembed_mat(s: jax.Array, a: jax.Array, fmt: QFormat,
               quantized: bool = True,
               integer_inputs: bool = False) -> jax.Array:
    """Memory embedding: s [..., M, I] (bag-of-words rows) x a [D, I]
    -> [..., M, D], with dense_mat's single Q-format applied to both
    operands, each product, and the output (cuda_dense_mat_fwd ->
    _cuda_mat_mat_trans_product, lib/layer_cuda.cu:3512-3569).

    This op carries the framework's largest intermediate (the
    [B, M, D, I] product lattice).

    integer_inputs=True (bag-of-words rows) enables an exact matmul fast
    path when no per-product re-quantization can bite (see
    _integer_input_fast_path_ok); falls back dynamically otherwise."""
    return _qembed_mat_impl(s, a, fmt, quantized, integer_inputs)


def _integer_input_fast_path_ok(s, a, fmt: QFormat):
    """Exactness condition for collapsing the per-product-quantized
    contraction into one matmul when the inputs are small nonnegative
    INTEGERS (bag-of-words counts):

      * Q(count, fmt) == count            (count <= maxf, trunc exact)
      * count * wq is on the 2^-frac grid (integer times grid value) and
        within f32 exactness (counts*2^(iwl+frac) << 2^24)
      * Q(count * wq, fmt) == count * wq  (no product saturates:
        max_count * max|wq| <= maxf)

    Under these, every per-product re-quantization (CUDA_FIXED_MUL,
    lib/layer_cuda.h:258) is the identity, so the sum of quantized
    products equals the plain matmul of counts with quantized weights —
    bit-for-bit, but as one matmul instead of an elementwise lattice."""
    maxf = fixed_max_float(fmt.iwl, fmt.frac)
    max_s = jnp.max(jnp.abs(s))
    max_wq = jnp.max(jnp.abs(float_quant(a, fmt)))
    # f32-exactness: every product and every partial row-sum must sit on
    # the 2^-frac grid with < 2^24 grid units, so f32 accumulation in any
    # order (any matmul tiling included) is exact and order-independent.
    max_row_units = (jnp.max(jnp.sum(jnp.abs(s), axis=-1)) * max_wq
                     * jnp.float32(2.0 ** fmt.frac))
    return ((max_s <= maxf) & (max_s * max_wq <= maxf)
            & (max_row_units < jnp.float32(2.0 ** 24)))


def _qembed_mat_impl(s, a, fmt, quantized, integer_inputs=False):
    if not quantized:
        return jnp.einsum("...mi,di->...md", s, a,
                          preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)

    def slow(_):
        prod = _qproducts(s[..., :, None, :], a, fmt, fmt, fmt)  # [...,M,D,I]
        return float_quant(jnp.sum(prod, axis=-1), fmt)

    if not integer_inputs or fmt.is_binary:
        return slow(None)

    def fast(_):
        aq = float_quant(a, fmt)
        # one exact bf16 matmul for 8-bit formats (see _exact_bf16);
        # f32 HIGHEST otherwise — the default precision would round wide
        # Q-format weights and break bit-exactness with the slow path.
        return float_quant(
            _exact_matmul(s, jnp.swapaxes(aq, 0, 1), _exact_bf16(fmt)), fmt)

    return jax.lax.cond(_integer_input_fast_path_ok(s, a, fmt), fast, slow,
                        None)


def _qembed_mat_fwd(s, a, fmt, quantized, integer_inputs):
    return _qembed_mat_impl(s, a, fmt, quantized, integer_inputs), (s, a)


def _qembed_mat_bwd(fmt, quantized, integer_inputs, res, g):
    s, a = res
    # dense_mat_bwd: A_del += grad^T S in float
    # (_cuda_mat_trans_mat_product_accum, lib/layer_cuda.cu:637-690)
    da = jnp.einsum("...md,...mi->di", g, s, preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)
    ds = jnp.einsum("...md,di->...mi", g, a, preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)
    return ds, da


qembed_mat.defvjp(_qembed_mat_fwd, _qembed_mat_bwd)


# ---------------------------------------------------------------------------
# qembed_mat_multi: every hop's A/C embedding in ONE matmul
# ---------------------------------------------------------------------------

@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3, 4))
def qembed_mat_multi(s: jax.Array, weights: Tuple[jax.Array, ...],
                     fmts: Tuple[QFormat, ...], quantized: bool = True,
                     integer_inputs: bool = False) -> Tuple[jax.Array, ...]:
    """K independent qembed_mat calls sharing one input — computed as ONE
    stacked matmul.

    The reference recomputes the memory embeddings for every hop
    sequentially (dense_mat_fwd per hop per A/C, MemN2N/MemN2N.c:1372-1532);
    under per-hop mixed precision (EN_MQ) the results genuinely differ, so
    no CSE applies.  Here: quantize each weight matrix in its own format,
    CONCATENATE them ([sum_k D_k, I]) and run a single
    [.., M, I] x [I, sum_k D_k] matmul, then re-quantize each D_k block in
    its format.  Bit-identical to K separate qembed_mat calls (same
    fast-path exactness conditions, applied jointly), but one wide matmul
    instead of K small ones.

    Returns a tuple of [..., M, D_k] arrays, one per (weight, fmt) pair.
    Gradients are the same raw-float VJPs as qembed_mat, per weight; a
    weight array appearing in multiple slots (shared A across hops under
    tying type 2) gets its cotangents summed by JAX as usual.
    """
    return _qembed_mat_multi_impl(s, weights, fmts, quantized, integer_inputs)


def _qembed_mat_multi_impl(s, weights, fmts, quantized, integer_inputs):
    assert len(weights) == len(fmts)
    single = [
        lambda w=w, fmt=fmt: _qembed_mat_impl(s, w, fmt, quantized,
                                              integer_inputs)
        for w, fmt in zip(weights, fmts)]
    if (not quantized or not integer_inputs
            or any(f.is_binary for f in fmts)):
        return tuple(f() for f in single)

    wqs = [float_quant(w, fmt) for w, fmt in zip(weights, fmts)]
    ok = _integer_input_fast_path_ok(s, weights[0], fmts[0])
    for w, fmt in zip(weights[1:], fmts[1:]):
        ok = ok & _integer_input_fast_path_ok(s, w, fmt)

    def fast(_):
        stacked = jnp.concatenate([jnp.swapaxes(wq, 0, 1) for wq in wqs],
                                  axis=1)                    # [I, sum D_k]
        out = _exact_matmul(s, stacked, all(_exact_bf16(f) for f in fmts))
        # one fused per-block requant over the whole stacked output (the
        # per-hop formats differ only under EN_MQ); the downstream slices
        # then fuse into their consumers instead of materializing 2K
        # slice+requant fusions
        widths = tuple(wq.shape[0] for wq in wqs)
        outq = float_quant_blocks(out, fmts, widths)
        outs, off = [], 0
        for d in widths:
            outs.append(outq[..., off:off + d])
            off += d
        return tuple(outs)

    def slow(_):
        return tuple(f() for f in single)

    return jax.lax.cond(ok, fast, slow, None)


def _qembed_mat_multi_fwd(s, weights, fmts, quantized, integer_inputs):
    out = _qembed_mat_multi_impl(s, weights, fmts, quantized, integer_inputs)
    return out, (s, weights)


def _qembed_mat_multi_bwd(fmts, quantized, integer_inputs, res, gs):
    s, weights = res
    # raw-float per-entry VJPs (dense_mat_bwd semantics), input grads summed
    dws = tuple(
        jnp.einsum("...md,...mi->di", g, s,
                   preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST) for g in gs)
    ds = sum(jnp.einsum("...md,di->...mi", g, w,
                        preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)
             for g, w in zip(gs, weights))
    return ds, dws


qembed_mat_multi.defvjp(_qembed_mat_multi_fwd, _qembed_mat_multi_bwd)


# ---------------------------------------------------------------------------
# qscore: scores = M @ u  (attention modes 1/2; lib/layer_cuda.cu:2406-2443)
# ---------------------------------------------------------------------------

@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3, 4, 5, 6))
def qscore(m: jax.Array, u: jax.Array, fmt_m: QFormat, fmt_u: QFormat,
           quantized: bool = True, score_mod: str = "none",
           grad_quantized: bool = False) -> jax.Array:
    """Attention score: m [..., M, D] x u [..., D] -> [..., M].

    Mode 2 (quantized dot, MemN2N/define.h:15 default): per-product requant
    to fmt_m, output requant to fmt_m (cuda_dot_mat_vec_fwd ->
    _cuda_mat_mat_trans_product with iwl_out=iwl_m, lib/layer_cuda.cu:2438).
    Mode 1 (float): quantized=False.

    score_mod (opt-in saturation-collapse mitigations, NOT in the
    reference; quantized path only — see BENCH.md's collapse study):
      "none"  reference-faithful output requant (default)
      "shift" subtract the row max of the RAW product sums before the
              output requant.  Softmax is shift-invariant, so this
              preserves the score distribution's shape instead of pinning
              every large row at the Q-format bound (the diagnosed
              collapse mechanism); rows far below the max saturate at the
              NEGATIVE bound, which softmax treats as negligible — the
              correct semantics.  The max is taken over ALL rows (padded
              rows sum to 0), matching the sharded variant.
      "clip"  clip the raw sums at +/-(maxf - 2^-frac) before the requant
              (straight-through gradient, like every quantizer here).

    The backward is the reference's raw-float surrogate either way
    (shift adds a constant per row — softmax-gradient-invariant; clip is
    STE), so training differs only through the forward scores.

    Padded memory rows are handled by the caller (mask applied before the
    softmax); the op itself computes every row like the reference computes
    every live row.

    grad_quantized=True selects the EN_GRAD_QUANT per-backward placement
    (f_fixed threading, lib/layer.c:551-555): both backward contractions
    quantize per-product at (fmt_m, fmt_m) and re-quantize their outputs
    at (1, iwl+frac-1) — cuda_dot_mat_vec_bwd's f_fixed=true non-trans
    branch (lib/layer_cuda.cu:2603-2609).
    """
    return _qscore_impl(m, u, fmt_m, fmt_u, quantized, score_mod)


def _apply_score_mod(raw: jax.Array, fmt: QFormat, score_mod: str):
    """Pre-requant adjustment of raw score sums (see qscore.score_mod)."""
    if score_mod == "shift":
        return raw - jnp.max(raw, axis=-1, keepdims=True)
    if score_mod == "clip":
        bound = fixed_max_float(fmt.iwl, fmt.frac) - 2.0 ** (-fmt.frac)
        return jnp.clip(raw, -bound, bound)
    return raw


def _qscore_impl(m, u, fmt_m, fmt_u, quantized, score_mod="none"):
    if not quantized:
        return jnp.einsum("...md,...d->...m", m, u,
                          preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)
    prod = _qproducts(m, u[..., None, :], fmt_m, fmt_u, fmt_m)
    raw = jnp.sum(prod, axis=-1)
    return float_quant(_apply_score_mod(raw, fmt_m, score_mod), fmt_m)


def _qscore_fwd(m, u, fmt_m, fmt_u, quantized, score_mod, grad_quantized):
    return _qscore_impl(m, u, fmt_m, fmt_u, quantized, score_mod), (m, u)


def _qscore_bwd(fmt_m, fmt_u, quantized, score_mod, grad_quantized, res, g):
    m, u = res
    # NB the gate is grad_quantized ALONE: the reference's bwd f_fixed is
    # the layer's constructor flag (EN_FIXED_POINT), independent of the
    # forward dispatch's hardcoded f_fixed (mode 1 runs a FLOAT forward
    # but its EN_GRAD_QUANT backward still quantizes when the layer is
    # fixed — lib/layer.c:539-562 vs :177-196)
    if grad_quantized:
        # EN_GRAD_QUANT backward (cuda_dot_mat_vec_bwd f_fixed=true,
        # lib/layer_cuda.cu:2603-2609): per-product requant at
        # (fmt_m, fmt_m) — CUDA_FIXED_MUL requants to the FIRST operand's
        # format, and both operands are passed (iwl_m, frac_m) — output
        # requant at (1, iwl+frac-1)
        fo = _grad_out_fmt(fmt_m)
        # grad_M[r, d] = Q(FIXED_MUL(g_r, u_d))   (blockDim 1: one product)
        dm = float_quant(
            _qproducts(g[..., :, None], u[..., None, :], fmt_m, fmt_m,
                       fmt_m), fo)
        # grad_u[d] = Q(sum_r FIXED_MUL(g_r, M_rd))
        du = float_quant(
            jnp.sum(_qproducts(g[..., :, None], m, fmt_m, fmt_m, fmt_m),
                    axis=-2), fo)
        return dm, du
    # float grads on raw tensors (cuda_dot_mat_vec_bwd non-trans branch,
    # lib/layer_cuda.cu:2597-2609): grad_M = g (x) u ; grad_u = M^T g
    dm = g[..., :, None] * u[..., None, :]
    du = jnp.einsum("...md,...m->...d", m, g, preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)
    return dm, du


qscore.defvjp(_qscore_fwd, _qscore_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3, 4))
def qscore_partial_sum(m: jax.Array, u: jax.Array, fmt_m: QFormat,
                       fmt_u: QFormat, quantized: bool = True) -> jax.Array:
    """qscore WITHOUT the final output re-quantization — the local
    building block for memory-bank-sharded score_mod="shift": each device
    sums its shard's quantized products (exact on the 2^-frac grid), the
    global row max is taken with pmax, and the single shift + output
    quantization is applied globally (parallel/distributed.py).  Same
    raw-float backward as qscore."""
    if not quantized:
        return jnp.einsum("...md,...d->...m", m, u,
                          preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST)
    prod = _qproducts(m, u[..., None, :], fmt_m, fmt_u, fmt_m)
    return jnp.sum(prod, axis=-1)


def _qps_fwd(m, u, fmt_m, fmt_u, quantized):
    return qscore_partial_sum(m, u, fmt_m, fmt_u, quantized), (m, u)


def _qps_bwd(fmt_m, fmt_u, quantized, res, g):
    return _qscore_bwd(fmt_m, fmt_u, quantized, "none", False, res, g)


qscore_partial_sum.defvjp(_qps_fwd, _qps_bwd)


# ---------------------------------------------------------------------------
# qweighted_sum: o = C^T p  (memory read; lib/layer_cuda.cu:2430, :547-635)
# ---------------------------------------------------------------------------

@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4, 5))
def qweighted_sum(c: jax.Array, p: jax.Array, row_mask: jax.Array,
                  fmt: QFormat, quantized: bool = True,
                  grad_quantized: bool = False) -> jax.Array:
    """Weighted memory sum: c [..., M, D] x p [..., M] -> [..., D].

    The reference's f_trans dot_mat_vec: a single Q-format for both
    operands, per-product and output (cuda_dot_mat_vec_fwd f_trans branch,
    lib/layer_cuda.cu:2430; kernel :547-635 — note mat_a is the
    probability vector, so products requant to its format, which equals
    the layer format).

    row_mask [..., M] float32 (1 live / 0 padded) excludes padded memory
    rows *after* per-product quantization — required because the binary
    format quantizes 0 to +1, so padded rows would otherwise contribute
    (the reference never materializes padded rows).  Pass all-ones when
    the memory axis is unpadded.

    grad_quantized=True selects the EN_GRAD_QUANT per-backward placement
    (cuda_dot_mat_vec_bwd f_fixed=true f_trans branch,
    lib/layer_cuda.cu:2590-2596): quantized backward contractions with
    outputs at (1, iwl+frac-1); the padded-row mask is applied after, as
    in the forward (padded rows do not exist in the reference).
    """
    return _qweighted_sum_impl(c, p, row_mask, fmt, quantized)


def _qweighted_sum_impl(c, p, row_mask, fmt, quantized):
    if not quantized:
        return jnp.einsum("...md,...m->...d", c, p * row_mask,
                          preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)
    prod = _qproducts(p[..., :, None], c, fmt, fmt, fmt)
    prod = prod * row_mask[..., :, None]
    return float_quant(jnp.sum(prod, axis=-2), fmt)


def _qweighted_sum_fwd(c, p, row_mask, fmt, quantized, grad_quantized):
    return _qweighted_sum_impl(c, p, row_mask, fmt, quantized), (c, p, row_mask)


def _qweighted_sum_bwd(fmt, quantized, grad_quantized, res, g):
    c, p, row_mask = res
    # gate on grad_quantized alone — see _qscore_bwd's note; additionally
    # the MODE-3 weighted sum quantizes its backward whenever the layer
    # is fixed, independent of EN_GRAD_QUANT (cuda_dot_mat_vec_bwd_appx
    # receives dot->f_fixed unconditionally, lib/layer.c:588-599, and its
    # f_trans branch runs the quantized contractions,
    # lib/layer_cuda.cu:2691-2704) — the model passes grad_quantized
    # accordingly (models/memn2n.py)
    if grad_quantized:
        # EN_GRAD_QUANT backward (f_trans branch, f_fixed=true,
        # lib/layer_cuda.cu:2590-2596): grad_C[r,d] = Q(FIXED_MUL(p_r,g_d))
        # at (1, iwl+frac-1); grad_p[r] = Q(sum_d FIXED_MUL(C_rd, g_d))
        fo = _grad_out_fmt(fmt)
        dc = float_quant(
            _qproducts(p[..., :, None], g[..., None, :], fmt, fmt, fmt),
            fo) * row_mask[..., :, None]
        dp = float_quant(
            jnp.sum(_qproducts(c, g[..., None, :], fmt, fmt, fmt), axis=-1),
            fo) * row_mask
        return dc, dp, jnp.zeros_like(row_mask)
    # float grads on raw tensors (cuda_dot_mat_vec_bwd f_trans branch,
    # lib/layer_cuda.cu:2584-2596): grad_C = p (x) g ; grad_p = C g
    dc = (p * row_mask)[..., :, None] * g[..., None, :]
    dp = jnp.einsum("...md,...d->...m", c, g,
                    preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST) * row_mask
    return dc, dp, jnp.zeros_like(row_mask)


qweighted_sum.defvjp(_qweighted_sum_fwd, _qweighted_sum_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4, 5))
def qweighted_partial_sum(c: jax.Array, p: jax.Array, row_mask: jax.Array,
                          fmt: QFormat, quantized: bool = True,
                          grad_quantized: bool = False) -> jax.Array:
    """qweighted_sum WITHOUT the final output re-quantization — the local
    building block for memory-bank-sharded execution: each device sums its
    shard's quantized products (exact on the 2^-frac grid), the shards are
    psum'd across devices, and the single output quantization is applied
    globally (parallel/distributed.py).  Same backward family as
    qweighted_sum; the quantized backward (mode-3 f_fixed rule) is fully
    shard-local — dc is elementwise per memory row and dp reduces over
    the unsharded D axis — so it composes with the psum unchanged."""
    if not quantized:
        return jnp.einsum("...md,...m->...d", c, p * row_mask,
                          preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)
    prod = _qproducts(p[..., :, None], c, fmt, fmt, fmt)
    prod = prod * row_mask[..., :, None]
    return jnp.sum(prod, axis=-2)


def _qwps_fwd(c, p, row_mask, fmt, quantized, grad_quantized):
    return (qweighted_partial_sum(c, p, row_mask, fmt, quantized,
                                  grad_quantized), (c, p, row_mask))


def _qwps_bwd(fmt, quantized, grad_quantized, res, g):
    return _qweighted_sum_bwd(fmt, quantized, grad_quantized, res, g)


qweighted_partial_sum.defvjp(_qwps_fwd, _qwps_bwd)


# ---------------------------------------------------------------------------
# Reference (pure-jnp, no custom grad) implementations for verification —
# the analog of the reference's CPU<->GPU cross-check (HW_MODE 21).
# ---------------------------------------------------------------------------

def qmatvec_reference(w, x, fmt_w, fmt_x):
    prod = _qproducts(w, x[..., None, :], fmt_w, fmt_x, fmt_w)
    return float_quant(jnp.sum(prod, axis=-1), fmt_w)
