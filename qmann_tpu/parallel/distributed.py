"""Explicit-collective memory-bank sharding (shard_map + psum).

The GSPMD path (parallel/sharding.py) lets XLA derive the collectives
from annotations.  This module is the hand-written equivalent for the
attention read — blockwise attention over memory shards with psum'd
softmax statistics, the long-context/sequence-parallel analog the north
star asks for (SURVEY.md sections 2.6, 5):

  each device holds a shard of the memory sentences [B, M/s, ...];
  1. local attention scores against the query;
  2. global max via pmax, global exp-sum via psum (the two softmax
     statistics — one scalar pair per row crosses devices);
  3. local quantized weighted-sum partials, psum'd and re-quantized.

The final re-quantization AFTER the psum preserves the reference's exact
semantics: quantized products live on the 2^-frac grid so their
distributed sum is exact regardless of reduction order, and the single
output quantization (lib/layer_cuda.cu:573) is applied once globally.

Collective correctness is tracked by shard_map's vma system
(check_vma=True): replicated values (psum/pmax outputs) are explicitly
re-cast to varying (jax.lax.pcast) before meeting per-shard tensors, so
reverse-mode transposes are exact — pcast's transpose is the psum that
accumulates each shard's partial cotangent.  (With check_vma=False the
transpose of psum degenerates to psum-of-replicated-cotangents, which
silently multiplies gradients by the mesh-axis size — caught by the
gradient-parity test in tests/test_parallel.py.)
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from qmann_tpu.config import QmannConfig
from qmann_tpu.numerics import fixed_max_float, quantize_ste
from qmann_tpu.ops.attention import attention_score
from qmann_tpu.ops.qlinear import qscore_partial_sum, qweighted_partial_sum
from qmann_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS

# np scalar, not jnp: a module-level jnp call would initialize
# the XLA backend at import time (breaking multi-host bring-up,
# which must run jax.distributed.initialize first)
_NEG_LARGE = np.float32(-1e30)


def _vary(x, axis):
    """Re-enter per-shard (varying) land from a replicated collective
    result; transposes to a psum of the per-shard cotangents."""
    return jax.lax.pcast(x, axis, to="varying")


def _attention_read_local(m_l, c_l, u, mask_l, cfg: QmannConfig, hop: int,
                          axis: str):
    """Per-shard attention read; runs inside shard_map.  All inputs must
    be varying over `axis`; returns (o replicated over `axis`, p_l
    varying).

    Differentiation convention: a caller that consumes o in further
    per-shard computation (each shard then holding a replicated COPY of
    the same logical loss) must differentiate the per-shard loss divided
    by the `axis` size — see explicit.make_explicit_train_step.  The
    pcast/psum transposes then accumulate each copy's full cotangent and
    the division restores the mean, which equals the single-copy
    gradient exactly."""
    fmt_att = cfg.fmt_att[hop]
    fmt_act = cfg.fmt_act[hop]
    score_mod = cfg.att_score_mod
    if score_mod != "none" and cfg.attention_mode == 2:
        # the shift needs the GLOBAL row max of the raw product sums: sum
        # each shard's quantized products without the output requant (exact
        # on the 2^-frac grid), pmax the raw row maxima over the memory
        # shards, then apply the single shift/clip + output quantization
        # per shard — bit-identical to the single-device qscore(score_mod).
        # Mode-2 dot forwards are quantized REGARDLESS of EN_FIXED_POINT
        # (f_fixed hardcoded true in the fwd dispatch, lib/layer.c:205),
        # matching the dense path's qscore(quantized=True).
        raw_l = qscore_partial_sum(m_l, u, fmt_att, cfg.fmt_bin, True)
        if score_mod == "shift":
            gmax = jax.lax.pmax(
                jax.lax.stop_gradient(jnp.max(raw_l, axis=-1)), axis)
            raw_l = raw_l - _vary(gmax, axis)[..., None]
        else:  # clip: a per-element op, no cross-shard statistic needed
            bound = fixed_max_float(fmt_att.iwl, fmt_att.frac) \
                - 2.0 ** (-fmt_att.frac)
            raw_l = jnp.clip(raw_l, -bound, bound)
        scores_l = quantize_ste(raw_l, fmt_att)
    else:
        scores_l = attention_score(m_l, u, cfg.attention_mode, fmt_att,
                                   cfg.fmt_bin,
                                   num_bit=cfg.num_bits_attention,
                                   const_scale=cfg.attention_const_scale,
                                   hamming_weight_para=cfg.hamming_weight_para,
                                   hamming_weighted=cfg.hamming_weighted,
                                   grad_quantized=cfg.grad_quant_backward)
    scores_l = jnp.where(mask_l, scores_l, _NEG_LARGE)

    # distributed softmax statistics: one max + one sum per row.
    # stop_gradient goes on pmax's INPUT: the max subtraction cancels in
    # the softmax gradient (and pmax has no differentiation rule).
    local_max = jax.lax.stop_gradient(jnp.max(scores_l, axis=-1))
    gmax = jax.lax.pmax(local_max, axis)
    e = jnp.exp(scores_l - _vary(gmax, axis)[..., None])
    e = jnp.where(mask_l, e, 0.0)
    total = jax.lax.psum(jnp.sum(e, axis=-1), axis)
    total = jnp.where(total == 0.0, 1.0, total)
    p_l = e / _vary(total, axis)[..., None]

    # weighted sum: local partials on the exact 2^-frac grid, psum,
    # single global output re-quantization.  The per-mode quantization
    # rules are QmannConfig's dot-family dispatch properties (one home,
    # shared with models/memn2n._hop_stack); the quantized backward is
    # fully shard-local (see qweighted_partial_sum).
    wsum_q = cfg.wsum_quantized
    partial = qweighted_partial_sum(c_l, p_l,
                                    mask_l.astype(jnp.float32), fmt_act,
                                    wsum_q, cfg.wsum_grad_quantized)
    o = jax.lax.psum(partial, axis)
    if wsum_q:
        o = quantize_ste(o, fmt_act)
    return o, p_l


def memory_sharded_attention_read(mesh: Mesh, m, c, u, mask,
                                  cfg: QmannConfig, hop: int = 0):
    """Attention read with the memory axis sharded over the 'model' mesh
    axis and the batch over 'data'.  m, c: [B, M, D]; u: [B, D];
    mask: [B, M] -> (o [B, D], p [B, M])."""

    def fn(m_l, c_l, u_l, mask_l):
        return _attention_read_local(m_l, c_l, _vary(u_l, MODEL_AXIS),
                                     mask_l, cfg, hop, MODEL_AXIS)

    mapped = shard_map(
        fn, mesh=mesh,
        in_specs=(P(DATA_AXIS, MODEL_AXIS, None),
                  P(DATA_AXIS, MODEL_AXIS, None),
                  P(DATA_AXIS, None),
                  P(DATA_AXIS, MODEL_AXIS)),
        out_specs=(P(DATA_AXIS, None), P(DATA_AXIS, MODEL_AXIS)),
        check_vma=True)
    return mapped(m, c, u, mask)
