"""Softmax variants with masking for the padded memory axis.

The reference softmax layer (lib/layer.h:93-126) has three forward
variants; the live GPU path (_cuda_softmax_fwd, lib/layer_cuda.cu:1969-2060)
is max-subtracted exp with sum normalization.  Variants:

  * exp (default):      out = exp(x - max) / sum            (:2006, :2042)
  * shift-based:        out = exp(x - max) / llrint(log2(sum))   (:1983,:2038)
    backward scales the standard softmax gradient by 0.7 (:2127)
  * exp_plan (CPU-only capability): piecewise-linear approx of exp
    (lib/common.c:50-73), kept for parity with the f_exp_plan flag
  * exp2 (CPU-only): pow(2, x-max)/sum (lib/layer.c:1275)

Masking: the reference evaluates the softmax over exactly n_sen live rows
per sample.  This version pads the memory axis to a static length and
masks before max/exp so padded rows contribute exactly zero probability —
a documented behavioral-equivalence deviation (SURVEY.md section 7,
hard part 4).
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

# np scalar, not jnp: a module-level jnp call would initialize
# the XLA backend at import time (breaking multi-host bring-up,
# which must run jax.distributed.initialize first)
_NEG_LARGE = np.float32(-1e30)


def _masked_exp_parts(x, mask):
    if mask is not None:
        x = jnp.where(mask, x, _NEG_LARGE)
    m = jnp.max(x, axis=-1, keepdims=True)
    e = jnp.exp(x - m)
    if mask is not None:
        e = jnp.where(mask, e, 0.0)
    total = jnp.sum(e, axis=-1, keepdims=True)
    if mask is not None:
        # fully-masked rows (all-padding samples in the final partial
        # batch) would divide 0/0; give them probability 0 everywhere
        total = jnp.where(total == 0.0, 1.0, total)
    return e, total


def softmax(x: jax.Array, mask: Optional[jax.Array] = None) -> jax.Array:
    """Standard masked softmax (exp variant).  Autodiff yields exactly the
    reference backward p*(g - sum(p*g)) (_cuda_softmax_bwd,
    lib/layer_cuda.cu:2130-2147)."""
    e, total = _masked_exp_parts(x, mask)
    return e / total


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def shift_softmax(x: jax.Array, mask: Optional[jax.Array], _dummy: int = 0):
    """Shift-based softmax: exp(x-max) normalized by the nearest-integer
    log2 of the total (lib/layer_cuda.cu:2038), with the reference's
    0.7-scaled backward (:2127)."""
    return _shift_softmax_impl(x, mask)


def _shift_softmax_impl(x, mask):
    e, total = _masked_exp_parts(x, mask)
    divisor = jnp.round(jnp.log2(total))  # llrintf = round half-to-even
    # log2(total<=1) rounds to 0 (and fully-masked rows have total==1 after
    # the guard): avoid the 0-divisor the same way a zero llrint result
    # would break the reference — keep those rows finite
    divisor = jnp.where(divisor == 0.0, 1.0, divisor)
    return e / divisor


def _shift_softmax_fwd(x, mask, _dummy):
    out = _shift_softmax_impl(x, mask)
    return out, out


def _shift_softmax_bwd(_dummy, out, g):
    s = jnp.sum(out * g, axis=-1, keepdims=True)
    return (jnp.float32(0.7) * out * (g - s), None)


shift_softmax.defvjp(_shift_softmax_fwd, _shift_softmax_bwd)


# Piecewise-linear exp approximation coefficients (lib/common.h:270-286).
_EXP_PLAN_W = (0.597226, 0.141642, 0.070265, 0.0)
_EXP_PLAN_B = (0.933989, 0.43981, 0.10888, 0.0)


def exp_plan(x: jax.Array) -> jax.Array:
    """Piecewise Linear Approximation of exp (lib/common.c:50-73):
    max over the linear segments w_i * x + b_i."""
    out = jnp.float32(_EXP_PLAN_W[0]) * x + jnp.float32(_EXP_PLAN_B[0])
    for w, b in zip(_EXP_PLAN_W[1:], _EXP_PLAN_B[1:]):
        out = jnp.maximum(out, jnp.float32(w) * x + jnp.float32(b))
    return out


def exp_plan_softmax(x: jax.Array, mask: Optional[jax.Array] = None) -> jax.Array:
    """Softmax with the PLA exp (f_exp_plan capability, lib/layer.c:1246)."""
    if mask is not None:
        x = jnp.where(mask, x, _NEG_LARGE)
    m = jnp.max(x, axis=-1, keepdims=True)
    e = exp_plan(x - m)
    if mask is not None:
        e = jnp.where(mask, e, 0.0)
    return e / jnp.sum(e, axis=-1, keepdims=True)


def exp2_softmax(x: jax.Array, mask: Optional[jax.Array] = None) -> jax.Array:
    """CPU-path exp2 variant: pow(2, x-max)/sum (lib/layer.c:1275)."""
    if mask is not None:
        x = jnp.where(mask, x, _NEG_LARGE)
    m = jnp.max(x, axis=-1, keepdims=True)
    e = jnp.exp2(x - m)
    if mask is not None:
        e = jnp.where(mask, e, 0.0)
    return e / jnp.sum(e, axis=-1, keepdims=True)


def apply_softmax(x: jax.Array, mask: Optional[jax.Array] = None,
                  shift_based: bool = False, use_exp_plan: bool = False,
                  remove: bool = False) -> jax.Array:
    """Softmax dispatch.  remove=True is the linear-start mode where the
    attention softmax is bypassed entirely (MemN2N/MemN2N.c:1080-1099);
    padded rows are still zeroed."""
    if remove:
        return jnp.where(mask, x, 0.0) if mask is not None else x
    if use_exp_plan:
        return exp_plan_softmax(x, mask)
    if shift_based:
        return shift_softmax(x, mask, 0)
    return softmax(x, mask)
