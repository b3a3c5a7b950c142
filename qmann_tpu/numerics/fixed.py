"""Q-format fixed-point quantization system (pure JAX).

This module is the JAX re-design of the reference's fixed-point macro
families:

  * host macros   — lib/common.h:24-234
  * device macros — lib/layer_cuda.h:36-259

The reference represents a fixed-point number as a 32-bit **sign-magnitude**
word: magnitude = conv(|x| * 2^frac) in the low 31 bits, sign in bit 31
(``FLOAT2FIXED``, lib/common.h:210; ``CUDA_FLOAT2FIXED``, lib/layer_cuda.h:246).
Sign-magnitude (not two's complement) is load-bearing: the Hamming-similarity
attention compares raw bit patterns and treats bit 31 as the sign
(lib/layer_cuda.cu:218-326).

All quantization in the live GPU path is *fake quantization* on float storage:
``CUDA_FLOAT_QUANT(x,iwl,frac,mode)`` round-trips float -> fixed -> float
(lib/layer_cuda.h:253). We reproduce that in float32 arithmetic, bit-exactly
for every representable case (see tests/test_numerics.py which checks against
an independent integer oracle).

Semantics reproduced exactly:
  * saturation bounds max = (2^(iwl+frac)-1) / 2^frac computed in float32
    (CUDA_FIXED_MAX_FLOAT, lib/layer_cuda.h:207-211); min = -max (symmetric,
    a consequence of sign-magnitude).
  * conversion: truncation toward zero by default — the reference compiles
    with EN_QUANT_MODE undefined (MemN2N/define.h:35), so the device uses a
    plain C cast ``(int)(x*(1<<frac))`` (lib/layer_cuda.h:233).  The four
    EN_QUANT_MODE rounding modes (define.h:37-43) are also provided.
  * binarization: iwl+frac == 0 quantizes to sign(x) in {+1,-1} with
    0 -> +1 (lib/layer_cuda.h:253).
  * int-cast overflow at the +/-2^31 boundary saturates (CUDA cvt.rzi.s32
    behavior), relevant only for the full-width frac = 31-iwl encodings used
    by the Hamming attention (lib/layer_cuda.cu:2515).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# Rounding modes, mirroring MemN2N/define.h:37-43.
ROUND_DOWN = 0          # floor            (__float2int_rd)
ROUND_UP = 1            # ceil             (__float2int_ru)
ROUND_NEAREST_EVEN = 2  # round-half-even  (__float2int_rn)
ROUND_TOWARD_ZERO = 3   # truncate         (__float2int_rz / C cast; DEFAULT)

# f32 value of INT32_MAX after float rounding — the CUDA saturating
# float->int conversion clamps here (cvt.rzi.s32.f32 semantics).
_INT32_SAT_F32 = np.float32(2147483648.0)


class QFormat(NamedTuple):
    """A Q(iwl).(frac) fixed-point format: 1 sign bit + iwl integer bits +
    frac fractional bits.  ``mode`` selects the rounding mode (static)."""
    iwl: int
    frac: int
    mode: int = ROUND_TOWARD_ZERO

    @property
    def word_length(self) -> int:
        return 1 + self.iwl + self.frac

    @property
    def is_binary(self) -> bool:
        # iwl+frac==0 means +/-1 binarization (lib/layer_cuda.h:253).
        return (self.iwl + self.frac) == 0

    def with_full_frac(self) -> "QFormat":
        """The full-width variant used by the Hamming attention encode:
        frac = 32-1-iwl (lib/layer_cuda.cu:2515, 2706-2709)."""
        return QFormat(self.iwl, 31 - self.iwl, self.mode)


# Commonly used formats.
def qformat_from_wl(iwl: int, wl: int = 8, mode: int = ROUND_TOWARD_ZERO) -> QFormat:
    """BW_WL-style format: frac = wl - 1 - iwl (MemN2N/MemN2N.c:273-274)."""
    return QFormat(iwl, wl - 1 - iwl, mode)


FLOAT_PSEUDO = QFormat(8, 7)  # 'float' layers nominal format (MemN2N.c:766-767)


@functools.lru_cache(maxsize=None)
def fixed_max_float(iwl: int, frac: int) -> np.float32:
    """Saturation upper bound, computed with C float rounding:
    (float)((1<<(iwl+frac))-1) / (float)(1<<frac)   (lib/layer_cuda.h:207-211).

    Note for iwl+frac == 31 the numerator 2^31-1 rounds UP to 2^31 in f32,
    so the bound is exactly 2^iwl — matching the CUDA constant.
    """
    assert 0 <= iwl and 0 <= frac and iwl + frac <= 31
    num = np.float32((1 << (iwl + frac)) - 1)
    den = np.float32(1 << frac)
    return np.float32(num / den)


def fixed_min_float(iwl: int, frac: int) -> np.float32:
    """Symmetric lower bound -max (sign-magnitude)."""
    return np.float32(-fixed_max_float(iwl, frac))


def _convert(scaled: jax.Array, mode: int) -> jax.Array:
    """float -> integer-valued float, per rounding mode.  Default C-cast
    truncation toward zero (EN_QUANT_MODE undefined, define.h:35,44-47)."""
    if mode == ROUND_DOWN:
        return jnp.floor(scaled)
    if mode == ROUND_UP:
        return jnp.ceil(scaled)
    if mode == ROUND_NEAREST_EVEN:
        return jnp.round(scaled)  # jnp.round is round-half-even
    return jnp.trunc(scaled)


def float_quant(x: jax.Array, fmt: QFormat) -> jax.Array:
    """Fake quantization CUDA_FLOAT_QUANT (lib/layer_cuda.h:253):
    round-trip float -> sign-magnitude fixed -> float, with saturation.

    Bit-exact to the reference for float32 inputs (validated against an
    integer oracle in tests).  For iwl+frac==0, binarizes to +/-1 with
    0 -> +1.
    """
    x = jnp.asarray(x, jnp.float32)
    if fmt.is_binary:
        return jnp.where(x >= 0.0, np.float32(1.0), np.float32(-1.0))
    maxf = fixed_max_float(fmt.iwl, fmt.frac)
    minf = fixed_min_float(fmt.iwl, fmt.frac)
    # scale by an exact power of two; multiply is exact in f32
    scale = np.float32(2.0) ** np.int32(fmt.frac)
    inv_scale = np.float32(2.0) ** np.int32(-fmt.frac)
    scaled = x * scale
    q = _convert(scaled, fmt.mode)
    # saturating float->int32 conversion (CUDA cvt.rzi.s32.f32)
    q = jnp.clip(q, -_INT32_SAT_F32, _INT32_SAT_F32)
    deq = q * inv_scale
    if fmt.iwl + fmt.frac == 31:
        # Reference edge case at full-width formats: x == -2^iwl converts to
        # INT_MIN, whose two's-complement magnitude (~v+1, lib/layer_cuda.h:246)
        # wraps to 0 -> the value quantizes to -0.0.  (Positive 2^iwl instead
        # saturates to 2^31-1 via cvt.rzi.s32.f32 and decodes back to 2^iwl.)
        deq = jnp.where(scaled <= -_INT32_SAT_F32, np.float32(0.0), deq)
    # saturation checks happen on the *pre-conversion* float value
    # (lib/layer_cuda.h:230-233): (x > max) -> max_fixed, (x < min) -> min_fixed
    return jnp.where(x > maxf, maxf, jnp.where(x < minf, minf, deq))


def float_quant_blocks(x: jax.Array, fmts, widths) -> jax.Array:
    """float_quant with a per-column-block QFormat on the last axis.

    x: [..., sum(widths)]; columns of block k are quantized in fmts[k].
    Bit-identical to concatenating per-block float_quant calls, but ONE
    fused elementwise pass over the whole array instead of len(fmts)
    slice+requant fusions — the XLA-side analog of the chain kernel's
    in-register per-hop requant.  Used by qembed_mat_multi's stacked-
    matmul fast path, where the reference instead runs 2K sequential
    dense_mat_fwd kernels (MemN2N/MemN2N.c:1372-1532).
    """
    assert len(fmts) == len(widths) and x.shape[-1] == sum(widths)
    if len(set(fmts)) == 1:
        return float_quant(x, fmts[0])
    if (len({f.mode for f in fmts}) > 1
            or any(f.is_binary for f in fmts)):
        # mixed rounding modes / binary blocks: vectorizing buys nothing
        # clean here — keep the per-block reference path
        outs, off = [], 0
        for fmt, w in zip(fmts, widths):
            outs.append(float_quant(x[..., off:off + w], fmt))
            off += w
        return jnp.concatenate(outs, axis=-1)
    x = jnp.asarray(x, jnp.float32)

    def cols(vals):
        return np.repeat(np.asarray(vals, np.float32), widths)

    maxf = cols([fixed_max_float(f.iwl, f.frac) for f in fmts])
    scale = cols([np.float32(2.0) ** np.int32(f.frac) for f in fmts])
    inv_scale = cols([np.float32(2.0) ** np.int32(-f.frac) for f in fmts])
    scaled = x * scale
    q = _convert(scaled, fmts[0].mode)
    q = jnp.clip(q, -_INT32_SAT_F32, _INT32_SAT_F32)
    deq = q * inv_scale
    full31 = np.array([(f.iwl + f.frac) == 31 for f in fmts])
    if full31.any():
        # the INT_MIN magnitude-wrap edge (see float_quant), per column
        wrap = np.repeat(full31, widths)
        deq = jnp.where(wrap & (scaled <= -_INT32_SAT_F32),
                        np.float32(0.0), deq)
    return jnp.where(x > maxf, maxf, jnp.where(x < -maxf, -maxf, deq))


def fixed_mul(a: jax.Array, b: jax.Array, fmt_a: QFormat, fmt_b: QFormat) -> jax.Array:
    """CUDA_FIXED_MUL (lib/layer_cuda.h:258): quantize each operand in its own
    format, multiply in float, re-quantize the product to *fmt_a* (the format
    of the first operand)."""
    return float_quant(float_quant(a, fmt_a) * float_quant(b, fmt_b), fmt_a)


def fixed_add(a: jax.Array, b: jax.Array, fmt_a: QFormat, fmt_b: QFormat) -> jax.Array:
    """CUDA_FIXED_ADD (lib/layer_cuda.h:257)."""
    return float_quant(float_quant(a, fmt_a) + float_quant(b, fmt_b), fmt_a)


def fixed_mac(acc: jax.Array, a: jax.Array, b: jax.Array,
              fmt_a: QFormat, fmt_b: QFormat) -> jax.Array:
    """CUDA_FIXED_MAC (lib/layer_cuda.h:259): float accumulate of the
    per-product-quantized multiply."""
    return acc + fixed_mul(a, b, fmt_a, fmt_b)


# ---------------------------------------------------------------------------
# Sign-magnitude bit-level encoding (for the Hamming attention).
# ---------------------------------------------------------------------------

def encode_sign_magnitude(x: jax.Array, fmt: QFormat) -> tuple[jax.Array, jax.Array]:
    """float32 -> (sign, magnitude) of the 32-bit sign-magnitude fixed word.

    sign: int32 in {0,1}; 1 iff x < 0 — the reference's positive branch is
    taken for x >= 0 including -0.0 (lib/layer_cuda.h:246).
    magnitude: int32, low 31 bits of the word, saturated at 2^31-1.

    Exact for any float32 input even at frac = 31-iwl (full-width Hamming
    encode): the magnitude is reconstructed from a hi/lo split so that every
    intermediate is exactly representable in f32.
    """
    x = jnp.asarray(x, jnp.float32)
    iwl, frac = fmt.iwl, fmt.frac
    assert iwl + frac <= 31
    sign = (x < 0.0).astype(jnp.int32)
    maxf = fixed_max_float(iwl, frac)
    absx = jnp.abs(x)
    # saturation: |x| > max  -> 2^(iwl+frac)-1 ... but also the int-cast at
    # exactly |x| == max with iwl+frac==31 saturates (conv(2^31) -> 2^31-1).
    sat_fixed = np.int32((1 << (iwl + frac)) - 1) if iwl + frac < 31 else np.int32(2**31 - 1)
    absx_c = jnp.minimum(absx, maxf)

    # magnitude via mode-aware conversion.  The reference computes
    # conv(x * 2^frac) on the SIGNED value then takes two's-complement
    # magnitude (~v+1) for negatives (lib/layer_cuda.h:246), i.e.
    # magnitude = |conv(sign * |x| * 2^frac)|.
    def conv_mag(scaled_abs):
        # emulate conv() on the signed value: for trunc the magnitude is
        # trunc(|x|*2^f); for floor/ceil it flips for negatives.
        if fmt.mode == ROUND_TOWARD_ZERO:
            return jnp.trunc(scaled_abs)
        if fmt.mode == ROUND_NEAREST_EVEN:
            return jnp.round(scaled_abs)
        # floor on negatives = ceil of magnitude; ceil on negatives = floor.
        neg = sign.astype(jnp.bool_)
        if fmt.mode == ROUND_DOWN:
            return jnp.where(neg, jnp.ceil(scaled_abs), jnp.floor(scaled_abs))
        return jnp.where(neg, jnp.floor(scaled_abs), jnp.ceil(scaled_abs))

    if iwl + frac <= 24:
        # directly exact in f32
        mag = conv_mag(absx_c * (np.float32(2.0) ** np.int32(frac))).astype(jnp.int32)
    else:
        # hi/lo split: hi = conv(|x| * 2^(frac-16)) has <= 2^15 magnitude,
        # the remainder re-scaled by 2^16 recovers the low 16 bits exactly
        # (all steps are exact f32 operations for f32 inputs).
        hi_scaled = absx_c * (np.float32(2.0) ** np.int32(frac - 16))
        hi = jnp.trunc(hi_scaled)
        rem = hi_scaled - hi                       # exact: < 1, f32 fraction bits
        lo = conv_mag(rem * np.float32(65536.0))   # conv applies to the low part
        # ADD (not OR): under ROUND_UP/ROUND_DOWN the low conversion can
        # round to exactly 65536 and must carry into the high half
        mag = (hi.astype(jnp.int32) << 16) + lo.astype(jnp.int32)
        if iwl + frac == 31:
            # scaled magnitude can reach exactly 2^31 (x == +/-2^iwl).  The
            # reference's conversion is asymmetric there: positive values
            # saturate to 2^31-1 (cvt.rzi.s32.f32), negative values convert
            # to INT_MIN whose ~v+1 magnitude wraps to 0 with the sign bit
            # set (lib/layer_cuda.h:246).  The int32 shift above wraps
            # (2^15 << 16) to INT_MIN; mask/patch both signs explicitly.
            # The low-half carry (lo == 65536 under ROUND_UP) can also
            # reach 2^31 when hi == 32767.
            reach31 = (hi >= np.float32(32768.0)) | (
                (hi == np.float32(32767.0)) & (lo >= np.float32(65536.0)))
            mag = jnp.where(reach31,
                            jnp.where(sign > 0, np.int32(0), np.int32(2**31 - 1)),
                            mag)

    # float-compare saturation branch: strictly |x| > max -> all-ones
    # magnitude (CUDA_FIXED_MAX_FIXED / MIN_FIXED, lib/layer_cuda.h:207-208)
    mag = jnp.where(absx > maxf, sat_fixed, mag)
    return sign, mag


def decode_sign_magnitude(sign: jax.Array, mag: jax.Array, fmt: QFormat) -> jax.Array:
    """(sign, magnitude) -> float32, FIXED2FLOAT semantics
    (lib/layer_cuda.h:247): (float)mag / 2^frac with the sign applied.
    Note (float)mag rounds the int32 to f32 first, matching C."""
    magf = mag.astype(jnp.float32)
    val = magf * (np.float32(2.0) ** np.int32(-fmt.frac))
    return jnp.where(sign > 0, -val, val)


# ---------------------------------------------------------------------------
# Straight-through-estimator quantizer.
# ---------------------------------------------------------------------------

@functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def quantize_ste(x: jax.Array, fmt: QFormat) -> jax.Array:
    """float_quant with identity (straight-through) gradient.

    The reference never quantizes gradients (EN_GRAD_QUANT undefined,
    define.h:91; every *_bwd is invoked with f_fixed=false,
    lib/layer.c:551-555) — backward passes see raw float tensors.
    """
    return float_quant(x, fmt)


def _quantize_ste_fwd(x, fmt):
    return float_quant(x, fmt), None


def _quantize_ste_bwd(fmt, _, g):
    return (g,)


quantize_ste.defvjp(_quantize_ste_fwd, _quantize_ste_bwd)


# ---------------------------------------------------------------------------
# Gray code helpers (experimental capability kept from the reference:
# lib/common.c:335-394, lib/layer_cuda.cu:174-215).
# ---------------------------------------------------------------------------

def bin2gray(bin_val: jax.Array, idx_bit_low: int, idx_bit_high: int) -> jax.Array:
    """Binary -> Gray code over bit range [idx_bit_low, idx_bit_high]
    (inclusive), other bits zeroed.  Mirrors _cuda_bin2gray
    (lib/layer_cuda.cu:174-215): gray[high] = bin[high];
    gray[i] = bin[i+1] ^ bin[i] for i in [low, high)."""
    b = jnp.asarray(bin_val, jnp.int32)
    gray = b & (1 << idx_bit_high)
    for i in range(idx_bit_high - 1, idx_bit_low - 1, -1):
        gray = gray | ((((b >> (i + 1)) ^ (b >> i)) & 1) << i)
    return gray


def gray2bin(gray_val: jax.Array, idx_bit_low: int, idx_bit_high: int) -> jax.Array:
    """Gray -> binary inverse of bin2gray: bin[high] = gray[high];
    bin[i] = bin[i+1] ^ gray[i]."""
    g = jnp.asarray(gray_val, jnp.int32)
    binv = g & (1 << idx_bit_high)
    for i in range(idx_bit_high - 1, idx_bit_low - 1, -1):
        bit = (((binv >> (i + 1)) ^ (g >> i)) & 1) << i
        binv = binv | bit
    return binv
