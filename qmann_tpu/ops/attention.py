"""Attention score ops — the four attention modes of the reference
(MemN2N/define.h:10-15), including the paper's core contribution: the
bit-weighted Hamming-similarity "approximate attention" with its
hand-crafted surrogate gradient.

Mode 1: float dot product                 (qlinear.qscore, quantized=False)
Mode 2: quantized fixed-point dot product (qlinear.qscore)         [default]
Mode 3: Hamming-similarity approximate attention (this module)
Mode 4: binary attention — the reference's GPU path is unimplemented
        (prints "not implemented binary att mode yet", lib/layer.c:235);
        here it is provided as the commented-out intent: binarize both
        operands then take the float dot product (lib/layer.c:237-251).

Hamming attention forward (_cuda_approximate_attention,
lib/layer_cuda.cu:355-541):
  1. encode m[i,j] and u[j] as 32-bit sign-magnitude fixed words at the
     full-width format (iwl, 31-iwl)  (frac passed as 32-1-iwl,
     lib/layer_cuda.cu:2515);
  2. common-mode preprocessing (:400-420): with n = min(|a|,|b|): same
     sign -> subtract n from both magnitudes; different signs -> add n to
     the larger magnitude and zero the smaller;
  3. weighted Hamming similarity over the top num_bit bits (:261-296):
     sum of 2^-i over matching bit positions i in [1, num_bit), times
     -1 if the (word) signs differ;
  4. scale by 2^ATTENTION_CONST_SCALE (= 2^-3; define.h:67, :514);
  5. re-quantize each term and the row sum at (iwl, 31-iwl) (:520,:532).

Surrogate backward (_cuda_backprop_grad_out_mat :742-1071 and
_cuda_backprop_grad_out_vec :1076-1462) — reproduced bit-for-bit,
including the vec kernel's accumulate-stale-value quirk (tmp_a is only
*assigned* when bits differ but *accumulated* every bit, :1299-1372).

Mapping: everything is int32 elementwise work over a [..., M, D] lattice
with a static 8-iteration bit loop — XLA fuses it into one elementwise
kernel.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from qmann_tpu.numerics import QFormat, float_quant, encode_sign_magnitude

INT32_SIGN_BIT = np.int32(-(2 ** 31))  # 0x80000000 as int32

# ATTENTION_CONST_SCALE (MemN2N/define.h:67)
DEFAULT_CONST_SCALE = -3


def _encode_words(x: jax.Array, iwl: int, mode: int) -> jax.Array:
    """float32 -> 32-bit sign-magnitude word (int32) at format (iwl, 31-iwl)."""
    fmt = QFormat(iwl, 31 - iwl, mode)
    sign, mag = encode_sign_magnitude(x, fmt)
    return jnp.where(sign > 0, mag | INT32_SIGN_BIT, mag)


def _common_mode_preprocess(wm: jax.Array, wu: jax.Array):
    """lib/layer_cuda.cu:400-420 — operates on int32 sign-magnitude words;
    int32 additions wrap exactly like the C code's."""
    sm_bit = wm & INT32_SIGN_BIT
    su_bit = wu & INT32_SIGN_BIT
    mm = wm & np.int32(0x7FFFFFFF)
    mu = wu & np.int32(0x7FFFFFFF)
    mn = jnp.minimum(mm, mu)
    same = sm_bit == su_bit
    m_ge = mm >= mu
    new_mm = jnp.where(same, mm - mn, jnp.where(m_ge, mm + mn, 0))
    new_mu = jnp.where(same, mu - mn, jnp.where(m_ge, 0, mu + mn))
    return sm_bit | new_mm, su_bit | new_mu


def _bit(word: jax.Array, i: int) -> jax.Array:
    """Bit i counted from the MSB: (word & (0x80000000 >> i)) as 0/1."""
    return (word >> (31 - i)) & 1


def _weighted_similarity(wa: jax.Array, wb: jax.Array, num_bit: int,
                         weight_para: int = 0) -> jax.Array:
    """_cuda_hamming_similarity weighted variant (lib/layer_cuda.cu:261-296):
    sum of 2^(-i-weight_para) over matching bits i in [1, num_bit);
    negated if the sign bits of the (preprocessed) words differ.

    weight_para is HAMMING_WEIGHT_PARA (MemN2N/define.h:24-28, "w =
    2^(k+1-(n+hamming_weight_para))"; shipped value 0 with a commented -1
    variant).  The shipped kernel hardcodes the para=0 weighting 2^-i
    (lib/layer_cuda.cu:283-285 with the para form commented at :282)."""
    sim = jnp.zeros(jnp.broadcast_shapes(wa.shape, wb.shape), jnp.float32)
    for i in range(1, num_bit):
        match = (_bit(wa, i) == _bit(wb, i)).astype(jnp.float32)
        sim = sim + match * np.float32(2.0 ** (-i - weight_para))
    sign_differs = (wa & INT32_SIGN_BIT) != (wb & INT32_SIGN_BIT)
    return jnp.where(sign_differs, -sim, sim)


def unweighted_similarity(wa: jax.Array, wb: jax.Array, num_bit: int) -> jax.Array:
    """_cuda_hamming_similarity unweighted variant (lib/layer_cuda.cu:297-304):
    plain count of matching bits i in [1, num_bit)."""
    sim = jnp.zeros(jnp.broadcast_shapes(wa.shape, wb.shape), jnp.float32)
    for i in range(1, num_bit):
        sim = sim + (_bit(wa, i) == _bit(wb, i)).astype(jnp.float32)
    return sim


def gray_hamming_score(m: jax.Array, u: jax.Array, iwl: int, num_bit: int,
                       round_mode: int = 3) -> jax.Array:
    """The reference's gray-code Hamming experiment (kept capability,
    SURVEY.md 2.1; commented at lib/layer_cuda.cu:427-432): map each
    magnitude through bin2gray over bits [30-num_bit+2, 30], then take the
    UNWEIGHTED similarity over the top num_bit bits and sum over the
    embedding dimension.  Forward-only (the reference never wired a
    backward for it)."""
    from qmann_tpu.numerics import bin2gray
    wm = _encode_words(m, iwl, round_mode)
    wu = _encode_words(u, iwl, round_mode)[..., None, :]
    lo, hi = 30 - num_bit + 2, 30
    gm = bin2gray(wm & np.int32(0x7FFFFFFF), lo, hi)
    gu = bin2gray(wu & np.int32(0x7FFFFFFF), lo, hi)
    sim = unweighted_similarity(gm, gu, num_bit)
    return jnp.sum(sim, axis=-1)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3, 4, 5, 6, 7))
def hamming_score(m: jax.Array, u: jax.Array, iwl: int, num_bit: int,
                  const_scale: int = DEFAULT_CONST_SCALE,
                  round_mode: int = 3,
                  weight_para: int = 0, weighted: bool = True) -> jax.Array:
    """Approximate (Hamming-similarity) attention score.

    m: [..., M, D] memory embeddings; u: [..., D] query -> [..., M].
    num_bit: number of compared bits = 1 + iwl + frac of the layer's
    nominal format (lib/layer.c:230, passed as (1+iwl_m+frac_m)).
    weight_para: HAMMING_WEIGHT_PARA bit-weight exponent offset
    (define.h:24-28); weighted=False selects the unweighted plain
    bit-match count (_cuda_hamming_similarity f_weighted=false branch,
    lib/layer_cuda.cu:297-304).

    The surrogate backward is the reference's LIVE kernel either way —
    its para-dependent scalings exist only as commented experiments
    (lib/layer_cuda.cu:906-983), so weight_para/weighted alter the
    forward scores only.
    """
    return _hamming_fwd_impl(m, u, iwl, num_bit, const_scale, round_mode,
                             weight_para, weighted)


def _hamming_fwd_impl(m, u, iwl, num_bit, const_scale, round_mode,
                      weight_para=0, weighted=True):
    fmt_full = QFormat(iwl, 31 - iwl, round_mode)
    wm = _encode_words(m, iwl, round_mode)             # [..., M, D]
    wu = _encode_words(u, iwl, round_mode)[..., None, :]  # [..., 1, D]
    pm, pu = _common_mode_preprocess(wm, wu)
    if weighted:
        sim = _weighted_similarity(pm, pu, num_bit, weight_para)  # [...,M,D]
    else:
        sim = unweighted_similarity(pm, pu, num_bit)
    term = sim * np.float32(2.0 ** const_scale)        # :514
    term = float_quant(term, fmt_full)                 # :520
    return float_quant(jnp.sum(term, axis=-1), fmt_full)  # :524-532


def _hamming_fwd(m, u, iwl, num_bit, const_scale, round_mode,
                 weight_para, weighted):
    return (_hamming_fwd_impl(m, u, iwl, num_bit, const_scale, round_mode,
                              weight_para, weighted), (m, u))


def _hamming_bwd(iwl, num_bit, const_scale, round_mode,
                 weight_para, weighted, res, g):
    """Surrogate gradients, reproduced from the reference kernels.

    Both kernels re-encode and re-preprocess the inputs exactly as the
    forward does (lib/layer_cuda.cu:784-835, :1120-1170), but read the
    operand signs from the *original* (pre-preprocess) words.
    """
    m, u = res
    scale = np.float32(2.0 ** const_scale)
    wm = _encode_words(m, iwl, round_mode)
    wu = _encode_words(u, iwl, round_mode)[..., None, :]
    # signs of the original encoded words: +1 if the int32 word >= 0
    # (lib/layer_cuda.cu:787-801)
    sign_m = jnp.where(wm >= 0, jnp.float32(1.0), jnp.float32(-1.0))
    sign_u = jnp.where(wu >= 0, jnp.float32(1.0), jnp.float32(-1.0))
    pm, pu = _common_mode_preprocess(wm, wu)

    # --- grad wrt the memory matrix (_cuda_backprop_grad_out_mat) ---
    # tmp_a accumulates only where bits differ (:914-918, :972-980):
    #   i == 0: (mb-ub) * sign_m * 2^ACS
    #   i >= 1: -(mb-ub) * sign_u * 2^ACS
    tmp_a = jnp.zeros(pm.shape, jnp.float32)
    # --- grad wrt the query (_cuda_backprop_grad_out_vec) ---
    # tmp_v is ASSIGNED when bits differ and ACCUMULATED into grad_appx at
    # every bit — a stale value is re-added for matching bits
    # (:1299-1303, :1357-1365, grad_appx += tmp_a at :1372).
    #   i == 0: -(mb-ub) * sign_u * 2^ACS
    #   i >= 1:  (mb-ub) * sign_m * 2^ACS
    tmp_v = jnp.zeros(pm.shape, jnp.float32)
    grad_appx = jnp.zeros(pm.shape, jnp.float32)
    for i in range(num_bit):
        mb = _bit(pm, i).astype(jnp.float32)
        ub = _bit(pu, i).astype(jnp.float32)
        differ = mb != ub
        diff = mb - ub
        if i == 0:
            contrib_m = diff * sign_m * scale
            assign_v = -diff * sign_u * scale
        else:
            contrib_m = -diff * sign_u * scale
            assign_v = diff * sign_m * scale
        tmp_a = tmp_a + jnp.where(differ, contrib_m, 0.0)
        tmp_v = jnp.where(differ, assign_v, tmp_v)
        grad_appx = grad_appx + tmp_v

    g_row = g[..., :, None]                     # upstream grad per memory row
    dm = tmp_a * g_row                          # :1023
    du = jnp.sum(grad_appx * g_row, axis=-2)    # :1404,:1438-1445
    return dm, du


hamming_score.defvjp(_hamming_fwd, _hamming_bwd)


def binarize(x: jax.Array) -> jax.Array:
    """_cuda_binarization (lib/layer_cuda.cu:329-342): sign(x) with 0 -> +1."""
    return jnp.where(x >= 0.0, jnp.float32(1.0), jnp.float32(-1.0))


def binary_score(m: jax.Array, u: jax.Array) -> jax.Array:
    """Attention mode 4 as intended by the reference's commented code
    (lib/layer.c:237-251): binarize both operands, then float dot product.
    The reference's live GPU path leaves mode 4 unimplemented."""
    # default matmul precision is exact here: +/-1 operands are exact in
    # bf16 and TF32, and every partial sum is an integer <= D < 2^24
    return jnp.einsum("...md,...d->...m", binarize(m), binarize(u),
                      preferred_element_type=jnp.float32)


def attention_score(m: jax.Array, u: jax.Array, attention_mode: int,
                    fmt_att: QFormat, fmt_bin: QFormat,
                    num_bit: int | None = None,
                    const_scale: int = DEFAULT_CONST_SCALE,
                    score_mod: str = "none",
                    hamming_weight_para: int = 0,
                    hamming_weighted: bool = True,
                    grad_quantized: bool = False) -> jax.Array:
    """Dispatch over the four attention modes (lib/layer.c:167-251).

    score_mod (qlinear.qscore): opt-in saturation mitigation, applied to
    the quantized-dot mode only — mode 1 is float (softmax is
    shift-invariant there, nothing saturates) and modes 3/4 produce
    bounded scores (|hamming| <= D * 2^const_scale, |binary| <= D) that
    sit far from the Q-format bound at the reference dims."""
    from qmann_tpu.ops.qlinear import qscore
    if attention_mode == 1:
        # float forward; the backward still quantizes under EN_GRAD_QUANT
        # when the layer is fixed (lib/layer.c:539-562)
        return qscore(m, u, fmt_att, fmt_bin, quantized=False,
                      grad_quantized=grad_quantized)
    if attention_mode == 2:
        return qscore(m, u, fmt_att, fmt_bin, quantized=True,
                      score_mod=score_mod, grad_quantized=grad_quantized)
    if attention_mode == 3:
        nb = num_bit if num_bit is not None else 1 + fmt_att.iwl + fmt_att.frac
        return hamming_score(m, u, fmt_att.iwl, nb, const_scale,
                             fmt_att.mode, hamming_weight_para,
                             hamming_weighted)
    if attention_mode == 4:
        return binary_score(m, u)
    raise ValueError(f"unknown attention mode {attention_mode}")
