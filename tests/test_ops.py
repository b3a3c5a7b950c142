"""Op-level tests: quantized linear ops, Hamming attention (fwd + surrogate
bwd) against independent integer oracles, softmax variants, losses,
element-wise ops.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from qmann_tpu.numerics import QFormat, float_quant
from qmann_tpu.ops import (
    qmatvec, qembed_mat, qscore, qweighted_sum,
    hamming_score, binarize, softmax, shift_softmax, apply_softmax,
    cross_entropy, argmax_last, qsum, activation, maxout,
)
from test_numerics import oracle_quant, oracle_encode


# ---------------------------------------------------------------------------
# Quantized linear ops
# ---------------------------------------------------------------------------

def oracle_qmatvec(w, x, fmt_w, fmt_x):
    """Per-element oracle of _cuda_mat_vec_product (lib/layer_cuda.cu:49-83)."""
    O, I = w.shape
    out = np.zeros(O, np.float32)
    for o in range(O):
        s = np.float32(0.0)
        for i in range(I):
            wq = oracle_quant(w[o, i], fmt_w.iwl, fmt_w.frac)
            xq = oracle_quant(x[i], fmt_x.iwl, fmt_x.frac)
            s += oracle_quant(np.float32(wq * xq), fmt_w.iwl, fmt_w.frac)
        out[o] = oracle_quant(s, fmt_w.iwl, fmt_w.frac)
    return out


@pytest.mark.parametrize("iwl", [0, 2, 5])
def test_qmatvec_matches_oracle(rng, iwl):
    fmt_w = QFormat(iwl, 7 - iwl)
    fmt_x = QFormat(2, 5)
    w = rng.normal(0, 2.0, (6, 9)).astype(np.float32)
    x = rng.normal(0, 2.0, (9,)).astype(np.float32)
    got = np.asarray(qmatvec(jnp.asarray(w), jnp.asarray(x), fmt_w, fmt_x))
    want = oracle_qmatvec(w, x, fmt_w, fmt_x)
    np.testing.assert_array_equal(got, want)


def test_qmatvec_batched_equals_per_sample(rng):
    fmt = QFormat(5, 2)
    w = rng.normal(0, 1.0, (4, 7)).astype(np.float32)
    x = rng.normal(0, 1.0, (3, 7)).astype(np.float32)
    batched = np.asarray(qmatvec(jnp.asarray(w), jnp.asarray(x), fmt, fmt))
    for b in range(3):
        single = np.asarray(qmatvec(jnp.asarray(w), jnp.asarray(x[b]), fmt, fmt))
        np.testing.assert_array_equal(batched[b], single)


def test_qmatvec_backward_uses_raw_floats(rng):
    """Backward must be the float linear-map grads on RAW tensors
    (cuda_dense_bwd with f_fixed=false, lib/layer_cuda.cu:3266-3284),
    not gradients through the quantized values."""
    fmt = QFormat(5, 2)
    w = jnp.asarray(rng.normal(0, 1.0, (4, 7)).astype(np.float32))
    x = jnp.asarray(rng.normal(0, 1.0, (7,)).astype(np.float32))
    g = jnp.asarray(rng.normal(0, 1.0, (4,)).astype(np.float32))

    def f(w_, x_):
        return jnp.sum(qmatvec(w_, x_, fmt, fmt) * g)

    dw, dx = jax.grad(f, argnums=(0, 1))(w, x)
    np.testing.assert_allclose(np.asarray(dw), np.outer(g, x),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(dx), np.asarray(w).T @ np.asarray(g),
                               rtol=1e-5, atol=1e-6)


def test_qmatvec_batched_weight_grad_sums_over_batch(rng):
    fmt = QFormat(5, 2)
    w = jnp.asarray(rng.normal(0, 1.0, (4, 7)).astype(np.float32))
    x = jnp.asarray(rng.normal(0, 1.0, (3, 7)).astype(np.float32))
    dw = jax.grad(lambda w_: jnp.sum(qmatvec(w_, x, fmt, fmt)))(w)
    want = np.ones((3, 4)).T @ np.asarray(x)  # sum over batch of outer(1, x_b)
    np.testing.assert_allclose(np.asarray(dw), want, rtol=1e-6)


def test_qmatvec_binary_xnor_scale(rng):
    """Binary weights (iwl+frac==0) trigger the XNOR scale: out *=
    sum(w)/(O*I) — note raw sum, not abs (lib/layer_cuda.cu:3188-3200,
    _cuda_l1_norm :1624-1650)."""
    fmt_w = QFormat(0, 0)
    fmt_x = QFormat(2, 5)
    w = np.array([[0.5, -0.25], [1.0, 2.0]], np.float32)
    x = np.array([1.0, 1.0], np.float32)
    # binarized w = [[1,-1],[1,1]], xq = [0.99.., 0.99..] -> per-product
    # quant at (0,0) binarizes products to +/-1!
    got = np.asarray(qmatvec(jnp.asarray(w), jnp.asarray(x), fmt_w, fmt_x))
    scale = w.sum() / 4.0
    # products: Q(+/-1 * 0.99, (0,0)) = +/-1; row sums [0, 2] -> Q((0,0)) ->
    # [1, 1]  (binarize maps 0 -> +1!)
    np.testing.assert_allclose(got, np.array([1.0, 1.0]) * scale, rtol=1e-6)


def test_qscore_and_weighted_sum_shapes_and_grads(rng):
    fmt = QFormat(5, 2)
    m = jnp.asarray(rng.normal(0, 1.0, (2, 5, 4)).astype(np.float32))
    u = jnp.asarray(rng.normal(0, 1.0, (2, 4)).astype(np.float32))
    p = jnp.asarray(rng.normal(0, 1.0, (2, 5)).astype(np.float32))
    s = qscore(m, u, fmt, fmt)
    assert s.shape == (2, 5)
    ones = jnp.ones((2, 5), jnp.float32)
    o = qweighted_sum(m, p, ones, fmt)
    assert o.shape == (2, 4)
    # masking a row removes exactly its quantized contribution
    mask = ones.at[0, 4].set(0.0)
    o_masked = qweighted_sum(m, p, mask, fmt)
    m_z = m.at[0, 4].set(0.0)
    p_z = p.at[0, 4].set(0.0)
    o_want = qweighted_sum(m_z, p_z, ones, fmt)
    np.testing.assert_array_equal(np.asarray(o_masked), np.asarray(o_want))
    # grads are the raw-float bilinear grads
    dm, du = jax.grad(lambda m_, u_: jnp.sum(qscore(m_, u_, fmt, fmt)),
                      argnums=(0, 1))(m, u)
    np.testing.assert_allclose(np.asarray(du), np.asarray(m).sum(1), rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(dm), np.broadcast_to(np.asarray(u)[:, None, :], m.shape),
        rtol=1e-6)


def test_qembed_mat_matches_qmatvec_per_row(rng):
    fmt = QFormat(5, 2)
    s = rng.integers(0, 3, (4, 9)).astype(np.float32)   # BoW-like counts
    a = rng.normal(0, 1.0, (6, 9)).astype(np.float32)
    got = np.asarray(qembed_mat(jnp.asarray(s), jnp.asarray(a), fmt))
    for r in range(4):
        row = np.asarray(qmatvec(jnp.asarray(a), jnp.asarray(s[r]), fmt, fmt))
        np.testing.assert_array_equal(got[r], row)


# ---------------------------------------------------------------------------
# Hamming attention — forward oracle
# ---------------------------------------------------------------------------

def oracle_preprocess(wa_sign, wa_mag, wb_sign, wb_mag):
    """lib/layer_cuda.cu:400-420 on (sign, mag) pairs; int32 wrap."""
    def wrap(v):
        v &= 0xFFFFFFFF
        return v - (1 << 32) if v >= (1 << 31) else v
    mn = min(wa_mag, wb_mag)
    if wa_sign == wb_sign:
        na, nb = wa_mag - mn, wb_mag - mn
    elif wa_mag >= wb_mag:
        na, nb = wrap(wa_mag + mn), 0
    else:
        na, nb = 0, wrap(wb_mag + mn)
    wa = (na & 0x7FFFFFFF) | (0x80000000 if (wa_sign or (na & 0x80000000)) else 0)
    wb = (nb & 0x7FFFFFFF) | (0x80000000 if (wb_sign or (nb & 0x80000000)) else 0)
    return wa & 0xFFFFFFFF, wb & 0xFFFFFFFF


def oracle_hamming_sim(wa, wb, num_bit, weight_para=0, weighted=True):
    """lib/layer_cuda.cu:261-304 similarity on 32-bit words: the weighted
    branch with the HAMMING_WEIGHT_PARA exponent offset (define.h:24-28,
    the commented powf(2,-i-para) form at :282) and the unweighted
    f_weighted=false branch (plain matching-bit count, no sign flip)."""
    sim = 0.0
    for i in range(1, num_bit):
        if (wa & (0x80000000 >> i)) == (wb & (0x80000000 >> i)):
            sim += 2.0 ** (-i - weight_para) if weighted else 1.0
    if weighted and (wa & 0x80000000) != (wb & 0x80000000):
        sim = -sim
    return np.float32(sim)


def oracle_hamming_score(m, u, iwl, num_bit, const_scale=-3, weight_para=0,
                         weighted=True):
    M, D = m.shape
    frac = 31 - iwl
    out = np.zeros(M, np.float32)
    for i in range(M):
        s = np.float32(0.0)
        for j in range(D):
            sa, ma = oracle_encode(m[i, j], iwl, frac)
            sb, mb = oracle_encode(u[j], iwl, frac)
            wa, wb = oracle_preprocess(sa, ma, sb, mb)
            sim = oracle_hamming_sim(wa, wb, num_bit, weight_para, weighted)
            term = np.float32(sim * np.float32(2.0 ** const_scale))
            s += oracle_quant(term, iwl, frac)
        out[i] = oracle_quant(s, iwl, frac)
    return out


@pytest.mark.parametrize("iwl", [0, 1, 2, 5])
def test_hamming_score_matches_oracle(rng, iwl):
    num_bit = 8
    act_fmt = QFormat(iwl, 7 - iwl)
    # on-grid activations like the model produces
    m = np.asarray(float_quant(
        jnp.asarray(rng.normal(0, 2.0, (6, 5)).astype(np.float32)), act_fmt))
    u = np.asarray(float_quant(
        jnp.asarray(rng.normal(0, 2.0, (5,)).astype(np.float32)), act_fmt))
    got = np.asarray(hamming_score(jnp.asarray(m), jnp.asarray(u), iwl, num_bit))
    want = oracle_hamming_score(m, u, iwl, num_bit)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("weight_para", [0, -1])
def test_hamming_weight_para_matches_oracle(rng, weight_para):
    """HAMMING_WEIGHT_PARA knob (define.h:24-28) at the shipped value and
    the commented -1 variant, against the C-semantics oracle."""
    iwl, num_bit = 2, 8
    act_fmt = QFormat(iwl, 7 - iwl)
    m = np.asarray(float_quant(
        jnp.asarray(rng.normal(0, 2.0, (6, 5)).astype(np.float32)), act_fmt))
    u = np.asarray(float_quant(
        jnp.asarray(rng.normal(0, 2.0, (5,)).astype(np.float32)), act_fmt))
    got = np.asarray(hamming_score(jnp.asarray(m), jnp.asarray(u), iwl,
                                   num_bit, -3, 3, weight_para))
    want = oracle_hamming_score(m, u, iwl, num_bit,
                                weight_para=weight_para)
    np.testing.assert_array_equal(got, want)
    if weight_para != 0:
        # the knob must actually change the scores vs the shipped default
        base = np.asarray(hamming_score(jnp.asarray(m), jnp.asarray(u), iwl,
                                        num_bit))
        assert not np.array_equal(got, base)


def test_hamming_unweighted_matches_oracle(rng):
    """f_weighted=false similarity branch (lib/layer_cuda.cu:297-304)."""
    iwl, num_bit = 2, 8
    act_fmt = QFormat(iwl, 7 - iwl)
    m = np.asarray(float_quant(
        jnp.asarray(rng.normal(0, 2.0, (6, 5)).astype(np.float32)), act_fmt))
    u = np.asarray(float_quant(
        jnp.asarray(rng.normal(0, 2.0, (5,)).astype(np.float32)), act_fmt))
    got = np.asarray(hamming_score(jnp.asarray(m), jnp.asarray(u), iwl,
                                   num_bit, -3, 3, 0, False))
    want = oracle_hamming_score(m, u, iwl, num_bit, weighted=False)
    np.testing.assert_array_equal(got, want)


def test_hamming_score_off_grid_floats(rng):
    iwl = 2
    m = rng.normal(0, 2.0, (4, 3)).astype(np.float32)
    u = rng.normal(0, 2.0, (3,)).astype(np.float32)
    got = np.asarray(hamming_score(jnp.asarray(m), jnp.asarray(u), iwl, 8))
    want = oracle_hamming_score(m, u, iwl, 8)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Hamming attention — surrogate backward oracle
# ---------------------------------------------------------------------------

def oracle_hamming_bwd(m, u, g, iwl, num_bit, const_scale=-3):
    """_cuda_backprop_grad_out_mat (lib/layer_cuda.cu:742-1071) and
    _cuda_backprop_grad_out_vec (:1076-1462), including the vec kernel's
    stale-accumulate quirk."""
    M, D = m.shape
    frac = 31 - iwl
    scale = np.float32(2.0 ** const_scale)
    dm = np.zeros((M, D), np.float32)
    du = np.zeros(D, np.float32)
    for i in range(M):
        for j in range(D):
            sa, ma = oracle_encode(m[i, j], iwl, frac)
            sb, mb = oracle_encode(u[j], iwl, frac)
            sign_m = -1.0 if sa else 1.0
            sign_u = -1.0 if sb else 1.0
            wa, wb = oracle_preprocess(sa, ma, sb, mb)
            tmp_a = np.float32(0.0)
            tmp_v = np.float32(0.0)
            grad_appx = np.float32(0.0)
            for k in range(num_bit):
                mbit = (wa >> (31 - k)) & 1
                ubit = (wb >> (31 - k)) & 1
                diff = np.float32(mbit - ubit)
                if mbit != ubit:
                    if k == 0:
                        tmp_a += diff * sign_m * scale
                        tmp_v = -diff * sign_u * scale
                    else:
                        tmp_a += -diff * sign_u * scale
                        tmp_v = diff * sign_m * scale
                grad_appx += tmp_v
            dm[i, j] = tmp_a * g[i]
            du[j] += grad_appx * g[i]
    return dm, du


@pytest.mark.parametrize("iwl", [0, 1, 5])
def test_hamming_surrogate_gradient_matches_oracle(rng, iwl):
    num_bit = 8
    act_fmt = QFormat(iwl, 7 - iwl)
    m = np.asarray(float_quant(
        jnp.asarray(rng.normal(0, 2.0, (5, 4)).astype(np.float32)), act_fmt))
    u = np.asarray(float_quant(
        jnp.asarray(rng.normal(0, 2.0, (4,)).astype(np.float32)), act_fmt))
    g = rng.normal(0, 1.0, (5,)).astype(np.float32)

    def f(m_, u_):
        return jnp.sum(hamming_score(m_, u_, iwl, num_bit) * jnp.asarray(g))

    dm, du = jax.grad(f, argnums=(0, 1))(jnp.asarray(m), jnp.asarray(u))
    want_dm, want_du = oracle_hamming_bwd(m, u, g, iwl, num_bit)
    np.testing.assert_allclose(np.asarray(dm), want_dm, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(du), want_du, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Softmax / losses / elementwise
# ---------------------------------------------------------------------------

def test_masked_softmax_matches_dense_softmax(rng):
    x = rng.normal(0, 1.0, (2, 6)).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 0, 0], [1, 1, 1, 1, 1, 0]], bool)
    got = np.asarray(softmax(jnp.asarray(x), jnp.asarray(mask)))
    for b in range(2):
        n = mask[b].sum()
        e = np.exp(x[b, :n] - x[b, :n].max())
        np.testing.assert_allclose(got[b, :n], e / e.sum(), rtol=1e-6)
        np.testing.assert_array_equal(got[b, n:], 0.0)


def test_shift_softmax_forward_and_07_backward(rng):
    x = jnp.asarray(rng.normal(0, 1.0, (5,)).astype(np.float32))
    out = shift_softmax(x, None, 0)
    e = np.exp(np.asarray(x) - np.asarray(x).max())
    want = e / np.round(np.log2(e.sum()))
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-6)
    # backward: 0.7 * p * (g - sum(p*g))  (lib/layer_cuda.cu:2127)
    g = rng.normal(0, 1.0, (5,)).astype(np.float32)
    dx = jax.grad(lambda x_: jnp.sum(shift_softmax(x_, None, 0) * jnp.asarray(g)))(x)
    p = np.asarray(out)
    want_dx = 0.7 * p * (g - (p * g).sum())
    np.testing.assert_allclose(np.asarray(dx), want_dx, rtol=1e-5)


def test_linear_start_removes_softmax(rng):
    x = jnp.asarray(rng.normal(0, 1.0, (4,)).astype(np.float32))
    mask = jnp.asarray([True, True, False, False])
    out = apply_softmax(x, mask, remove=True)
    np.testing.assert_array_equal(np.asarray(out)[:2], np.asarray(x)[:2])
    np.testing.assert_array_equal(np.asarray(out)[2:], 0.0)


def test_argmax_last_tie_break():
    x = jnp.asarray([[1.0, 3.0, 3.0, 0.0], [5.0, 1.0, 5.0, 5.0]])
    np.testing.assert_array_equal(np.asarray(argmax_last(x)), [2, 3])


def test_cross_entropy_gradient_is_h_minus_y(rng):
    logits = jnp.asarray(rng.normal(0, 1.0, (3, 5)).astype(np.float32))
    y = np.zeros((3, 5), np.float32)
    y[np.arange(3), [1, 0, 4]] = 1.0
    dlogits = jax.grad(lambda l: cross_entropy(l, jnp.asarray(y)).loss)(logits)
    h = np.asarray(jax.nn.softmax(logits, axis=-1))
    np.testing.assert_allclose(np.asarray(dlogits), h - y, rtol=1e-5)
    # reported "cost" is -sum(p[y]) (probability, not log)
    met = cross_entropy(logits, jnp.asarray(y))
    np.testing.assert_allclose(float(met.cost), -(h * y).sum(), rtol=1e-6)


def test_squared_error_cost_and_grad(rng):
    # se_run (lib/layer.c:3607-3622): cost = sum((h-y)^2)/2, grad = h-y.
    from qmann_tpu.ops import squared_error
    h = jnp.asarray(rng.normal(0, 1.0, (6,)).astype(np.float32))
    y = jnp.asarray(rng.normal(0, 1.0, (6,)).astype(np.float32))
    cost, grad = jax.value_and_grad(squared_error)(h, y)
    np.testing.assert_allclose(float(cost),
                               0.5 * ((np.asarray(h) - np.asarray(y)) ** 2).sum(),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(grad),
                               np.asarray(h) - np.asarray(y), rtol=1e-6)


def test_qsum_quantized_forward_passthrough_backward(rng):
    fmt = QFormat(5, 2)
    a = jnp.asarray([1.3, -0.9], jnp.float32)
    b = jnp.asarray([0.4, 0.4], jnp.float32)
    out = qsum(a, b, fmt)
    # Q(1.25+0.25)=1.5, Q(-0.75+0.25)=-0.5
    np.testing.assert_array_equal(np.asarray(out), [1.5, -0.5])
    da, db = jax.grad(lambda a_, b_: jnp.sum(qsum(a_, b_, fmt) * 3.0),
                      argnums=(0, 1))(a, b)
    np.testing.assert_array_equal(np.asarray(da), [3.0, 3.0])
    np.testing.assert_array_equal(np.asarray(db), [3.0, 3.0])


def test_activation_relu_backward_on_output():
    x = jnp.asarray([-1.0, 2.0], jnp.float32)
    dx = jax.grad(lambda x_: jnp.sum(activation(x_, "RELU", None, False)))(x)
    np.testing.assert_array_equal(np.asarray(dx), [0.0, 1.0])


def test_binarize_and_maxout():
    np.testing.assert_array_equal(
        np.asarray(binarize(jnp.asarray([-0.5, 0.0, 0.5]))), [-1, 1, 1])
    x = jnp.asarray([[1.0, 5.0, 2.0, 0.0]], jnp.float32)
    np.testing.assert_array_equal(np.asarray(maxout(x, 2)), [[5.0, 2.0]])


def test_gray_hamming_score_capability(rng):
    from qmann_tpu.ops.attention import gray_hamming_score
    m = jnp.asarray(rng.normal(0, 1, (4, 3)).astype(np.float32))
    u = jnp.asarray(rng.normal(0, 1, (3,)).astype(np.float32))
    s = gray_hamming_score(m[None], u[None], iwl=2, num_bit=8)
    assert s.shape == (1, 4)
    assert np.isfinite(np.asarray(s)).all()
    # identical inputs achieve the maximum similarity count
    s_same = gray_hamming_score(jnp.broadcast_to(u, (1, 4, 3)), u[None], 2, 8)
    assert (np.asarray(s_same) == 7 * 3).all()


@pytest.mark.parametrize("scale_w", [0.1, 1.0, 20.0])
def test_qembed_integer_fast_path_is_exact(rng, scale_w):
    """With integer BoW inputs the matmul fast path must agree bit-for-bit
    with the product-lattice path across non-saturating and saturating
    weight scales (the dynamic guard picks the correct branch)."""
    fmt = QFormat(5, 2)
    s = rng.integers(0, 4, (5, 9)).astype(np.float32)
    a = (rng.normal(0, scale_w, (6, 9))).astype(np.float32)
    fast = qembed_mat(jnp.asarray(s), jnp.asarray(a), fmt,
                      integer_inputs=True)
    slow = qembed_mat(jnp.asarray(s), jnp.asarray(a), fmt,
                      integer_inputs=False)
    np.testing.assert_array_equal(np.asarray(fast), np.asarray(slow))


def test_qembed_fast_path_wide_format_guard(rng):
    """Wide Q-formats (e.g. Q5.26 from --bw-wl 32) put row sums beyond
    2^24 grid units, where one-matmul f32 accumulation is no longer exact;
    the guard must route those to the lattice path even though the old
    saturation-only conditions pass."""
    from qmann_tpu.numerics import fixed_max_float
    from qmann_tpu.ops.qlinear import _integer_input_fast_path_ok
    fmt = QFormat(5, 26)
    s = rng.integers(0, 8, (6, 24)).astype(np.float32)
    a = rng.normal(0, 1.0, (5, 24)).astype(np.float32)
    # the pre-fix guard (saturation checks only) would take the fast path
    maxf = fixed_max_float(fmt.iwl, fmt.frac)
    max_wq = float(np.max(np.abs(np.asarray(float_quant(jnp.asarray(a), fmt)))))
    assert s.max() <= maxf and s.max() * max_wq <= maxf
    # the fixed guard adds the 2^24-grid-unit accumulation bound
    assert not bool(_integer_input_fast_path_ok(
        jnp.asarray(s), jnp.asarray(a), fmt))
    # a wide format whose row sums stay under 2^24 grid units still takes
    # the fast path, and there it is bit-exact against the lattice
    fmt2 = QFormat(5, 10)
    assert bool(_integer_input_fast_path_ok(
        jnp.asarray(s), jnp.asarray(a), fmt2))
    fast2 = qembed_mat(jnp.asarray(s), jnp.asarray(a), fmt2,
                       integer_inputs=True)
    slow2 = qembed_mat(jnp.asarray(s), jnp.asarray(a), fmt2,
                       integer_inputs=False)
    np.testing.assert_array_equal(np.asarray(fast2), np.asarray(slow2))


def test_qembed_fast_path_low_bit_saturation(rng):
    # iwl=0: maxf < 1 so even count=1 saturates -> guard must take slow
    fmt = QFormat(0, 7)
    s = rng.integers(0, 3, (4, 6)).astype(np.float32)
    a = rng.normal(0, 0.3, (5, 6)).astype(np.float32)
    fast = qembed_mat(jnp.asarray(s), jnp.asarray(a), fmt,
                      integer_inputs=True)
    slow = qembed_mat(jnp.asarray(s), jnp.asarray(a), fmt,
                      integer_inputs=False)
    np.testing.assert_array_equal(np.asarray(fast), np.asarray(slow))


def test_qembed_bf16_fast_path_boundary_magnitudes(rng):
    """The single-pass bf16 matmul path must stay bit-exact at the 8-bit
    format's extremes: quantized weight magnitudes of 255 grid units
    (QFormat(8,0)) and counts at the saturation bound — every such integer
    is exactly representable in bf16's 8-bit significand."""
    fmt = QFormat(8, 0)          # maxf = 255, weights quantized to ints
    s = np.zeros((3, 8), np.float32)
    s[0, :4] = [255.0, 254.0, 1.0, 2.0]
    s[1, 4:] = [127.0, 128.0, 3.0, 0.0]
    s[2, :] = 1.0
    a = np.zeros((4, 8), np.float32)
    a[:, 0] = [1.0, -1.0, 0.5, 0.9]          # quantize to 1, -1, 0, 0
    a[:, 4] = [1.0, 0.0, -1.0, 1.0]
    from qmann_tpu.ops.qlinear import _integer_input_fast_path_ok
    assert bool(_integer_input_fast_path_ok(jnp.asarray(s), jnp.asarray(a),
                                            fmt))
    fast = qembed_mat(jnp.asarray(s), jnp.asarray(a), fmt,
                      integer_inputs=True)
    slow = qembed_mat(jnp.asarray(s), jnp.asarray(a), fmt,
                      integer_inputs=False)
    np.testing.assert_array_equal(np.asarray(fast), np.asarray(slow))


@pytest.mark.parametrize("scale_w", [0.1, 1.0, 20.0])
def test_qmatvec_integer_fast_path_is_exact(rng, scale_w):
    """qmatvec's integer-input matmul fast path (mixed weight/input formats,
    e.g. the emb_q query embedding on BoW counts) must agree bit-for-bit
    with the product lattice; the dynamic guard routes saturating scales
    to the slow branch."""
    from qmann_tpu.ops import qmatvec
    fmt_w, fmt_x = QFormat(6, 1), QFormat(5, 2)
    x = rng.integers(0, 3, (7, 9)).astype(np.float32)
    w = rng.normal(0, scale_w, (6, 9)).astype(np.float32)
    fast = qmatvec(jnp.asarray(w), jnp.asarray(x), fmt_w, fmt_x,
                   integer_inputs=True)
    slow = qmatvec(jnp.asarray(w), jnp.asarray(x), fmt_w, fmt_x,
                   integer_inputs=False)
    np.testing.assert_array_equal(np.asarray(fast), np.asarray(slow))


def test_qembed_mat_multi_matches_single(rng):
    """The stacked multi-format embed must be bit-identical to K separate
    qembed_mat calls (values AND gradients), including a weight shared
    between two slots (layer-wise tying across hops under EN_MQ)."""
    from qmann_tpu.ops import qembed_mat_multi
    fmts = (QFormat(6, 1), QFormat(5, 2), QFormat(4, 3))
    s = jnp.asarray(rng.integers(0, 3, (4, 5, 9)).astype(np.float32))
    a = jnp.asarray(rng.normal(0, 1.0, (6, 9)).astype(np.float32))
    c = jnp.asarray(rng.normal(0, 1.0, (6, 9)).astype(np.float32))
    weights = (a, c, a)    # a appears twice (shared across hops)

    outs = qembed_mat_multi(s, weights, fmts, integer_inputs=True)
    for out, w, fmt in zip(outs, weights, fmts):
        ref = qembed_mat(s, w, fmt, integer_inputs=True)
        np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))

    def loss_multi(a, c):
        outs = qembed_mat_multi(s, (a, c, a), fmts, integer_inputs=True)
        return sum(jnp.sum(o * (i + 1.0)) for i, o in enumerate(outs))

    def loss_single(a, c):
        outs = [qembed_mat(s, w, fmt, integer_inputs=True)
                for w, fmt in zip((a, c, a), fmts)]
        return sum(jnp.sum(o * (i + 1.0)) for i, o in enumerate(outs))

    ga_m, gc_m = jax.grad(loss_multi, argnums=(0, 1))(a, c)
    ga_s, gc_s = jax.grad(loss_single, argnums=(0, 1))(a, c)
    np.testing.assert_allclose(np.asarray(ga_m), np.asarray(ga_s), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(gc_m), np.asarray(gc_s), rtol=1e-6)

    # float mode and a binary format both fall back to per-entry paths
    outs_f = qembed_mat_multi(s, weights, fmts, quantized=False)
    for out, w in zip(outs_f, weights):
        ref = qembed_mat(s, w, fmts[0], quantized=False)
        np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))
    fmts_b = (QFormat(0, 0), QFormat(5, 2), QFormat(4, 3))
    outs_b = qembed_mat_multi(s, weights, fmts_b, integer_inputs=True)
    for out, w, fmt in zip(outs_b, weights, fmts_b):
        ref = qembed_mat(s, w, fmt, integer_inputs=True)
        np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


# ---------------------------------------------------------------------------
# EN_GRAD_QUANT per-backward placement (f_fixed threading,
# lib/layer.c:551-555; cuda_dot_mat_vec_bwd f_fixed=true branches)
# ---------------------------------------------------------------------------

def _gq_fmt(iwl, frac):
    """The reference's backward output format (1, iwl+frac-1)."""
    return 1, iwl + frac - 1


def test_qscore_grad_quantized_matches_kernel_semantics(rng):
    """cuda_dot_mat_vec_bwd non-trans f_fixed=true
    (lib/layer_cuda.cu:2603-2609): grad_M[r,d] = Q(FIXED_MUL(g_r, u_d))
    and grad_u[d] = Q(sum_r FIXED_MUL(g_r, M_rd)), products at
    (iwl_m, frac_m), outputs at (1, iwl+frac-1)."""
    from qmann_tpu.ops import qscore
    fmt = QFormat(5, 2)
    oi, of = _gq_fmt(5, 2)
    M, D = 6, 5
    m = rng.normal(0, 2, (M, D)).astype(np.float32)
    u = rng.normal(0, 2, (D,)).astype(np.float32)
    g = rng.normal(0, 1, (M,)).astype(np.float32)

    def f(m_, u_):
        return jnp.sum(qscore(m_, u_, fmt, fmt, True, "none", True)
                       * jnp.asarray(g))

    dm, du = jax.grad(f, argnums=(0, 1))(jnp.asarray(m), jnp.asarray(u))

    def qq(x):
        return oracle_quant(np.float32(x), 5, 2)

    want_dm = np.zeros((M, D), np.float32)
    want_du = np.zeros(D, np.float32)
    for r in range(M):
        for d in range(D):
            prod = qq(np.float32(qq(g[r]) * qq(u[d])))
            want_dm[r, d] = oracle_quant(prod, oi, of)
    for d in range(D):
        s = np.float32(0.0)
        for r in range(M):
            s += qq(np.float32(qq(g[r]) * qq(m[r, d])))
        want_du[d] = oracle_quant(s, oi, of)
    np.testing.assert_array_equal(np.asarray(dm), want_dm)
    np.testing.assert_array_equal(np.asarray(du), want_du)


def test_qweighted_sum_grad_quantized_matches_kernel_semantics(rng):
    """cuda_dot_mat_vec_bwd f_trans f_fixed=true
    (lib/layer_cuda.cu:2590-2596): grad_C[r,d] = Q(FIXED_MUL(p_r, g_d)),
    grad_p[r] = Q(sum_d FIXED_MUL(C_rd, g_d))."""
    from qmann_tpu.ops import qweighted_sum
    fmt = QFormat(5, 2)
    oi, of = _gq_fmt(5, 2)
    M, D = 6, 5
    c = rng.normal(0, 2, (M, D)).astype(np.float32)
    p = rng.random((M,)).astype(np.float32)
    g = rng.normal(0, 1, (D,)).astype(np.float32)
    ones = jnp.ones((M,), jnp.float32)

    def f(c_, p_):
        return jnp.sum(qweighted_sum(c_, p_, ones, fmt, True, True)
                       * jnp.asarray(g))

    dc, dp = jax.grad(f, argnums=(0, 1))(jnp.asarray(c), jnp.asarray(p))

    def qq(x):
        return oracle_quant(np.float32(x), 5, 2)

    want_dc = np.zeros((M, D), np.float32)
    want_dp = np.zeros(M, np.float32)
    for r in range(M):
        for d in range(D):
            want_dc[r, d] = oracle_quant(
                qq(np.float32(qq(p[r]) * qq(g[d]))), oi, of)
        s = np.float32(0.0)
        for d in range(D):
            s += qq(np.float32(qq(c[r, d]) * qq(g[d])))
        want_dp[r] = oracle_quant(s, oi, of)
    np.testing.assert_array_equal(np.asarray(dc), want_dc)
    np.testing.assert_array_equal(np.asarray(dp), want_dp)


def test_grad_gate_independent_of_forward_quantization(rng):
    """The backward gate is grad_quantized ALONE: the reference's mode-1
    layers run a FLOAT forward (f_fixed hardcoded false in the fwd
    dispatch, lib/layer.c:188) but their EN_GRAD_QUANT backward still
    quantizes when the layer is fixed (bwd passes dot->f_fixed,
    lib/layer.c:551-555)."""
    from qmann_tpu.ops import qscore, qweighted_sum
    fmt = QFormat(5, 2)
    oi, of = _gq_fmt(5, 2)
    M, D = 5, 4
    m = rng.normal(0, 2, (M, D)).astype(np.float32)
    u = rng.normal(0, 2, (D,)).astype(np.float32)
    g = rng.normal(0, 1, (M,)).astype(np.float32)

    def f(m_, u_):
        # quantized=False (mode-1 float fwd) + grad_quantized=True
        return jnp.sum(qscore(m_, u_, fmt, fmt, False, "none", True)
                       * jnp.asarray(g))

    dm, _ = jax.grad(f, argnums=(0, 1))(jnp.asarray(m), jnp.asarray(u))

    def qq(x):
        return oracle_quant(np.float32(x), 5, 2)

    want_dm = np.zeros((M, D), np.float32)
    for r in range(M):
        for d in range(D):
            want_dm[r, d] = oracle_quant(
                qq(np.float32(qq(g[r]) * qq(u[d]))), oi, of)
    np.testing.assert_array_equal(np.asarray(dm), want_dm)
