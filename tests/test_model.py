"""Model- and trainer-level tests: shapes, tying equivalence, schedule,
optimizer semantics, and an end-to-end convergence smoke test on qa1.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from qmann_tpu.config import QmannConfig
from qmann_tpu.data import load_task, DataDims
from qmann_tpu.models import memn2n
from qmann_tpu.train import (
    lr_schedule, sgd_update, zero_null_columns, rowsum_l2_norm,
    train_task, eval_split,
)

from qmann_tpu.data.synth import TASK as QA1


def tiny_cfg(**kw):
    base = dict(dim_emb=8, num_hops=3, num_itr=2, size_batch=4, verbose=False)
    base.update(kw)
    return QmannConfig(**base)


def fake_dims(dim_input=20):
    return DataDims(dim_dict=12, max_line=8, max_word=6, dim_word=7,
                    dim_input=dim_input)


def fake_batch(rng, n=5, m=8, dim_input=20):
    mem = rng.integers(0, 2, (n, m, dim_input)).astype(np.float32)
    que = rng.integers(0, 2, (n, dim_input)).astype(np.float32)
    ans = np.zeros((n, dim_input), np.float32)
    ans[np.arange(n), rng.integers(1, dim_input, n)] = 1.0
    n_sen = rng.integers(1, m + 1, n)
    mask = np.arange(m)[None, :] < n_sen[:, None]
    mem = mem * mask[:, :, None]
    return (jnp.asarray(mem), jnp.asarray(que), jnp.asarray(ans),
            jnp.asarray(mask))


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_forward_shapes_all_attention_modes(rng, mode):
    cfg = tiny_cfg(attention_mode=mode)
    dims = fake_dims()
    params = memn2n.init_params(cfg, dims, jax.random.PRNGKey(0))
    mem, que, ans, mask = fake_batch(rng)
    out = memn2n.forward(params, mem, que, mask, cfg)
    assert out.logits.shape == (5, 20)
    assert out.attention.shape == (3, 5, 8)
    assert np.isfinite(np.asarray(out.logits)).all()
    # attention over live rows sums to 1, padded rows are exactly 0
    attn = np.asarray(out.attention)
    m_np = np.asarray(mask)
    np.testing.assert_allclose(attn.sum(-1), 1.0, rtol=1e-5)
    assert (attn[:, ~m_np] == 0).all()


def test_hamming_weight_para_reaches_forward(rng):
    """The HAMMING_WEIGHT_PARA config knob must change mode-3 scores
    (dispatch wiring, not just the op-level parameter)."""
    dims = fake_dims()
    mem, que, ans, mask = fake_batch(rng)
    base = tiny_cfg(attention_mode=3, iwl=1)
    params = memn2n.init_params(base, dims, jax.random.PRNGKey(0))
    s0 = np.asarray(memn2n.forward(params, mem, que, mask, base).scores)
    s1 = np.asarray(memn2n.forward(
        params, mem, que, mask,
        base.replace(hamming_weight_para=-1)).scores)
    s2 = np.asarray(memn2n.forward(
        params, mem, que, mask, base.replace(hamming_weighted=False)).scores)
    assert not np.array_equal(s0, s1)
    assert not np.array_equal(s0, s2)


def test_mode3_grads_independent_of_en_grad_quant(rng):
    """Mode-3's fixed-point weighted-sum backward quantizes
    UNCONDITIONALLY (cuda_dot_mat_vec_bwd_appx receives dot->f_fixed with
    no EN_GRAD_QUANT gate, lib/layer.c:588-599), the score backward is
    the surrogate, and dense backwards are float under every placement —
    so for the default model, EN_GRAD_QUANT must change NOTHING in
    mode 3.  (In mode 2 it must change the gradients.)"""
    dims = fake_dims()
    mem, que, ans, mask = fake_batch(rng)

    def grads(cfg):
        params = memn2n.init_params(cfg, dims, jax.random.PRNGKey(0))
        def loss(p):
            l, _ = memn2n.loss_and_metrics(p, mem, que, ans, mask, None,
                                           cfg)
            return l
        return {k: np.asarray(v)
                for k, v in jax.grad(loss)(params).items()}

    m3 = tiny_cfg(attention_mode=3)
    g0 = grads(m3)
    g1 = grads(m3.replace(en_grad_quant=True))
    for k in g0:
        np.testing.assert_array_equal(g0[k], g1[k], err_msg=k)
    m2 = tiny_cfg(attention_mode=2)
    g2 = grads(m2)
    g3 = grads(m2.replace(en_grad_quant=True))
    assert any(not np.array_equal(g2[k], g3[k]) for k in g2)


def test_mode1_en_grad_quant_reaches_score_backward(rng):
    """Mode-1 layers run FLOAT forwards, but under EN_GRAD_QUANT with the
    layer fixed their score/weighted-sum backwards quantize
    (lib/layer.c:539-575 threads dot->f_fixed for modes 1 and 2) — the
    flag must survive the attention_score dispatch."""
    dims = fake_dims()
    mem, que, ans, mask = fake_batch(rng)
    cfg = tiny_cfg(attention_mode=1)   # en_fixed_point default True

    def grads(c):
        params = memn2n.init_params(c, dims, jax.random.PRNGKey(0))
        def loss(p):
            l, _ = memn2n.loss_and_metrics(p, mem, que, ans, mask, None, c)
            return l
        return {k: np.asarray(v) for k, v in jax.grad(loss)(params).items()}

    g0 = grads(cfg)
    g1 = grads(cfg.replace(en_grad_quant=True))
    assert any(not np.array_equal(g0[k], g1[k]) for k in g0)


def test_mode1_wsum_runs_float_forward(rng):
    """Mode-1 dot_mat_vec layers (score AND weighted sum) run FLOAT
    forwards regardless of EN_FIXED_POINT — the reference fwd dispatch
    hardcodes f_fixed=false for mode 1 (lib/layer.c:188) — while the
    dense/embedding layers stay quantized.  Changing en_fixed_point in
    mode 1 must still change logits (embeddings quantize) but the
    attention probabilities must match a float-weighted-sum composition."""
    from qmann_tpu.ops import softmax, qweighted_sum, qscore
    dims = fake_dims()
    mem, que, ans, mask = fake_batch(rng)
    cfg = tiny_cfg(attention_mode=1, num_hops=1, en_linear_mapping=False)
    params = memn2n.init_params(cfg, dims, jax.random.PRNGKey(0))
    params = {k: v * 6.0 for k, v in params.items()}
    out = memn2n.forward(params, mem, que, mask, cfg)
    # recompute hop 0 by hand with a FLOAT weighted sum
    from qmann_tpu.ops import qmatvec, qembed_mat
    u = qmatvec(params["B"], que, cfg.fmt_w[0], cfg.fmt_w[0],
                quantized=True, integer_inputs=True)
    m_e = qembed_mat(mem, params["A"], cfg.fmt_w[0], quantized=True,
                     integer_inputs=True)
    c_e = qembed_mat(mem, params["C"], cfg.fmt_w[0], quantized=True,
                     integer_inputs=True)
    s = qscore(m_e, u, cfg.fmt_att[0], cfg.fmt_bin, quantized=False)
    p = softmax(s, mask)
    o = qweighted_sum(c_e, p, mask.astype(jnp.float32), cfg.fmt_act[0],
                      quantized=False)
    from qmann_tpu.ops import qsum
    u1 = qsum(u, o, cfg.fmt_act[0], quantized=True)
    logits = qmatvec(params["W"], u1, cfg.fmt_ds_ans, cfg.fmt_ds_ans,
                     quantized=False)
    np.testing.assert_array_equal(np.asarray(out.logits),
                                  np.asarray(logits))


def test_forward_adjacent_tying_shapes(rng):
    cfg = tiny_cfg(type_weight_tying=1)
    dims = fake_dims()
    params = memn2n.init_params(cfg, dims, jax.random.PRNGKey(0))
    assert params["E"].shape == (4, 8, 20)
    mem, que, ans, mask = fake_batch(rng)
    out = memn2n.forward(params, mem, que, mask, cfg)
    assert out.logits.shape == (5, 20)


def test_forward_float_mode_is_standard_memn2n(rng):
    """en_fixed_point=False + mode 1 must be an ordinary float MemN2N
    whose logits autodiff cleanly."""
    cfg = tiny_cfg(attention_mode=1, en_fixed_point=False)
    dims = fake_dims()
    params = memn2n.init_params(cfg, dims, jax.random.PRNGKey(0))
    mem, que, ans, mask = fake_batch(rng)
    loss, met = memn2n.loss_and_metrics(params, mem, que, ans, mask, None, cfg)
    grads = jax.grad(lambda p: memn2n.loss_and_metrics(
        p, mem, que, ans, mask, None, cfg)[0])(params)
    for k, g in grads.items():
        assert np.isfinite(np.asarray(g)).all(), k


def test_padded_rows_do_not_affect_output(rng):
    """Garbage in padded memory rows must not change anything (mask
    correctness), including in binary mode where quant(0) = +1."""
    for cfg in [tiny_cfg(), tiny_cfg(binary_mode=True)]:
        dims = fake_dims()
        params = memn2n.init_params(cfg, dims, jax.random.PRNGKey(0))
        mem, que, ans, mask = fake_batch(rng)
        out1 = memn2n.forward(params, mem, que, mask, cfg)
        garbage = jnp.where(mask[:, :, None], mem,
                            jnp.float32(7.0))  # trash the padded rows
        out2 = memn2n.forward(params, garbage, que, mask, cfg)
        np.testing.assert_array_equal(np.asarray(out1.logits),
                                      np.asarray(out2.logits))


def test_lr_schedule_decay_points():
    cfg = QmannConfig(num_itr=100, rate_decay_step=25, learning_rate=0.3)
    lrs = {itr: lr for itr, lr, _ in lr_schedule(cfg)}
    assert lrs[0] == 0.3 and lrs[24] == 0.3
    assert lrs[25] == 0.15 and lrs[49] == 0.15
    assert lrs[50] == 0.075 and lrs[75] == 0.0375


def test_lr_schedule_linear_start():
    cfg = QmannConfig(num_itr=40, en_linear_start=True,
                      num_itr_linear_start=5, rate_decay_step=25,
                      learning_rate=0.3)
    sched = list(lr_schedule(cfg))
    for itr, lr, removed in sched[:5]:
        assert removed and lr == 0.15
    itr5 = sched[5]
    assert itr5[1] == 0.3 and not itr5[2]
    assert sched[30][1] == 0.15  # decay at itr = nls + 25


def test_sgd_clip_uses_rowsum_norm():
    cfg = QmannConfig(max_grad_l2_norm=2.0)
    w = {"A": jnp.zeros((3, 4)), "C": jnp.zeros((3, 4)),
         "B": jnp.zeros((3, 4)), "W": jnp.zeros((4, 3)),
         "H": jnp.zeros((3, 3))}
    g = {k: jnp.ones_like(v) for k, v in w.items()}
    # rowsum norm of ones (3,4) = 3*2 = 6 > 2 -> scale 1/3
    out = sgd_update(w, g, jnp.float32(1.0), jnp.float32(1.0), cfg)
    np.testing.assert_allclose(np.asarray(out["A"]), -1.0 / 3.0, rtol=1e-6)
    # H uses threshold max/2=1 (rowsum=3*sqrt(3)) and lr*0.1
    want_h = -0.1 * (1.0 / (3 * np.sqrt(3)))
    np.testing.assert_allclose(np.asarray(out["H"]), want_h, rtol=1e-5)
    assert float(rowsum_l2_norm(g["A"])) == 6.0


def test_zero_null_columns():
    cfg = QmannConfig()
    p = {"A": jnp.ones((3, 4)), "C": jnp.ones((3, 4)), "B": jnp.ones((3, 4)),
         "W": jnp.ones((4, 3)), "H": jnp.ones((3, 3))}
    out = zero_null_columns(p, cfg)
    assert (np.asarray(out["A"])[:, 0] == 0).all()
    assert (np.asarray(out["C"])[:, 0] == 0).all()
    assert (np.asarray(out["B"])[:, 0] == 1).all()  # emb_q NOT zeroed
    assert (np.asarray(out["W"]) == 1).all()


@pytest.mark.slow
def test_qa1_convergence_smoke_float(qa1_dir):
    """End-to-end: the float model must essentially solve a qa1 subset in a
    few epochs (it reaches 100% train accuracy by ~epoch 9)."""
    cfg = QmannConfig(num_itr=10, verbose=False, attention_mode=1,
                      en_fixed_point=False)
    data = load_task(QA1, qa1_dir, limit_train=2000, limit_test=200)
    res = train_task(cfg, data)
    assert res.history[-1].err_train < 0.1
    assert res.err_test < 0.5


@pytest.mark.slow
def test_qa1_convergence_smoke_hamming(qa1_dir):
    """Hamming attention (mode 3) with its surrogate gradient must train:
    at iwl=1 (Q1.6, the sweep_fixed.sh regime where mode 3 is the paper's
    winner) train error must clearly improve within a few epochs."""
    cfg = QmannConfig(num_itr=6, verbose=False, attention_mode=3, iwl=1)
    data = load_task(QA1, qa1_dir, limit_train=2000, limit_test=200)
    res = train_task(cfg, data)
    assert res.history[-1].err_train < 0.85
    assert res.history[-1].err_train < res.history[0].err_train


@pytest.mark.slow
def test_qa1_convergence_smoke_quantized(qa1_dir):
    """Quantized Q5.2 (the run.sh default) learns more slowly — its
    quantization step is 0.25 — but must clearly beat chance (~5%) within
    a few epochs."""
    cfg = QmannConfig(num_itr=6, verbose=False)
    data = load_task(QA1, qa1_dir, limit_train=2000, limit_test=200)
    res = train_task(cfg, data)
    assert res.history[-1].err_train < 0.85
    assert res.history[-1].err_train < res.history[0].err_train


def test_train_fast_path_off_is_bit_identical(rng):
    """The gradient step is bit-identical with and without the runtime
    integer-fast-path conds (the fast branch equals the lattice exactly
    whenever its predicate holds — tests/test_ops.py), so train_epoch
    compiling them out (a 60.1 -> 23.3 ms/epoch device-time win,
    runs/trace_r4_train_fp_{on,off}.log) cannot change training."""
    cfg_on = tiny_cfg(en_integer_fast_path=True)
    cfg_off = cfg_on.replace(en_integer_fast_path=False)
    dims = fake_dims()
    params = memn2n.init_params(cfg_on, dims, jax.random.PRNGKey(0))
    mem, que, ans, mask = fake_batch(rng)
    smask = jnp.ones(mem.shape[0], jnp.float32)

    def grads(cfg):
        def loss_fn(p):
            loss, met = memn2n.loss_and_metrics(p, mem, que, ans, mask,
                                                smask, cfg, False)
            return loss, met
        g, met = jax.grad(loss_fn, has_aux=True)(params)
        return g, met

    g_on, met_on = grads(cfg_on)
    g_off, met_off = grads(cfg_off)
    np.testing.assert_array_equal(np.asarray(met_on.cost),
                                  np.asarray(met_off.cost))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), np.asarray(b)), g_on, g_off)


def test_device_shuffle_pack_matches_host():
    """_pack_shuffled (device-side epoch shuffle, [N]-perm upload only)
    produces exactly the batches _batched_arrays builds from the
    host-permuted split."""
    from qmann_tpu.data.babi import VectorizedSplit
    from qmann_tpu.train.trainer import _batched_arrays, _pack_shuffled
    r = np.random.default_rng(0)
    n, m, d = 11, 4, 9
    split = VectorizedSplit(
        r.random((n, m, d)).astype(np.float32),
        r.random((n, d)).astype(np.float32),
        r.random((n, d)).astype(np.float32),
        r.integers(1, m + 1, n).astype(np.int32),
        r.integers(0, d, n).astype(np.int32))
    perm = r.permutation(n)
    host = _batched_arrays(VectorizedSplit(
        split.memory[perm], split.question[perm], split.answer[perm],
        split.n_sen[perm], split.answer_index[perm]), 4)
    dev = _pack_shuffled(jnp.asarray(split.memory),
                         jnp.asarray(split.question),
                         jnp.asarray(split.answer),
                         jnp.asarray(split.mask),
                         jnp.asarray(perm), 4)
    for k in ("memory", "question", "answer", "mask"):
        np.testing.assert_array_equal(host[k], np.asarray(dev[k]), err_msg=k)


def test_eval_split_chunk_padding_is_exact(rng):
    """eval_split pads every chunk to the static chunk size (one compiled
    evaluate shape per run); cost/err/preds must equal the unpadded
    computation."""
    from qmann_tpu.data.babi import VectorizedSplit
    from qmann_tpu.train.trainer import eval_split
    cfg = tiny_cfg()
    dims = fake_dims()
    params = memn2n.init_params(cfg, dims, jax.random.PRNGKey(1))
    mem, que, ans, mask = fake_batch(rng, n=23)
    n_sen = np.asarray(mask).sum(axis=1).astype(np.int32)
    aidx = np.argmax(np.asarray(ans), axis=1).astype(np.int32)
    split = VectorizedSplit(np.asarray(mem), np.asarray(que),
                            np.asarray(ans), n_sen, aidx)
    # exact-fit chunks vs padded chunks (23 -> chunks of 10: 10/10/3+7pad)
    c_exact, e_exact, p_exact = eval_split(params, split, cfg, chunk=23)
    c_pad, e_pad, p_pad = eval_split(params, split, cfg, chunk=10)
    assert e_exact == e_pad
    np.testing.assert_allclose(c_exact, c_pad, rtol=1e-6)
    np.testing.assert_array_equal(p_exact, p_pad)
