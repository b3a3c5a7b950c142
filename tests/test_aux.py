"""Auxiliary subsystem tests: verification harness, similarity analysis,
maxout-attention trial, cosine similarity, gradient quantization,
checkpoint round trip, reporting."""
import os

import pytest

import numpy as np
import jax
import jax.numpy as jnp

from qmann_tpu.config import QmannConfig
from qmann_tpu.data import DataDims, Dictionary, Sample, compute_dims
from qmann_tpu.models import memn2n
from qmann_tpu.models.maxout import maxout_attention, maxout_unit
from qmann_tpu.numerics import QFormat
from qmann_tpu.train import train_epoch
from qmann_tpu.train.trainer import _batched_arrays
from qmann_tpu.utils.analysis import SimilarityAnalyzer
from qmann_tpu.utils.checkpoint import load_checkpoint, save_checkpoint
from qmann_tpu.utils.verification import (
    compare, overflow_stats, verify_model_quantization,
)
from qmann_tpu.data.babi import VectorizedSplit


def _case(rng, n=6, m=5, dim_input=18):
    dims = DataDims(dim_dict=dim_input - m, max_line=m, max_word=5,
                    dim_word=6, dim_input=dim_input)
    mem = rng.integers(0, 2, (n, m, dim_input)).astype(np.float32)
    que = rng.integers(0, 2, (n, dim_input)).astype(np.float32)
    ans = np.zeros((n, dim_input), np.float32)
    ans[np.arange(n), rng.integers(1, dim_input, n)] = 1.0
    n_sen = rng.integers(1, m + 1, n)
    mask = np.arange(m)[None, :] < n_sen[:, None]
    mem *= mask[:, :, None]
    return dims, mem, que, ans, mask


def test_verify_model_quantization_reports(rng):
    cfg = QmannConfig(dim_emb=8, verbose=False)
    dims, mem, que, ans, mask = _case(rng)
    res = verify_model_quantization(
        cfg, dims, (jnp.asarray(mem), jnp.asarray(que), jnp.asarray(mask)))
    assert len(res) == 2
    assert res[1].total == 6


def test_overflow_stats():
    s = overflow_stats(np.array([0.1, 100.0, 0.01, -50.0], np.float32),
                       QFormat(5, 2))
    assert s["saturated"] == 0.5
    assert s["underflow_to_zero"] == 0.5
    assert s["max_abs"] == 100.0


def test_similarity_analyzer_writes_buckets(tmp_path, rng):
    an = SimilarityAnalyzer(str(tmp_path))
    scores = rng.normal(0, 1, (3, 2, 4)).astype(np.float32)
    attn = rng.random((3, 2, 4)).astype(np.float32)
    mask = np.array([[1, 1, 1, 0], [1, 1, 0, 0]], bool)
    an.record(epoch=0, scores=scores, attention=attn, mask=mask)
    an.record(epoch=30, scores=scores, attention=attn, mask=mask)
    f0 = (tmp_path / "softmax_input_0to24.csv").read_text()
    f1 = (tmp_path / "softmax_input_25to49.csv").read_text()
    assert len(f0.splitlines()) == 6  # 2 samples x 3 hops
    assert len(f1.splitlines()) == 6
    # row format: epoch,sample,hop,scores(live only)
    first = f0.splitlines()[0].split(",")
    assert first[:3] == ["0", "0", "0"] and len(first) == 3 + 3


def test_maxout_unit_and_attention():
    w = jnp.asarray([1.0, -1.0], jnp.float32)
    b = jnp.asarray([0.0, 0.5], jnp.float32)
    # max(x, -x+0.5)
    np.testing.assert_allclose(
        np.asarray(maxout_unit(jnp.asarray([2.0, 0.0]), w, b)), [2.0, 0.5])
    scores = jnp.asarray([[1.0, 2.0, 3.0]], jnp.float32)
    mask = jnp.asarray([[True, True, False]])
    p = maxout_attention(scores, w, b, mask)
    np.testing.assert_allclose(np.asarray(p), [[1 / 3, 2 / 3, 0.0]],
                               rtol=1e-6)


def test_maxout_model_trains(rng):
    cfg = QmannConfig(dim_emb=8, verbose=False, test_maxout=True,
                      attention_mode=1, en_fixed_point=False)
    dims, mem, que, ans, mask = _case(rng)
    params = memn2n.init_params(cfg, dims, jax.random.PRNGKey(0))
    assert "maxout_w" in params
    split = VectorizedSplit(mem, que, ans,
                            mask.sum(1).astype(np.int32),
                            np.argmax(ans, 1).astype(np.int32))
    batches = {k: jnp.asarray(v) for k, v in _batched_arrays(split, 3).items()}
    p2, cost, matches = train_epoch(params, batches, jnp.float32(0.1), cfg)
    assert np.isfinite(float(cost))
    for k, v in p2.items():
        assert np.isfinite(np.asarray(v)).all(), k


def test_cosine_sim_forward(rng):
    cfg = QmannConfig(dim_emb=8, verbose=False, en_cosine_sim=True)
    dims, mem, que, ans, mask = _case(rng)
    params = memn2n.init_params(cfg, dims, jax.random.PRNGKey(0))
    out = memn2n.forward(params, jnp.asarray(mem), jnp.asarray(que),
                         jnp.asarray(mask), cfg)
    assert np.isfinite(np.asarray(out.logits)).all()


@pytest.mark.parametrize("placement", ["backward", "update"])
def test_grad_quant_capability(rng, placement):
    """EN_GRAD_QUANT in both placements: 'backward' (the reference's
    f_fixed threading — quantized dot_mat_vec bwd contractions) and
    'update' (single-point batch-grad quantize).  Both must train
    finitely and differ from the unquantized gradient step."""
    cfg = QmannConfig(dim_emb=8, verbose=False, en_grad_quant=True,
                      grad_quant_placement=placement)
    dims, mem, que, ans, mask = _case(rng)
    params = memn2n.init_params(cfg, dims, jax.random.PRNGKey(0))
    split = VectorizedSplit(mem, que, ans, mask.sum(1).astype(np.int32),
                            np.argmax(ans, 1).astype(np.int32))
    batches = {k: jnp.asarray(v) for k, v in _batched_arrays(split, 3).items()}
    p2, cost, _ = train_epoch(params, batches, jnp.float32(0.3), cfg)
    assert np.isfinite(float(cost))
    p_plain, _, _ = train_epoch(params, batches, jnp.float32(0.3),
                                cfg.replace(en_grad_quant=False))
    assert any(not np.array_equal(np.asarray(p2[k]), np.asarray(p_plain[k]))
               for k in p2)


def test_checkpoint_roundtrip(tmp_path, rng):
    cfg = QmannConfig(dim_emb=8, verbose=False)
    dims, *_ = _case(rng)
    params = memn2n.init_params(cfg, dims, jax.random.PRNGKey(0))
    d = Dictionary.build([Sample([["a"]], ["b"], ["c"])])
    path = save_checkpoint(str(tmp_path), params, cfg, dims, tag="t",
                           dictionary=d)
    loaded, cfg2, dims2 = load_checkpoint(path)
    assert cfg2 == cfg
    for k in params:
        np.testing.assert_array_equal(loaded[k], np.asarray(params[k]))
    fixed, _, _ = load_checkpoint(path, fixed=True)
    # fixed weights lie on their Q-format grids
    step = 2.0 ** -cfg.fmt_w[0].frac
    a = fixed["A"]
    np.testing.assert_allclose(a, np.round(a / step) * step, atol=1e-7)
    assert os.path.exists(os.path.join(path, "dictionary.json"))


def test_similarity_analysis_in_trainer(tmp_path, qa1_dir):
    from qmann_tpu.data import load_task
    from qmann_tpu.train import train_task
    cfg = QmannConfig(num_itr=2, verbose=False, en_similarity_analysis=True,
                      similarity_analysis_dir=str(tmp_path))
    data = load_task("qa1_single-supporting-fact", qa1_dir,
                     limit_train=100, limit_test=20)
    train_task(cfg, data)
    content = (tmp_path / "softmax_input_0to24.csv").read_text()
    assert len(content.splitlines()) > 0


def test_similarity_probe_vs_full_dump(tmp_path, qa1_dir):
    """similarity_probe_size=0 dumps the FULL validation split per epoch
    (the reference's per-sample fidelity); a probe-N dump is exactly its
    first N samples' rows."""
    from qmann_tpu.data import load_task
    from qmann_tpu.train import train_task
    data = load_task("qa1_single-supporting-fact", qa1_dir,
                     limit_train=100, limit_test=20)
    n_valid = len(data.valid)
    assert n_valid > 4
    base = QmannConfig(num_itr=1, verbose=False, en_similarity_analysis=True)
    train_task(base.replace(similarity_analysis_dir=str(tmp_path / "full"),
                            similarity_probe_size=0), data)
    train_task(base.replace(similarity_analysis_dir=str(tmp_path / "probe"),
                            similarity_probe_size=4), data)
    full = (tmp_path / "full" / "softmax_input_0to24.csv").read_text()
    probe = (tmp_path / "probe" / "softmax_input_0to24.csv").read_text()
    K = base.num_hops
    assert len(full.splitlines()) == n_valid * K
    assert len(probe.splitlines()) == 4 * K
    # the probe rows are exactly the full dump's first-4-sample rows
    # (same params: both runs train identically from the same seed)
    full_first4 = [l for l in full.splitlines()
                   if int(l.split(",")[1]) < 4]
    assert probe.splitlines() == full_first4
    # global sample numbering survives the chunked full dump
    assert {int(l.split(",")[1]) for l in full.splitlines()} == set(
        range(n_valid))


def test_optimizer_variants_finite(rng):
    import jax.numpy as jnp
    from qmann_tpu.train.optim import (
        adamax_update, rmsprop_update, sgd_momentum_update,
    )
    cfg = QmannConfig(verbose=False)
    p = {"A": jnp.ones((3, 4)), "C": jnp.ones((3, 4)), "B": jnp.ones((3, 4)),
         "W": jnp.ones((4, 3)), "H": jnp.ones((3, 3))}
    g = {k: jnp.full_like(v, 0.5) for k, v in p.items()}
    zeros = {k: jnp.zeros_like(v) for k, v in p.items()}
    p1, v = sgd_momentum_update(p, g, zeros, jnp.float32(0.1),
                                jnp.float32(4.0), cfg)
    p2, m = rmsprop_update(p, g, zeros, jnp.float32(0.1), jnp.float32(4.0),
                           cfg)
    p3, st = adamax_update(p, g, (zeros, zeros), jnp.float32(0.1),
                           jnp.float32(4.0), cfg, t=1)
    for pp in (p1, p2, p3):
        for k, val in pp.items():
            assert np.isfinite(np.asarray(val)).all(), k
            assert not np.array_equal(np.asarray(val), np.asarray(p[k]))


def test_optimizer_variants_match_reference_recurrences(rng):
    """Pin the three commented-reference optimizer recurrences
    (lib/layer.c:2277-2375) against a numpy oracle over several steps:
      momentum: v=0.9v+lr/m*g; w=w-v+lr*lam*w      (:2322-2330)
      rmsprop:  a=0.9a+0.1g^2; w=w-lr/m*g/sqrt(a)+lr*lam*w  (:2365-2375)
      adamax:   m=b1*m+(1-b1)g; v=max(b2*v,|g|); w=w-lr/(1-b1)*m/v
                (constant denominator, NOT b1^t-corrected; :2277-2318)"""
    import jax.numpy as jnp
    from qmann_tpu.train.optim import (
        adamax_update, rmsprop_update, sgd_momentum_update,
    )
    cfg = QmannConfig(verbose=False, lambda_=0.01)
    lr, m = 0.1, 4.0
    w0 = rng.normal(0, 1, (3, 4)).astype(np.float32)
    gs = [rng.normal(0, 1, (3, 4)).astype(np.float32) for _ in range(3)]

    # momentum
    p, v = {"A": jnp.asarray(w0)}, {"A": jnp.zeros((3, 4))}
    w_ref, v_ref = w0.copy(), np.zeros((3, 4), np.float32)
    for g in gs:
        p, v = sgd_momentum_update(p, {"A": jnp.asarray(g)}, v,
                                   jnp.float32(lr), jnp.float32(m), cfg)
        v_ref = 0.9 * v_ref + lr / m * g
        w_ref = w_ref - v_ref + lr * cfg.lambda_ * w_ref
    np.testing.assert_allclose(np.asarray(p["A"]), w_ref, rtol=1e-5)

    # rmsprop
    eps = 1e-8
    p, acc = {"A": jnp.asarray(w0)}, {"A": jnp.zeros((3, 4))}
    w_ref, a_ref = w0.copy(), np.zeros((3, 4), np.float32)
    for g in gs:
        p, acc = rmsprop_update(p, {"A": jnp.asarray(g)}, acc,
                                jnp.float32(lr), jnp.float32(m), cfg)
        a_ref = 0.9 * a_ref + 0.1 * g * g
        w_ref = (w_ref - lr / m * g / (np.sqrt(a_ref) + eps)
                 + lr * cfg.lambda_ * w_ref)
    np.testing.assert_allclose(np.asarray(p["A"]), w_ref, rtol=1e-5)

    # adamax
    b1, b2 = 0.9, 0.999
    p = {"A": jnp.asarray(w0)}
    st = ({"A": jnp.zeros((3, 4))}, {"A": jnp.zeros((3, 4))})
    w_ref = w0.copy()
    m_ref, u_ref = np.zeros((3, 4), np.float32), np.zeros((3, 4), np.float32)
    for g in gs:
        p, st = adamax_update(p, {"A": jnp.asarray(g)}, st,
                              jnp.float32(lr), jnp.float32(m), cfg)
        m_ref = b1 * m_ref + (1 - b1) * g
        u_ref = np.maximum(b2 * u_ref, np.abs(g))
        w_ref = w_ref - lr / (1 - b1) * m_ref / (u_ref + eps)
    np.testing.assert_allclose(np.asarray(p["A"]), w_ref, rtol=1e-5)


def test_optimizer_variants_converge_on_least_squares(rng):
    """Each shipped optimizer capability must actually optimize: drive a
    small least-squares problem and require a large loss reduction."""
    import jax
    import jax.numpy as jnp
    from qmann_tpu.train.optim import (
        adamax_update, rmsprop_update, sgd_momentum_update,
    )
    cfg = QmannConfig(verbose=False)
    X = jnp.asarray(rng.normal(0, 1, (16, 4)).astype(np.float32))
    w_true = jnp.asarray(rng.normal(0, 1, (4, 2)).astype(np.float32))
    Y = X @ w_true

    def loss(p):
        return 0.5 * jnp.sum((X @ p["A"] - Y) ** 2)

    grad = jax.grad(loss)
    m = jnp.float32(16.0)
    for opt, state, lr in (
            ("momentum", {"A": jnp.zeros((4, 2))}, 0.05),
            ("rmsprop", {"A": jnp.zeros((4, 2))}, 0.5),
            ("adamax", ({"A": jnp.zeros((4, 2))},
                        {"A": jnp.zeros((4, 2))}), 0.05)):
        p = {"A": jnp.zeros((4, 2))}
        l0 = float(loss(p))
        for _ in range(60):
            g = grad(p)
            if opt == "momentum":
                p, state = sgd_momentum_update(p, g, state, jnp.float32(lr),
                                               m, cfg)
            elif opt == "rmsprop":
                p, state = rmsprop_update(p, g, state, jnp.float32(lr), m,
                                          cfg)
            else:
                p, state = adamax_update(p, g, state, jnp.float32(lr), m,
                                         cfg)
        assert float(loss(p)) < 0.05 * l0, opt


def test_squared_error_matches_reference_semantics(rng):
    """se layer (se_run, lib/layer.c:3607-3622): cost sum((h-y)^2/2),
    gradient h-y."""
    import jax
    from qmann_tpu.ops.losses import squared_error
    h = rng.normal(0, 1, (7,)).astype(np.float32)
    y = rng.normal(0, 1, (7,)).astype(np.float32)
    cost = squared_error(jnp.asarray(h), jnp.asarray(y))
    np.testing.assert_allclose(float(cost), np.sum((h - y) ** 2 / 2.0),
                               rtol=1e-6)
    g = jax.grad(lambda a: squared_error(a, jnp.asarray(y)))(jnp.asarray(h))
    np.testing.assert_allclose(np.asarray(g), h - y, rtol=1e-6)


def test_bench_compare_renders_table(tmp_path, capsys):
    import json
    from qmann_tpu.bench.compare import main as compare_main
    a = tmp_path / "sweep_a"
    b = tmp_path / "sweep_b"
    a.mkdir(), b.mkdir()
    (a / "summary.json").write_text(json.dumps(
        [{"iwl": 0, "task": 1, "err_test_avg": 0.7},
         {"iwl": 0, "task": 2, "err_test_avg": 0.5}]))
    (b / "summary.json").write_text(json.dumps(
        [{"iwl": 0, "task": 1, "err_test_avg": 0.4}]))
    assert compare_main([str(a), str(b), "--labels", "m2,m3"]) == 0
    out = capsys.readouterr().out
    assert "| m2 | m3 |" in out
    assert "| 0 | 1 | 0.700 | 0.400 |" in out
    assert "| 0 | 2 | 0.500 | — |" in out      # missing cell renders as —
    # means are computed over the INTERSECTION of covered tasks (here only
    # task 1) so unevenly-covered sweeps stay comparable, with n shown
    assert "| | mean (n=1 common) | 0.7000 | 0.4000 |" in out
    # mismatched --labels count is an argparse error, not a silent mis-table
    import pytest
    with pytest.raises(SystemExit):
        compare_main([str(a), str(b), "--labels", "only-one"])
