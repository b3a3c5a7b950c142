"""Regression tests for the code-review findings."""
import os

import numpy as np
import pytest
import jax.numpy as jnp

from qmann_tpu.config import QmannConfig
from qmann_tpu.data import load_task
from qmann_tpu.data.native import load_task_native, native_available
from qmann_tpu.numerics import QFormat, ROUND_UP, encode_sign_magnitude
from qmann_tpu.train.optim import lr_schedule

# the reference's bAbI release (MemN2N/dataset), where present
DATASET = os.environ.get("QMANN_BABI_DATASET", "")
PARSED = os.path.join(DATASET, "en_10k_parsed")
RAW = os.path.join(DATASET, "tasks_1-20_v1-2", "en-10k")
needs_data = pytest.mark.skipif(
    not os.path.isdir(PARSED),
    reason="bAbI release not present (QMANN_BABI_DATASET)")


@needs_data
@pytest.mark.parametrize("loader", [load_task, load_task_native])
def test_test_stories_longer_than_train_max_line(loader):
    """qa2 with a tiny train subset: test stories exceed the train-derived
    max_line; both loaders must truncate to the most recent sentences
    (MemN2N/MemN2N.c:585) instead of crashing / keeping the oldest."""
    if loader is load_task_native and not native_available():
        pytest.skip("native lib missing")
    td = loader("qa2_two-supporting-facts", PARSED, raw_path=RAW,
                limit_train=30, limit_test=60)
    assert (td.test.n_sen <= td.dims.max_line).all()
    # every live row carries exactly one temporal-encoding bit in range
    te_block = td.test.memory[:, :, td.dims.dim_dict:]
    live = td.test.mask
    assert (te_block.sum(-1)[live] == 1.0).all()


@needs_data
def test_python_and_native_agree_on_truncated_test(rng):
    if not native_available():
        pytest.skip("native lib missing")
    py = load_task("qa2_two-supporting-facts", PARSED, raw_path=RAW,
                   limit_train=30, limit_test=60)
    nat = load_task_native("qa2_two-supporting-facts", PARSED, raw_path=RAW,
                           limit_train=30, limit_test=60)
    np.testing.assert_array_equal(py.test.memory, nat.test.memory)
    np.testing.assert_array_equal(py.test.n_sen, nat.test.n_sen)


def test_linear_start_extends_total_epochs():
    """MemN2N/MemN2N.c:1039: num_itr = NUM_ITR + NUM_ITR_LINEAR_START."""
    cfg = QmannConfig(num_itr=10, en_linear_start=True,
                      num_itr_linear_start=5)
    sched = list(lr_schedule(cfg))
    assert len(sched) == 15
    assert sum(1 for _, _, removed in sched if removed) == 5
    cfg2 = QmannConfig(num_itr=10, en_linear_start=False)
    assert len(list(lr_schedule(cfg2))) == 10


def test_hi_lo_carry_round_up():
    """ROUND_UP at frac>24 can round the low half to 65536; the carry must
    propagate into the high half (was OR'd, corrupting the magnitude)."""
    fmt = QFormat(0, 31, ROUND_UP)
    x = jnp.float32(131071.5 / 2**31)  # low half rounds up to 65536
    _, mag = encode_sign_magnitude(x, fmt)
    assert int(mag) == 0x20000


def test_engine_survives_inference_failure():
    import jax
    from qmann_tpu.data import DataDims, Dictionary, Sample, compute_dims
    from qmann_tpu.models import memn2n
    from qmann_tpu.serve import InferenceEngine
    samples = [Sample([["a", "b"]], ["a"], ["b"])]
    d = Dictionary.build(samples)
    dims = compute_dims(samples, d)
    cfg = QmannConfig(dim_emb=8, verbose=False)
    params = memn2n.init_params(cfg, dims, jax.random.PRNGKey(0))
    eng = InferenceEngine(params, cfg, dims, d, batch_size=2,
                          max_wait_ms=1.0).start()
    try:
        # break one wave
        original = eng._infer
        eng._infer = lambda *a: (_ for _ in ()).throw(RuntimeError("boom"))
        bad = eng.submit([["a", "b"]], ["a"])
        with pytest.raises(RuntimeError):
            bad.result(timeout=30)
        # engine must still serve subsequent requests
        eng._infer = original
        good = eng.submit([["a", "b"]], ["a"])
        assert isinstance(good.result(timeout=60), int)
    finally:
        eng.stop()


def test_engine_honors_transmitted_te_indices():
    import jax
    from qmann_tpu.data import Dictionary, Sample, compute_dims
    from qmann_tpu.models import memn2n
    from qmann_tpu.serve import InferenceEngine
    samples = [Sample([["a", "b"], ["c", "d"]], ["a"], ["b"])]
    d = Dictionary.build(samples)
    dims = compute_dims(samples, d)
    cfg = QmannConfig(dim_emb=8, verbose=False)
    params = memn2n.init_params(cfg, dims, jax.random.PRNGKey(0))
    eng = InferenceEngine(params, cfg, dims, d, batch_size=1)
    from qmann_tpu.serve.engine import Request
    custom_te = [dims.dim_dict + 1, dims.dim_dict]
    mem, _, _ = eng._vectorize([Request([["a", "b"], ["c", "d"]], ["a"],
                                        te_indices=custom_te)])
    assert mem[0, 0, custom_te[0]] == 1.0
    assert mem[0, 1, custom_te[1]] == 1.0


@pytest.mark.parametrize("iwl", [0, 7])
def test_en_mq_extreme_operating_points_stay_valid(iwl):
    """sweep_fixed.sh runs iwl=0 with EN_MQ on; the reference's unsigned
    arithmetic underflows there (iwl_w[2] = 0-1 wraps to UINT_MAX).  The
    config must clamp to valid formats and the model must run."""
    import jax
    from qmann_tpu.data import DataDims
    from qmann_tpu.models import memn2n
    cfg = QmannConfig(iwl=iwl, dim_emb=8, num_hops=3, verbose=False)
    for f in cfg.fmt_w:
        assert f.iwl >= 0 and f.frac >= 0 and f.iwl + f.frac <= 31
    dims = DataDims(dim_dict=10, max_line=4, max_word=4, dim_word=5,
                    dim_input=14)
    params = memn2n.init_params(cfg, dims, jax.random.PRNGKey(0))
    mem = jnp.zeros((2, 4, 14), jnp.float32)
    que = jnp.ones((2, 14), jnp.float32)
    mask = jnp.ones((2, 4), bool)
    out = memn2n.forward(params, mem, que, mask, cfg)
    assert np.isfinite(np.asarray(out.logits)).all()
