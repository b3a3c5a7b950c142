"""train.multi: the vmapped (tasks x seeds) family trainer must reproduce
trainer.train_task run-for-run (same seed -> same init -> same SGD
trajectory; the only deviations are documented: no early-stop break,
chunked-but-exact validation)."""
import numpy as np
import pytest

from qmann_tpu.config import QmannConfig
from qmann_tpu.data import load_task
from qmann_tpu.train import train_task
from qmann_tpu.train.multi import train_tasks_multi

from qmann_tpu.data.synth import TASK as QA1, ensure_qa1


def small_cfg(**kw):
    base = dict(num_itr=3, verbose=False, en_save_best_model=True)
    base.update(kw)
    return QmannConfig(**base)


def load_small(seed=0, limit=256):
    """Seeded qa1 (qmann_tpu.data.synth); two seeds stand in for two
    tasks of one padded layout."""
    return load_task(QA1, ensure_qa1(seed), limit_train=limit,
                     limit_test=64, pad_dict=64, pad_line=50)


@pytest.mark.slow
def test_single_run_matches_train_task():
    cfg = small_cfg(seed=3)
    data = load_small()
    ref = train_task(cfg, data)
    res = train_tasks_multi(cfg, {1: data}, seeds=[3], eval_chunk=16)
    assert res.task_indices == [1] and res.seeds == [3]
    for e, h in enumerate(ref.history):
        np.testing.assert_allclose(res.history[e]["cost_train"][0],
                                   h.cost_train, rtol=2e-4)
        np.testing.assert_allclose(res.history[e]["err_train"][0],
                                   h.err_train, atol=1e-6)
        np.testing.assert_allclose(res.history[e]["cost_valid"][0],
                                   h.cost_valid, rtol=2e-4)
        np.testing.assert_allclose(res.history[e]["err_valid"][0],
                                   h.err_valid, atol=1e-6)
    np.testing.assert_allclose(res.err_test[0], ref.err_test, atol=1e-6)


@pytest.mark.slow
def test_family_matches_per_run_training():
    """Two tasks with DIFFERENT train sizes (exercising the padded batch
    grid) x two seeds must each match their standalone run."""
    cfg = small_cfg(num_itr=2)
    d1 = load_small(limit=200)
    d2 = load_small(seed=1, limit=150)
    res = train_tasks_multi(cfg, {1: d1, 2: d2}, seeds=[0, 1],
                            eval_chunk=16)
    assert res.task_indices == [1, 1, 2, 2]
    assert res.seeds == [0, 1, 0, 1]
    for i, (data, seed) in enumerate([(d1, 0), (d1, 1), (d2, 0), (d2, 1)]):
        ref = train_task(cfg.replace(seed=seed), data)
        np.testing.assert_allclose(res.err_test[i], ref.err_test,
                                   atol=1e-6, err_msg=f"run {i}")
        np.testing.assert_allclose(res.history[-1]["err_valid"][i],
                                   ref.history[-1].err_valid, atol=1e-6)
        np.testing.assert_allclose(res.err_valid_best[i],
                                   min(h.err_valid for h in ref.history),
                                   atol=1e-6)


@pytest.mark.slow
def test_shuffled_run_matches_train_task():
    """Per-run shuffling uses the same np.random.default_rng(seed) stream
    as train_task, so shuffled trajectories must agree too."""
    cfg = small_cfg(num_itr=2, en_sample_shuffled=True, seed=5)
    data = load_small(limit=128)
    ref = train_task(cfg, data)
    res = train_tasks_multi(cfg, {1: data}, seeds=[5], eval_chunk=16)
    np.testing.assert_allclose(res.history[-1]["cost_train"][0],
                               ref.history[-1].cost_train, rtol=2e-4)
    np.testing.assert_allclose(res.err_test[0], ref.err_test, atol=1e-6)


@pytest.mark.slow
def test_float_mode_family():
    """The float control configuration (attention mode 1, no fixed point)
    — the round-3 certification sweep — runs through the family trainer."""
    cfg = small_cfg(attention_mode=1, en_fixed_point=False, num_itr=2)
    data = load_small(limit=128)
    ref = train_task(cfg, data)
    res = train_tasks_multi(cfg, {1: data}, seeds=[0], eval_chunk=16)
    np.testing.assert_allclose(res.err_test[0], ref.err_test, atol=1e-6)
