"""Serving-prepared inference (models.memn2n.prepare_inference /
forward_prepared): the static-fast-path forward must be bit-identical to
the runtime-checked training forward on qa1-shaped data (the seeded
generator, qmann_tpu.data.synth), and must fall back (fast=False)
whenever any exactness precondition cannot be proven."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qmann_tpu.config import QmannConfig
from qmann_tpu.data import load_task
from qmann_tpu.models import memn2n


@pytest.fixture(scope="module")
def qa1(qa1_dir):
    return load_task("qa1_single-supporting-fact", qa1_dir,
                     limit_train=64, limit_test=256)


def _batch(data, n=256):
    t = data.test
    return (jnp.asarray(t.memory[:n]), jnp.asarray(t.question[:n]),
            jnp.asarray(t.mask[:n]))


def _bounds(dims):
    return dict(max_count=float(dims.max_word + 1),
                max_rowsum=float(dims.max_word + 1))


@pytest.mark.parametrize("mode,iwl,bw,expect_fast", [
    (2, 5, 8, True),    # flagship: quantized dot, Q5.2
    (3, 5, 8, True),    # hamming attention
    (2, 5, 16, True),   # wide word: non-bf16 (f32 HIGHEST) matmul route
    # low-bit formats: maxf < the count bound, so integer counts would
    # saturate under quantization — prepare must refuse the static route
    # (the runtime-checked path refuses it on the same data for the same
    # reason) and fall back, still bit-identical
    (2, 0, 8, False),
    (3, 1, 8, False),
])
def test_prepared_bit_identical(qa1, mode, iwl, bw, expect_fast):
    cfg = QmannConfig(attention_mode=mode, iwl=iwl, bw_wl=bw, verbose=False)
    params = memn2n.init_params(cfg, qa1.dims, jax.random.PRNGKey(1))
    prep = memn2n.prepare_inference(params, cfg, **_bounds(qa1.dims))
    assert prep.fast == expect_fast
    mem, que, mask = _batch(qa1)
    ref = memn2n.forward(params, mem, que, mask, cfg)
    out = memn2n.forward_prepared(prep, mem, que, mask, cfg)
    np.testing.assert_array_equal(np.asarray(out.logits),
                                  np.asarray(ref.logits))
    np.testing.assert_array_equal(np.asarray(out.attention),
                                  np.asarray(ref.attention))
    np.testing.assert_array_equal(np.asarray(out.scores),
                                  np.asarray(ref.scores))


def test_prepared_closes_over_jit(qa1):
    """The engine's usage pattern: prepared weights closed over a jitted
    wave forward (fast flag stays a Python bool)."""
    cfg = QmannConfig(verbose=False)
    params = memn2n.init_params(cfg, qa1.dims, jax.random.PRNGKey(2))
    prep = memn2n.prepare_inference(params, cfg, **_bounds(qa1.dims))

    @jax.jit
    def infer(mem, que, mask):
        return memn2n.forward_prepared(prep, mem, que, mask, cfg).logits

    mem, que, mask = _batch(qa1, 32)
    ref = memn2n.forward(params, mem, que, mask, cfg)
    np.testing.assert_array_equal(np.asarray(infer(mem, que, mask)),
                                  np.asarray(ref.logits))


@pytest.mark.parametrize("kw,bounds", [
    (dict(en_fixed_point=False, attention_mode=1), {}),  # float model
    (dict(binary_mode=True), {}),                        # binary formats
    (dict(en_pe=True), {}),                              # non-integer query
    (dict(), dict(max_count=1e6, max_rowsum=1e9)),       # bounds too weak
])
def test_prepared_fallback(qa1, kw, bounds):
    cfg = QmannConfig(verbose=False, **kw)
    params = memn2n.init_params(cfg, qa1.dims, jax.random.PRNGKey(3))
    b = _bounds(qa1.dims)
    b.update(bounds)
    prep = memn2n.prepare_inference(params, cfg, **b)
    assert not prep.fast
    mem, que, mask = _batch(qa1, 32)
    ref = memn2n.forward(params, mem, que, mask, cfg)
    out = memn2n.forward_prepared(prep, mem, que, mask, cfg)
    np.testing.assert_array_equal(np.asarray(out.logits),
                                  np.asarray(ref.logits))


def test_prepared_saturating_weights_refuse_fast_path(qa1):
    """Weights near the Q-format bound break the no-saturation product
    condition (count * max|wq| <= maxf): prepare must refuse the fast
    path, and the fallback must still agree with forward()."""
    cfg = QmannConfig(verbose=False)
    params = memn2n.init_params(cfg, qa1.dims, jax.random.PRNGKey(4))
    params = dict(params)
    params["A"] = params["A"].at[0, 0].set(31.75)  # maxf at Q5.2
    prep = memn2n.prepare_inference(params, cfg, **_bounds(qa1.dims))
    assert not prep.fast
    mem, que, mask = _batch(qa1, 32)
    ref = memn2n.forward(params, mem, que, mask, cfg)
    out = memn2n.forward_prepared(prep, mem, que, mask, cfg)
    np.testing.assert_array_equal(np.asarray(out.logits),
                                  np.asarray(ref.logits))

