"""Test fixtures.

All tests run on a virtual 8-device CPU mesh so multi-device sharding
logic is exercised without accelerator hardware — the analog of the
reference's CPU<->GPU cross-verification mode (MemN2N/define.h:96-111).
The GPU path is exercised by `python chip_smoke.py` on a card.
"""
import jax
import numpy as np
import pytest

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def qa1_dir():
    """The seeded qa1 files (qmann_tpu.data.synth, seed 0): raw bAbI text
    at the en-10k sizes, read by both loaders."""
    from qmann_tpu.data.synth import ensure_qa1
    return ensure_qa1(0)
