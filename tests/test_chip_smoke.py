"""chip_smoke.py without a card: it must refuse to run (non-zero exit, no
result line) on the CPU and outside the repository, and its phases must
run end to end when CPU devices stand in for the cards (every card-vs-CPU
comparison then compares the CPU with itself)."""
import os
import shutil
import subprocess
import sys

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run(cwd):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_refuses_without_a_gpu():
    r = _run(REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_refuses_outside_the_repository(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_one_card_phases_on_the_cpu(qa1_dir):
    cpu = jax.devices("cpu")[0]
    data_dir, data = chip_smoke.phase_data()
    assert data_dir == qa1_dir
    cfg = chip_smoke.flagship_config()
    params = chip_smoke.phase_train(cfg, data, cpu, cpu)
    chip_smoke.phase_numerics(cfg, data, cpu, cpu)
    chip_smoke.phase_serve(cfg, data_dir, data, params)


def test_four_card_phase_on_virtual_devices(qa1_dir):
    _, data = chip_smoke.phase_data()
    chip_smoke.phase_four_cards(chip_smoke.flagship_config(), data,
                                jax.devices("cpu")[:4])
