"""CLI surface tests (subprocess, CPU-forced environment).

Runs without a data path read the seeded qa1 (qmann_tpu.data.synth) the
CLIs default to; the joint-training runs need the reference's bAbI
release and skip where it is absent."""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference's bAbI release (MemN2N/dataset), where present
DATASET = os.environ.get("QMANN_BABI_DATASET", "")
PARSED = os.path.join(DATASET, "en_10k_parsed")

needs_data = pytest.mark.skipif(
    not os.path.isdir(PARSED),
    reason="bAbI release not present (QMANN_BABI_DATASET)")


def run_cli(args, timeout=420):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m"] + args, cwd=REPO,
                          capture_output=True, text=True, timeout=timeout,
                          env=env)


def test_cli_help_lists_reference_positionals():
    r = run_cli(["qmann_tpu", "--help"], timeout=120)
    assert r.returncode == 0
    for word in ("num_task_loop", "task_start", "task_end", "iwl"):
        assert word in r.stdout


def test_cli_smoke_run_writes_results(tmp_path):
    r = run_cli(["qmann_tpu", "1", "1", "1", "5", "--epochs", "1",
                 "--max-samples", "120", "--max-test-samples", "30",
                 "--out-dir", str(tmp_path), "--quiet"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "err_test" in r.stdout
    csv = (tmp_path / "result.csv").read_text()
    assert "ind_data_set" in csv and csv.strip().splitlines()[-1][0] == "1"


def test_cli_config_flag_plumbing():
    """Every define.h knob exposed on the CLI reaches QmannConfig."""
    from qmann_tpu.cli import build_parser, config_from_args
    args = build_parser().parse_args(
        ["1", "1", "1", "5", "--sc-att", "--non-linearity", "--grad-quant",
         "--quant-mode", "2", "--weight-decay", "0.001"])
    cfg = config_from_args(args)
    assert cfg.en_sc_att and cfg.en_non_linearity and cfg.en_grad_quant
    assert cfg.quant_mode == 2 and cfg.lambda_ == 0.001
    # defaults match define.h: truncation rounding, lambda 0
    dflt = config_from_args(build_parser().parse_args(["1", "1", "1", "5"]))
    assert dflt.quant_mode == 3 and dflt.lambda_ == 0.0
    assert not (dflt.en_sc_att or dflt.en_non_linearity or dflt.en_grad_quant)


def test_sweep_smoke_emits_json(tmp_path):
    r = run_cli(["qmann_tpu.bench.sweep", "--tasks", "1", "--iwl", "5",
                 "--loops", "1", "--epochs", "1", "--max-samples", "120",
                 "--max-test-samples", "30", "--out-dir", str(tmp_path)])
    assert r.returncode == 0, r.stderr[-2000:]
    rows = [json.loads(l) for l in r.stdout.splitlines()
            if l.startswith("{")]
    assert any("err_test_avg" in row for row in rows)
    assert (tmp_path / "summary.json").exists()


def test_cli_mesh_sharded_training(tmp_path):
    env_extra = {"XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(env_extra)
    r = subprocess.run(
        [sys.executable, "-m", "qmann_tpu", "1", "1", "1", "5",
         "--epochs", "1", "--max-samples", "120", "--max-test-samples", "24",
         "--mesh", "2,4", "--out-dir", str(tmp_path), "--quiet"],
        cwd=REPO, capture_output=True, text=True, timeout=420, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Mesh : data=2 model=4" in r.stdout
    assert "err_test" in r.stdout


@needs_data
@pytest.mark.slow
def test_cli_joint_trains_once_tests_per_task(tmp_path):
    r = run_cli(["qmann_tpu", "1", "1", "3", "5", "--joint",
                 "--epochs", "1", "--max-samples", "240",
                 "--max-test-samples", "30", "--out-dir", str(tmp_path),
                 "--quiet"])
    assert r.returncode == 0, r.stderr[-2000:]
    # trains the joint model exactly once...
    assert r.stdout.count("Joint training:") == 1
    # ...then reports every requested task
    for t in (1, 2, 3):
        assert f"task {t} (" in r.stdout
    csv = (tmp_path / "result.csv").read_text()
    assert csv.strip().splitlines()[-1].startswith("3,")


def test_megasweep_smoke_emits_json_and_outputs(tmp_path):
    r = run_cli(["qmann_tpu.bench.megasweep", "--tasks", "1", "--seeds",
                 "0,1", "--iwl", "5", "--epochs", "1", "--max-samples",
                 "120", "--max-test-samples", "30", "--save-best-model",
                 "--out-dir", str(tmp_path)])
    assert r.returncode == 0, r.stderr[-2000:]
    rows = [json.loads(l) for l in r.stdout.splitlines()
            if l.startswith("{")]
    data_rows = [row for row in rows if "errs" in row]
    assert data_rows and len(data_rows[0]["errs"]) == 2
    assert (tmp_path / "summary.json").exists()
    assert (tmp_path / "history.npz").exists()
    assert (tmp_path / "meta.json").exists()
    assert (tmp_path / "iwl5" / "result.csv").exists()
    assert (tmp_path / "iwl5" / "result_all.csv").exists()


@needs_data
@pytest.mark.slow
def test_cli_joint_block_knobs(tmp_path):
    """The reference joint config block (define.h:177-191):
    EN_SAMPLE_SHUFFLED + DIM_FORCED 96/50 run end-to-end and force the
    input layout."""
    r = run_cli(["qmann_tpu", "1", "1", "2", "5", "--joint", "--shuffle",
                 "--dim-forced", "--max-dict-len", "96",
                 "--max-sen-len", "50",
                 "--epochs", "1", "--max-samples", "240",
                 "--max-test-samples", "30", "--out-dir", str(tmp_path)])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "dict 96" in r.stdout
    for t in (1, 2):
        assert f"task {t} (" in r.stdout
