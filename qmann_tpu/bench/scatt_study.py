"""Saturation-collapse mitigation study (qa1, mode 2, Q5.2).

Quantized training converges and then can collapse mid-run when attention
scores pin at the Q-format bound (BENCH.md "Known behaviors"); the
reference ships EN_SC_ATT (a learnable scale ahead of the attention
softmax, define.h:59) and an L2 lambda (define.h:238) as the knobs that
could pull scores back inside the representable range.  This tool
quantifies them: each mitigation trains the full epoch budget (early
stopping disabled so the post-collapse tail is observable) and reports
the BEST-model test error vs the FINAL-model test error — a large gap is
the collapse signature.

    python -m qmann_tpu.bench.scatt_study --out-dir runs/scatt_study
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

MITIGATIONS = [
    ("baseline", dict()),
    ("sc_att", dict(en_sc_att=True)),
    ("wd_1e-3", dict(lambda_=0.001)),
    ("wd_1e-2", dict(lambda_=0.01)),
    ("sc_att+wd_1e-3", dict(en_sc_att=True, lambda_=0.001)),
    # the reference's own EN_COSINE_SIM (define.h:200): L2-normalized
    # operands bound scores to [-1, 1], which CANNOT saturate the
    # Q-format — the structural candidate fix (at the cost of coarse
    # score resolution: Q5.2's step is 0.25)
    ("cosine_sim", dict(en_cosine_sim=True)),
    # opt-in mitigations (NOT reference knobs; ops/qlinear.qscore
    # score_mod): "att_shift" subtracts the row max of the RAW score sums
    # before the output requant — softmax is shift-invariant, so the score
    # distribution's shape survives quantization instead of pinning at the
    # bound; "att_clip" clips the raw sums at maxf - step with a
    # straight-through gradient (expected no-op vs the saturating requant —
    # measured to close the question)
    ("att_shift", dict(en_att_shift=True)),
    ("att_clip", dict(en_att_clip=True)),
]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="qmann_tpu.bench.scatt_study")
    p.add_argument("--task", type=int, default=1)
    p.add_argument("--iwl", type=int, default=5)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--seeds", type=int, default=2)
    p.add_argument("--out-dir", default="runs/scatt_study")
    p.add_argument("--resume", action="store_true")
    args = p.parse_args(argv)

    from qmann_tpu.utils.compile_cache import enable_compilation_cache
    enable_compilation_cache()
    from qmann_tpu.data.synth import ensure_qa1
    ensure_qa1(0)
    from qmann_tpu.config import QmannConfig
    from qmann_tpu.data.native import load_task_native
    from qmann_tpu.train import train_task
    from qmann_tpu.train.trainer import eval_split

    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, "summary.json")
    rows = []
    done = set()
    if args.resume and os.path.exists(path):
        with open(path) as f:
            rows = json.load(f)
        done = {(r["mitigation"], r["seed"]) for r in rows}

    base = QmannConfig(iwl=args.iwl, num_itr=args.epochs,
                       en_save_best_model=True,
                       # disable early stopping: the post-collapse tail is
                       # the measurement
                       count_early_stopping=10**9,
                       verbose=False)
    data = load_task_native(base.task_name(args.task), base.data_path,
                            raw_path=base.raw_data_path)
    for name, overrides in MITIGATIONS:
        for seed in range(args.seeds):
            if (name, seed) in done:
                continue
            cfg = base.replace(seed=seed, **overrides)
            t0 = time.time()
            res = train_task(cfg, data)
            _, err_final, _ = eval_split(res.params, data.test, cfg)
            best_epoch = min(range(len(res.history)),
                             key=lambda i: (res.history[i].err_valid,
                                            res.history[i].cost_valid))
            row = {
                "mitigation": name, "seed": seed,
                "err_test_best": res.err_test,
                "err_test_final": err_final,
                "collapse_gap": err_final - res.err_test,
                "best_epoch": best_epoch,
                "err_valid_final": res.history[-1].err_valid,
                "wallclock": time.time() - t0,
            }
            rows.append(row)
            print(json.dumps(row), flush=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(rows, f, indent=2)
            os.replace(tmp, path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
