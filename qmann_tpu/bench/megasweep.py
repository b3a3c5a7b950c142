"""Vmapped sweep harness: the reference's multi-run protocols as ONE
jitted program per configuration.

MemN2N/run.sh:6-30 (10 loops x tasks 1-20) and MemN2N/sweep_fixed.sh:5-8
(iwl {0,1} x tasks x 2 loops) re-train a tiny model hundreds of times in
sequence.  Here all (task, seed) pairs train simultaneously as one
vmapped family (train.multi.train_tasks_multi), so the whole protocol
costs roughly one training's wall-clock:

    # run.sh parity: 10 seeds x 20 tasks at iwl=5
    python -m qmann_tpu.bench.megasweep --tasks 1-20 --seeds 0-9 --iwl 5 \
        --save-best-model --out-dir runs/mega_iwl5

    # float-mode control (attention mode 1, EN_FIXED_POINT undef)
    python -m qmann_tpu.bench.megasweep --tasks 1-20 --seeds 0-2 \
        --attention-mode 1 --no-fixed-point --save-best-model \
        --out-dir runs/mega_float

Outputs per out-dir:
  summary.json   one row per (iwl, task) with per-seed errs —
                 the same schema bench.sweep writes, so
                 qmann_tpu.bench.compare renders both
  history.npz    per-epoch train/valid curves for every run
                 (collapse/mitigation studies read these)
  meta.json      protocol + wall-clock record
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from qmann_tpu.bench.sweep import parse_range, _write_summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="qmann_tpu.bench.megasweep")
    p.add_argument("--tasks", default="1-20")
    p.add_argument("--seeds", default="0-9",
                   help="range/list of per-run seeds, e.g. '0-9' (run.sh's"
                        " 10 loops) or '0,1' (sweep_fixed.sh's 2 loops)")
    p.add_argument("--iwl", default="5")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--attention-mode", type=int, default=2)
    p.add_argument("--no-fixed-point", action="store_true")
    p.add_argument("--bw-wl", type=int, default=8)
    p.add_argument("--binary-mode", action="store_true")
    p.add_argument("--sc-att", action="store_true")
    p.add_argument("--att-shift", action="store_true",
                   help="opt-in saturation mitigation (qscore score_mod)")
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--save-best-model", action="store_true")
    p.add_argument("--eval-chunk", type=int, default=128)
    p.add_argument("--keep-fast-path", action="store_true",
                   help="(now the default) keep the integer fast paths")
    p.add_argument("--no-fast-path", action="store_true",
                   help="A/B: disable the integer fast paths")
    p.add_argument("--max-samples", type=int, default=None)
    p.add_argument("--max-test-samples", type=int, default=None)
    p.add_argument("--pad-dict", type=int, default=64)
    p.add_argument("--pad-line", type=int, default=50)
    p.add_argument("--out-dir", default="megasweep_results")
    p.add_argument("--data-path", default=None,
                   help="parsed-format bAbI directory (default: the seeded "
                        "qa1 of qmann_tpu.data.synth, written on first use)")
    p.add_argument("--raw-data-path", default=None,
                   help="raw bAbI text directory (default: --data-path)")
    args = p.parse_args(argv)
    if args.data_path is None:
        from qmann_tpu.data.synth import ensure_qa1
        args.data_path = ensure_qa1(0)
    args.raw_data_path = args.raw_data_path or args.data_path

    from qmann_tpu.utils.compile_cache import enable_compilation_cache
    enable_compilation_cache()
    from qmann_tpu.config import QmannConfig
    from qmann_tpu.data.native import load_task_native
    from qmann_tpu.train.multi import train_tasks_multi
    from qmann_tpu.utils.reporting import (
        TaskLoopResult, TaskResult, write_run_outputs,
    )

    os.makedirs(args.out_dir, exist_ok=True)
    seeds = parse_range(args.seeds)
    task_list = parse_range(args.tasks)
    summary = []
    meta = {"seeds": seeds, "tasks": task_list, "epochs": args.epochs,
            "attention_mode": args.attention_mode,
            "fixed_point": not args.no_fixed_point, "bw_wl": args.bw_wl,
            "binary_mode": args.binary_mode, "sc_att": args.sc_att,
            "att_shift": args.att_shift,
            "weight_decay": args.weight_decay, "stages": []}
    hist_arrays = {}
    for iwl in parse_range(args.iwl):
        cfg = QmannConfig(iwl=iwl, num_itr=args.epochs,
                          attention_mode=args.attention_mode,
                          en_fixed_point=not args.no_fixed_point,
                          bw_wl=args.bw_wl,
                          binary_mode=args.binary_mode,
                          en_sc_att=args.sc_att,
                          en_att_shift=args.att_shift,
                          lambda_=args.weight_decay,
                          en_save_best_model=args.save_best_model,
                          data_path=args.data_path,
                          raw_data_path=args.raw_data_path,
                          verbose=True)
        tasks = {}
        for ti in task_list:
            tasks[ti] = load_task_native(
                cfg.task_name(ti), cfg.data_path,
                raw_path=cfg.raw_data_path,
                limit_train=args.max_samples,
                limit_test=args.max_test_samples,
                pad_dict=args.pad_dict, pad_line=args.pad_line)
        t0 = time.time()
        res = train_tasks_multi(cfg, tasks, seeds,
                                eval_chunk=args.eval_chunk,
                                integer_fast_path=(False if
                                                   args.no_fast_path
                                                   else None))
        wall = time.time() - t0
        meta["stages"].append({"iwl": iwl, "wallclock": wall,
                               "runs": len(res.err_test),
                               "time_train": res.time_train,
                               "time_test": res.time_test})
        task_results = []
        for ti in task_list:
            sel = [i for i, t in enumerate(res.task_indices) if t == ti]
            errs = [float(res.err_test[i]) for i in sel]
            # result.csv / result_all.csv parity (run.sh's per-loop rows);
            # the family trains as one program, so per-run wall-clock is
            # the amortized share
            task_results.append(TaskResult(ti, [
                TaskLoopResult(
                    res.time_train / len(res.err_test),
                    float(res.history[-1]["err_train"][i])
                    if res.history else 1.0,
                    res.time_test / len(res.err_test),
                    float(res.err_test[i]))
                for i in sel]))
            row = {
                "iwl": iwl, "task": ti,
                "err_test_avg": sum(errs) / len(errs),
                "err_test_min": min(errs), "err_test_max": max(errs),
                "errs": errs,
                "seeds": [res.seeds[i] for i in sel],
                "err_valid_best": [float(res.err_valid_best[i])
                                   for i in sel],
                "ind_best": [int(res.ind_best[i]) for i in sel],
                # amortized: the family trains as one program
                "wallclock": wall / len(task_list),
            }
            summary.append(row)
            print(json.dumps(row), flush=True)
        _write_summary(args.out_dir, summary)
        write_run_outputs(os.path.join(args.out_dir, f"iwl{iwl}"), cfg,
                          task_results)
        for k in ("cost_train", "err_train", "cost_valid", "err_valid"):
            hist_arrays[f"iwl{iwl}_{k}"] = np.stack(
                [h[k] for h in res.history])          # [E, R]
        hist_arrays[f"iwl{iwl}_task"] = np.array(res.task_indices)
        hist_arrays[f"iwl{iwl}_seed"] = np.array(res.seeds)
        np.savez_compressed(os.path.join(args.out_dir, "history.npz"),
                            **hist_arrays)
        with open(os.path.join(args.out_dir, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2)
    if summary:
        mean_err = (sum(r["err_test_avg"] for r in summary) / len(summary))
        print(json.dumps({"sweep_mean_err_test": mean_err}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
