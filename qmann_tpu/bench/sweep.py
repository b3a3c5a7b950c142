"""Sweep harness — the reference's shell sweeps as one runtime tool.

MemN2N/run.sh: 10 loops x tasks 1-20 at iwl=5 (recompiling per config);
MemN2N/sweep_fixed.sh: iwl in {0,1} x tasks 1-20, 2 loops;
MemN2N/merge_results.sh: concatenates the result CSVs.

Here a sweep is one process: configs are runtime values and the compiled
train step is reused across tasks with identical shapes.

    python -m qmann_tpu.bench.sweep --tasks 1-20 --iwl 5 --loops 10
    python -m qmann_tpu.bench.sweep --tasks 1-20 --iwl 0,1 --loops 2
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def parse_range(spec: str):
    out = []
    for part in spec.split(","):
        if "-" in part:
            a, b = part.split("-")
            out.extend(range(int(a), int(b) + 1))
        else:
            out.append(int(part))
    return out


def _write_summary(out_dir: str, summary) -> None:
    tmp = os.path.join(out_dir, "summary.json.tmp")
    with open(tmp, "w") as f:
        json.dump(summary, f, indent=2)
    os.replace(tmp, os.path.join(out_dir, "summary.json"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="qmann_tpu.bench.sweep")
    p.add_argument("--tasks", default="1-20")
    p.add_argument("--iwl", default="5", help="comma list, e.g. '0,1' or '5'")
    p.add_argument("--loops", type=int, default=10)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--attention-mode", type=int, default=2)
    p.add_argument("--no-fixed-point", action="store_true",
                   help="float control run (EN_FIXED_POINT undef)")
    p.add_argument("--bw-wl", type=int, default=8,
                   help="total word length (define.h:21); 4 = INT4 study")
    p.add_argument("--binary-mode", action="store_true",
                   help="BINARY_MODE (define.h:88): iwl=frac=0 everywhere")
    p.add_argument("--sc-att", action="store_true",
                   help="EN_SC_ATT learnable attention scale (define.h:59)")
    p.add_argument("--weight-decay", type=float, default=0.0,
                   help="L2 lambda (define.h:238)")
    p.add_argument("--seed-base", type=int, default=0,
                   help="loop i trains with seed = seed_base + i")
    p.add_argument("--resume", action="store_true",
                   help="skip (iwl, task) rows already in out-dir/summary.json"
                        " with >= --loops recorded loops")
    p.add_argument("--save-best-model", action="store_true")
    p.add_argument("--max-samples", type=int, default=None)
    p.add_argument("--max-test-samples", type=int, default=None)
    p.add_argument("--uniform-shapes", action="store_true",
                   help="pad every task to dict=64 / 50 memory rows so one "
                        "compiled program serves the whole sweep")
    p.add_argument("--out-dir", default="sweep_results")
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
    from qmann_tpu.train import train_task
    from qmann_tpu.utils.reporting import (
        TaskLoopResult, TaskResult, write_run_outputs,
    )

    os.makedirs(args.out_dir, exist_ok=True)
    summary = []
    existing = {}
    if args.resume:
        path = os.path.join(args.out_dir, "summary.json")
        if os.path.exists(path):
            with open(path) as f:
                summary = json.load(f)
            for row in summary:
                # pre-resume rows carry no per-loop errs list: 1 loop
                # (seed 0 == seed_base + loop 0, so appending stays aligned)
                row.setdefault("errs", [row["err_test_avg"]])
                existing[(row["iwl"], row["task"])] = row
    for iwl in parse_range(args.iwl):
        cfg = QmannConfig(iwl=iwl, num_itr=args.epochs,
                          attention_mode=args.attention_mode,
                          en_fixed_point=not args.no_fixed_point,
                          bw_wl=args.bw_wl,
                          binary_mode=args.binary_mode,
                          en_sc_att=args.sc_att,
                          lambda_=args.weight_decay,
                          en_save_best_model=args.save_best_model,
                          data_path=args.data_path,
                          raw_data_path=args.raw_data_path,
                          verbose=False)
        results = []
        for task_index in parse_range(args.tasks):
            prev = existing.get((iwl, task_index))
            start_loop = len(prev["errs"]) if prev else 0
            if start_loop >= args.loops:
                continue
            task = cfg.task_name(task_index)
            t0 = time.time()
            pad = (64, 50) if args.uniform_shapes else (0, 0)
            data = load_task_native(
                task, cfg.data_path, raw_path=cfg.raw_data_path,
                limit_train=args.max_samples,
                limit_test=args.max_test_samples,
                pad_dict=pad[0], pad_line=pad[1])
            loops = []
            for loop in range(start_loop, args.loops):
                res = train_task(cfg.replace(seed=args.seed_base + loop),
                                 data)
                loops.append(TaskLoopResult(
                    res.time_train,
                    res.history[-1].err_train if res.history else 1.0,
                    res.time_test, res.err_test))
            errs = (prev["errs"] if prev else []) + [l.err_test
                                                     for l in loops]
            row = {
                "iwl": iwl, "task": task_index,
                "err_test_avg": sum(errs) / len(errs),
                "err_test_min": min(errs), "err_test_max": max(errs),
                "errs": errs,
                "wallclock": (time.time() - t0
                              + (prev["wallclock"] if prev else 0.0)),
            }
            if prev:
                summary[summary.index(prev)] = row
                existing[(iwl, task_index)] = row
            else:
                summary.append(row)
            print(json.dumps(row), flush=True)
            results.append(TaskResult(task_index, loops))
            # checkpoint after every task so an interrupted sweep still
            # leaves a loadable summary (sweeps run for hours)
            _write_summary(args.out_dir, summary)
        if results:
            write_run_outputs(os.path.join(args.out_dir, f"iwl{iwl}"), cfg,
                              results)
    _write_summary(args.out_dir, summary)
    if summary:
        mean_err = sum(r["err_test_avg"] for r in summary) / len(summary)
        print(json.dumps({"sweep_mean_err_test": mean_err}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
