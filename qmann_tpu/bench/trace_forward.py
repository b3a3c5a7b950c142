"""Per-op device-time profile of the flagship qa1 serving scan (and
optionally the training epoch) — the restoration of the reference's
time_profile[10][7] observability (MemN2N/MemN2N.c:133-141, report at
:3000-3021): where the reference clock()s every (layer, lifecycle-op)
pair, XLA's unit of execution is the fused kernel, so we capture a
jax.profiler trace, parse it in-process with jax.profiler.ProfileData,
and aggregate device time per kernel and per model scope.

Kernels are attributed to the model's named scopes ("embed", "hop_chain",
"output"; models/memn2n.py) through the compiled program's HLO text: a
kernel event names its HLO instruction, and the instruction's op_name
metadata carries the scope path.  On the GPU the kernels are read from
the stream lines of the "/device:GPU:N" planes.

    python -m qmann_tpu.bench.trace_forward --out chiprun_out/trace_serve
    python -m qmann_tpu.bench.trace_forward --train --out chiprun_out/trace_train
"""
from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import sys
import time

# model scopes (jax.named_scope in models/memn2n.py), innermost first
SCOPES = ("output", "hop_chain", "embed")

_HLO_LINE = re.compile(
    r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?metadata=\{[^}]*op_name="([^"]*)"')


def hlo_op_names(hlo_text: str) -> dict:
    """HLO instruction name -> op_name metadata, keyed both as written
    and with '.'/'-' as '_' (the form GPU kernel names take)."""
    out = {}
    for line in hlo_text.splitlines():
        m = _HLO_LINE.match(line)
        if m:
            name, op_name = m.groups()
            out[name] = op_name
            out[re.sub(r"[.\-]", "_", name)] = op_name
    return out


def scope_of(op_name: str) -> str:
    parts = op_name.split("/")
    for scope in SCOPES:
        if scope in parts:
            return scope
    return "other"


def aggregate_trace(trace_dir: str, hlo_text: str = ""):
    """Parse the newest xplane dump under trace_dir.

    Returns a dict: per_kernel {(kernel, op_name): us}, launch
    {(kernel, op_name): the first launch's grid/block details}, per_scope
    {scope: us}, device_us (sum of kernel durations), busy_us (union of
    kernel intervals), window_us (first kernel start to last kernel end)
    and planes {device plane: [names of the lines read]}."""
    from jax.profiler import ProfileData
    paths = sorted(glob.glob(os.path.join(
        trace_dir, "**", "*.xplane.pb"), recursive=True),
        key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no xplane.pb under {trace_dir}")
    data = ProfileData.from_file(paths[-1])
    names = hlo_op_names(hlo_text)
    per_kernel = collections.Counter()
    launch = {}
    intervals = []
    planes = {}
    for plane in data.planes:
        if not plane.name.startswith("/device:"):
            continue
        # kernels run on the CUDA stream lines ("Stream #13(Compute,...)")
        lines = [l for l in plane.lines if l.name.startswith("Stream")]
        planes[plane.name] = [line.name for line in lines]
        for line in lines:
            for ev in line.events:
                # GPU kernel events carry their HLO instruction ("hlo_op";
                # "command_buffer" inside CUDA graphs, where the event
                # name is the instruction) and often the op path ("name")
                stats = dict(ev.stats)
                op_name = (names.get(str(stats.get("hlo_op", "")))
                           or names.get(ev.name)
                           or str(stats.get("name", "")))
                per_kernel[(ev.name, op_name)] += ev.duration_ns / 1e3
                launch.setdefault((ev.name, op_name),
                                  str(stats.get("kernel_details", "")))
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    if not intervals:
        raise RuntimeError(f"no device kernels in {paths[-1]} "
                           f"(planes: {[p.name for p in data.planes]})")
    per_scope = collections.Counter()
    for (_, op_name), us in per_kernel.items():
        per_scope[scope_of(op_name)] += us
    intervals.sort()
    busy, (cur_s, cur_e) = 0.0, intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return {
        "per_kernel": per_kernel, "launch": launch, "per_scope": per_scope,
        "device_us": sum(per_kernel.values()), "busy_us": busy / 1e3,
        "window_us": (max(e for _, e in intervals) - intervals[0][0]) / 1e3,
        "planes": planes,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="qmann_tpu.bench.trace_forward")
    p.add_argument("--out", default="chiprun_out/trace_serve")
    p.add_argument("--train", action="store_true",
                   help="profile the training epoch instead of serving")
    p.add_argument("--attention-mode", type=int, default=2, choices=[2, 3])
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--no-fast-path", action="store_true",
                   help="--train only: keep the runtime integer-fast-path "
                        "conds out (A/B for their data-movement cost)")
    args = p.parse_args(argv)

    from qmann_tpu.utils.compile_cache import enable_compilation_cache
    enable_compilation_cache()
    from qmann_tpu.data.synth import ensure_qa1
    ensure_qa1(0)
    import jax
    import jax.numpy as jnp
    from qmann_tpu.config import QmannConfig
    from qmann_tpu.data.native import load_task_native
    from qmann_tpu.models import memn2n
    from qmann_tpu.ops import cross_entropy
    from qmann_tpu.utils.profiling import trace

    cfg = QmannConfig(verbose=False, attention_mode=args.attention_mode,
                      en_integer_fast_path=not args.no_fast_path)
    data = load_task_native("qa1_single-supporting-fact", cfg.data_path,
                            raw_path=cfg.raw_data_path)
    params = memn2n.init_params(cfg, data.dims, jax.random.PRNGKey(0))

    if args.train:
        from qmann_tpu.train.trainer import _batched_arrays, train_epoch
        batches = {k: jnp.asarray(v) for k, v in
                   _batched_arrays(data.train, cfg.size_batch).items()}
        lr = jnp.float32(0.3)
        # fast_path="config" lets --no-fast-path actually flip the
        # compiled program (train_epoch's default compiles the conds out)
        hlo = train_epoch.lower(params, batches, lr, cfg, False,
                                fast_path="config").compile().as_text()
        per_iter = len(data.train)

        def run():
            out = train_epoch(params, batches, lr, cfg, False,
                              fast_path="config")
            jax.block_until_ready(out)
    else:
        # the serving scan of bench.py: prepared weights, 30 waves of the
        # 1000-query test split with a runtime-zero serial dependence
        prepared = memn2n.prepare_inference(
            params, cfg, max_count=float(data.dims.max_word + 1),
            max_rowsum=float(data.dims.max_word + 1))
        test = data.test
        batch = min(1000, len(test))
        memory = jnp.asarray(test.memory[:batch])
        question = jnp.asarray(test.question[:batch])
        answer = jnp.asarray(test.answer[:batch])
        mask = jnp.asarray(test.mask[:batch])
        k = 30
        per_iter = batch * k

        @jax.jit
        def infer_scan(mem, que, ans, mask):
            def body(carry, _):
                out = memn2n.forward_prepared(prepared, mem, que + carry,
                                              mask, cfg)
                pred = cross_entropy(out.logits, ans).pred
                feedback = jnp.where(pred[0] < 0, 1.0, 0.0).astype(que.dtype)
                return feedback, pred
            _, preds = jax.lax.scan(body, jnp.zeros((), que.dtype), None,
                                    length=k)
            return preds

        compiled = infer_scan.lower(memory, question, answer, mask).compile()
        hlo = compiled.as_text()
        cost = compiled.cost_analysis()
        if cost:
            print(json.dumps({"cost_analysis_flops": cost.get("flops"),
                              "cost_analysis_bytes":
                                  cost.get("bytes accessed")}))

        def run():
            jax.block_until_ready(infer_scan(memory, question, answer, mask))

    run()  # warmup/compile outside the trace
    t0 = time.perf_counter()
    with trace(args.out):
        for _ in range(args.iters):
            run()
    wall = time.perf_counter() - t0
    dev = jax.devices()[0]
    print(f"device {dev.platform} {dev.device_kind}: traced {args.iters} "
          f"iterations, wall {wall:.3f}s -> {args.out}")

    r = aggregate_trace(args.out, hlo)
    n = args.iters
    print(f"device planes: {r['planes']}")
    print(f"kernel time {r['device_us'] / 1e3 / n:.4f} ms/iter, busy "
          f"{r['busy_us'] / 1e3 / n:.4f} ms/iter, idle share of the "
          f"kernel window {1 - r['busy_us'] / r['window_us']:.4f} "
          f"({per_iter} samples/iter)")
    print("== per scope ==")
    for scope, us in r["per_scope"].most_common():
        print(f"  {scope:<10s} {us / 1e3 / n:9.4f} ms/iter  "
              f"{100 * us / r['device_us']:5.1f}%")
    print(f"== top {args.top} kernels ==")
    for key, us in r["per_kernel"].most_common(args.top):
        print(f"  {us / 1e3 / n:9.4f} ms/iter  "
              f"{100 * us / r['device_us']:5.1f}%  {key[0]}  {key[1]}  "
              f"[{r['launch'][key]}]")
    print(json.dumps({
        "device_kind": dev.device_kind, "iters": n,
        "samples_per_iter": per_iter,
        "kernel_ms_per_iter": r["device_us"] / 1e3 / n,
        "busy_ms_per_iter": r["busy_us"] / 1e3 / n,
        "scope_ms_per_iter": {s: us / 1e3 / n
                              for s, us in r["per_scope"].items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
