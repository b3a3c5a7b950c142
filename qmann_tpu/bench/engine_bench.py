"""Engine-regime throughput benchmark: the serving engine end to end.

bench.py's number of record times a device-resident scan — the regime
where XLA hoists all loop-invariant work and host dispatch never appears.
The serving engine lives in the OTHER regime: one jit call per wave, with
host-side vectorization, queueing, and per-call dispatch latency on
every wave.  This probe drives the real
`serve.InferenceEngine` with the bAbI test split from producer threads
and reports sustained throughput, request-latency percentiles, and the
engine's own wave phase breakdown (vectorize vs blocked jit call).

A/B: --no-prepare serves with the training forward (per-wave weight
quantize/stack/layout + runtime fast-path cond) instead of the
serving-prepared path — quantifying what prepare_inference removes in
the regime it targets (the VERDICT r2/round-4 "engine regime" item).

RELIABILITY: host-clock latencies drift (the host's cores are shared),
so the A/B runs INTERLEAVED by default: both engines are built up front
and the passes alternate prepared/unprepared (with the order flipped
every pass), so drift hits both variants equally and the PER-PASS PAIRED
RATIO is quotable even when the absolute qps is not.  The phase breakdown
(vectorize vs blocked jit call) remains the drift-free evidence.

    python -m qmann_tpu.bench.engine_bench [--batch 200] [--passes 5]
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time


def _run_pass(eng, samples, producers: int):
    """Submit every sample from `producers` threads; return (wall_s,
    per-request latencies)."""
    lat = [0.0] * len(samples)
    done = threading.Barrier(producers + 1)

    def produce(shard):
        done.wait()  # start together
        futs = []
        for i in samples_idx[shard::producers]:
            s = samples[i]
            t0 = time.perf_counter()
            futs.append((i, t0, eng.submit(s.sentences, s.question)))
        for i, t0, f in futs:
            f.result(timeout=300)
            lat[i] = time.perf_counter() - t0

    samples_idx = list(range(len(samples)))
    threads = [threading.Thread(target=produce, args=(k,))
               for k in range(producers)]
    for t in threads:
        t.start()
    done.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    return time.perf_counter() - t0, lat


def _summarize(prepare: bool, walls, lats, st):
    lats = sorted(lats)
    n = len(lats)
    total = sum(walls)
    return {
        "prepared": prepare,
        "requests": st["requests"],
        "waves": st["waves"],
        "mean_wave_fill": round(st["requests"] / max(st["waves"], 1), 1),
        "sustained_qps": round(st["requests"] / total, 1),
        "wall_s_per_pass": [round(w, 3) for w in walls],
        "latency_ms_p50": round(1e3 * lats[n // 2], 2),
        "latency_ms_p95": round(1e3 * lats[int(n * 0.95)], 2),
        "wave_vectorize_ms_avg": round(
            1e3 * st["vectorize_s"] / max(st["waves"], 1), 2),
        "wave_infer_ms_avg": round(
            1e3 * st["infer_s"] / max(st["waves"], 1), 2),
        "failed_waves": st["failed_waves"],
    }


def _make_engine(prepare: bool, args, cfg, data, params):
    from qmann_tpu.serve import InferenceEngine

    return InferenceEngine(params, cfg, data.dims, data.dictionary,
                           batch_size=args.batch,
                           max_wait_ms=args.max_wait_ms,
                           prepare=prepare).start()


def _measure(prepare: bool, args, cfg, data, samples, params):
    eng = _make_engine(prepare, args, cfg, data, params)
    try:
        # warmup pass: compile, excluded from the numbers
        _run_pass(eng, samples[:args.batch], args.producers)
        eng.stats = type(eng.stats)()  # reset counters
        walls, lats = [], []
        for _ in range(args.passes):
            wall, lat = _run_pass(eng, samples, args.producers)
            walls.append(wall)
            lats.extend(lat)
        st = eng.stats.snapshot()
    finally:
        eng.stop()
    return _summarize(prepare, walls, lats, st)


def _measure_interleaved(args, cfg, data, samples, params):
    """Paired A/B: both engines live at once (waves run only inside
    submit-driven flushes, so they never contend for the device), passes
    alternate prepared/unprepared with the order flipped each round.
    Latency drift then hits both variants equally and the
    per-pass paired ratio is quotable even when the absolute qps isn't.
    """
    eng = {v: _make_engine(v, args, cfg, data, params)
           for v in (True, False)}
    try:
        for v in (True, False):  # compile warmup, both first
            _run_pass(eng[v], samples[:args.batch], args.producers)
            eng[v].stats = type(eng[v].stats)()
        walls = {True: [], False: []}
        lats = {True: [], False: []}
        for k in range(args.passes):
            order = (True, False) if k % 2 == 0 else (False, True)
            for v in order:
                wall, lat = _run_pass(eng[v], samples, args.producers)
                walls[v].append(wall)
                lats[v].extend(lat)
        stats = {v: eng[v].stats.snapshot() for v in eng}
    finally:
        for e in eng.values():
            e.stop()
    rows = [_summarize(v, walls[v], lats[v], stats[v])
            for v in (True, False)]
    ratios = sorted(walls[False][k] / walls[True][k]
                    for k in range(args.passes))
    rows.append({
        "paired_speedup_per_pass": [
            round(walls[False][k] / walls[True][k], 3)
            for k in range(args.passes)],
        "paired_speedup_median": round(ratios[len(ratios) // 2], 3),
        "prepared_infer_ms_saved_per_wave": round(
            rows[1]["wave_infer_ms_avg"] - rows[0]["wave_infer_ms_avg"], 2),
    })
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="qmann_tpu.bench.engine_bench")
    p.add_argument("--task", type=int, default=1)
    p.add_argument("--batch", type=int, default=200,
                   help="engine wave size (fixed compiled batch shape)")
    p.add_argument("--passes", type=int, default=5,
                   help="measured passes over the test split per variant")
    p.add_argument("--producers", type=int, default=8)
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--requests", type=int, default=1000,
                   help="test-split requests per pass")
    p.add_argument("--no-prepare", action="store_true",
                   help="measure ONLY the unprepared engine")
    p.add_argument("--prepare-only", action="store_true",
                   help="measure ONLY the prepared engine")
    args = p.parse_args(argv)

    from qmann_tpu.utils.compile_cache import enable_compilation_cache
    enable_compilation_cache()
    from qmann_tpu.data.synth import ensure_qa1
    ensure_qa1(0)
    import jax
    from qmann_tpu.config import QmannConfig
    from qmann_tpu.data.babi import load_samples
    from qmann_tpu.data.native import load_task_native
    from qmann_tpu.models import memn2n

    cfg = QmannConfig(verbose=False)
    name = cfg.task_name(args.task)
    data = load_task_native(name, cfg.data_path, raw_path=cfg.raw_data_path)
    samples = load_samples(name, "test", cfg.data_path,
                           raw_path=cfg.raw_data_path,
                           limit=args.requests)
    params = memn2n.init_params(cfg, data.dims, jax.random.PRNGKey(0))

    if args.no_prepare or args.prepare_only:
        rows = [_measure(args.prepare_only, args, cfg, data, samples, params)]
    else:
        rows = _measure_interleaved(args, cfg, data, samples, params)
    for r in rows:
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
