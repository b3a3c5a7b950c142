"""Benchmark: quantized MemN2N inference throughput (queries/sec/chip).

Runs the flagship configuration (attention mode 2, Q5.2, 3 hops,
dim_emb 60) on the seeded qa1 test split (qmann_tpu.data.synth, the
reference's dimensions) and measures steady-state batched inference
throughput on one device: a device-resident lax.scan over 30 batches of
1000 queries, with a runtime-zero serial dependence between batches so
XLA cannot hoist the loop-invariant forward (the queue-full regime of the
serving engine).

Baseline: the reference publishes no numbers (BASELINE.md).  Its CUDA
test loop runs one sample at a time with ~20 sequential kernel launches
per sample per hop (SURVEY.md section 3.2: dense_mat fwd x2, dot, softmax
(2 kernels), weighted sum, dense, sum per hop, plus output layers), each
launch costing ~5-10us — bounding it well below ~20k queries/sec on a
contemporary GPU.  We take 20,000 q/s as a deliberately generous CUDA
baseline estimate; vs_baseline = measured / 20000.

The timed scan is repeated REPEATS times and the MEDIAN is reported, with
the min/max spread and the measurement regime recorded alongside so the
JSON line self-describes its methodology.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np

BASELINE_QPS = 20000.0  # estimated reference CUDA throughput (see above)
REPEATS = 7             # timed repetitions; the median is the number of record


def main() -> int:
    import jax
    import jax.numpy as jnp

    from qmann_tpu.utils.compile_cache import enable_compilation_cache
    enable_compilation_cache()
    from qmann_tpu.config import QmannConfig
    from qmann_tpu.data.native import load_task_native
    from qmann_tpu.data.synth import ensure_qa1
    from qmann_tpu.models import memn2n
    from qmann_tpu.ops import cross_entropy

    cfg = QmannConfig(verbose=False)
    data_dir = ensure_qa1(0)
    data = load_task_native("qa1_single-supporting-fact", data_dir,
                            raw_path=data_dir)
    dims = data.dims
    params = memn2n.init_params(cfg, dims, jax.random.PRNGKey(0))
    # serving layout: weights pre-quantized/stacked once, exact-matmul
    # routes decided statically (what the serving engine does per
    # instance) — no per-call lax.cond dispatch or weight processing
    prepared = memn2n.prepare_inference(
        params, cfg, max_count=float(dims.max_word + 1),
        max_rowsum=float(dims.max_word + 1))
    assert prepared.fast, "flagship config must take the static matmul route"

    test = data.test
    batch = min(1000, len(test))  # the whole qa1 test split per step
    memory = jnp.asarray(test.memory[:batch])
    question = jnp.asarray(test.question[:batch])
    answer = jnp.asarray(test.answer[:batch])
    mask = jnp.asarray(test.mask[:batch])

    k = 30

    @jax.jit
    def infer_scan(mem, que, ans, mask):
        # thread a runtime-zero scalar derived from the previous batch's
        # predictions into the next batch's query so XLA cannot hoist the
        # loop-invariant forward out of the scan
        def body(carry, _):
            out = memn2n.forward_prepared(prepared, mem, que + carry, mask,
                                          cfg)
            pred = cross_entropy(out.logits, ans).pred
            feedback = jnp.where(pred[0] < 0, 1.0, 0.0).astype(que.dtype)
            return feedback, pred
        _, preds = jax.lax.scan(body, jnp.zeros((), que.dtype), None,
                                length=k)
        return preds

    # warmup / compile
    preds = infer_scan(memory, question, answer, mask)
    jax.block_until_ready(preds)

    samples = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        preds = infer_scan(memory, question, answer, mask)
        jax.block_until_ready(preds)
        samples.append(batch * k / (time.perf_counter() - t0))
    qps = float(np.median(samples))

    print(json.dumps({
        "metric": "qa1_test_inference_throughput",
        "value": round(qps, 1),
        "unit": "queries/sec/device",
        "vs_baseline": round(qps / BASELINE_QPS, 3),
        "regime": "device_resident_scan",
        "repeats": REPEATS,
        "spread_min": round(min(samples), 1),
        "spread_max": round(max(samples), 1),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
