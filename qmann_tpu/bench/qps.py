"""Throughput benchmarks: training steps/sec and inference queries/sec,
single device and (when more devices exist) sharded over the mesh.

    python -m qmann_tpu.bench.qps [--batch 1000] [--sharded]
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="qmann_tpu.bench.qps")
    p.add_argument("--batch", type=int, default=1000)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--train-iters", type=int, default=10)
    p.add_argument("--sharded", action="store_true")
    args = p.parse_args(argv)

    from qmann_tpu.utils.compile_cache import enable_compilation_cache
    enable_compilation_cache()
    from qmann_tpu.data.synth import ensure_qa1
    ensure_qa1(0)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from qmann_tpu.config import QmannConfig
    from qmann_tpu.data.native import load_task_native
    from qmann_tpu.models import memn2n
    from qmann_tpu.ops import cross_entropy
    from qmann_tpu.train.trainer import _batched_arrays, train_epoch

    cfg = QmannConfig(verbose=False)
    data = load_task_native("qa1_single-supporting-fact", cfg.data_path,
                            raw_path=cfg.raw_data_path)
    params = memn2n.init_params(cfg, data.dims, jax.random.PRNGKey(0))

    # ---- inference qps ----
    n = min(args.batch, len(data.test))
    t = data.test
    mem, que = jnp.asarray(t.memory[:n]), jnp.asarray(t.question[:n])
    ans, mask = jnp.asarray(t.answer[:n]), jnp.asarray(t.mask[:n])

    @jax.jit
    def infer(params, mem, que, ans, mask):
        out = memn2n.forward(params, mem, que, mask, cfg)
        return cross_entropy(out.logits, ans).pred

    pred = infer(params, mem, que, ans, mask)
    jax.block_until_ready(pred)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        pred = infer(params, mem, que, ans, mask)
    jax.block_until_ready(pred)
    qps = n * args.iters / (time.perf_counter() - t0)

    # ---- training throughput ----
    batches = {k: jnp.asarray(v)
               for k, v in _batched_arrays(data.train, cfg.size_batch).items()}
    params2, c, m = train_epoch(params, batches, jnp.float32(0.3), cfg, False)
    jax.block_until_ready(params2)
    t0 = time.perf_counter()
    for _ in range(args.train_iters):
        params2, c, m = train_epoch(params2, batches, jnp.float32(0.3), cfg,
                                    False)
    jax.block_until_ready(params2)
    epoch_s = (time.perf_counter() - t0) / args.train_iters
    train_sps = len(data.train) / epoch_s

    # ---- serving-engine throughput (continuous batching waves) ----
    from qmann_tpu.serve import InferenceEngine
    eng = InferenceEngine(params, cfg, data.dims, data.dictionary,
                          batch_size=256, max_wait_ms=0.5).start()
    try:
        words = data.dictionary.words
        story = [[words[1], words[2], words[3]]]
        question = [words[1]]
        # warm the engine's compiled path
        eng.submit(story, question).result(120)
        t0 = time.perf_counter()
        futs = [eng.submit(story, question) for _ in range(2048)]
        for f in futs:
            f.result(120)
        serve_qps = 2048 / (time.perf_counter() - t0)
    finally:
        eng.stop()

    print(json.dumps({"inference_qps": round(qps, 1),
                      "serving_engine_qps": round(serve_qps, 1),
                      "train_samples_per_sec": round(train_sps, 1),
                      "epoch_seconds": round(epoch_s, 3),
                      "devices": len(jax.devices())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
