"""Scaling-efficiency harness: training throughput vs device count.

This harness measures the sharded train step's samples/sec over growing
sub-meshes of whatever devices exist — the cards of one host, or a
virtual CPU mesh for logic validation.

    python -m qmann_tpu.bench.scaling [--batch 256] [--devices 1,2,4,8]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def measure(n_devices: int, batch: int, m: int, dim_input: int,
            dim_emb: int, iters: int) -> float:
    import jax
    import jax.numpy as jnp

    from qmann_tpu.config import QmannConfig
    from qmann_tpu.data import DataDims
    from qmann_tpu.models import memn2n
    from qmann_tpu.parallel import (
        make_mesh, make_sharded_train_step, shard_batch, shard_params,
    )

    mesh = make_mesh(n_devices)
    cfg = QmannConfig(dim_emb=dim_emb, verbose=False)
    dims = DataDims(dim_dict=dim_input - m, max_line=m, max_word=7,
                    dim_word=8, dim_input=dim_input)
    rng = np.random.default_rng(0)
    params = memn2n.init_params(cfg, dims, jax.random.PRNGKey(0))
    memory = rng.integers(0, 2, (batch, m, dim_input)).astype(np.float32)
    question = rng.integers(0, 2, (batch, dim_input)).astype(np.float32)
    answer = np.zeros((batch, dim_input), np.float32)
    answer[np.arange(batch), rng.integers(1, dim_input, batch)] = 1.0
    mask = np.ones((batch, m), bool)
    batch_dict = {"memory": memory, "question": question, "answer": answer,
                  "mask": mask, "sample_mask": np.ones(batch, np.float32)}

    step = make_sharded_train_step(cfg, mesh)
    sp = shard_params(mesh, params)
    sb = shard_batch(mesh, batch_dict)
    lr = jnp.float32(0.3)
    size_b = jnp.float32(batch)
    sp, c, _ = step(sp, sb, lr, size_b)
    jax.block_until_ready(c)
    t0 = time.perf_counter()
    for _ in range(iters):
        sp, c, _ = step(sp, sb, lr, size_b)
    jax.block_until_ready(c)
    return batch * iters / (time.perf_counter() - t0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="qmann_tpu.bench.scaling")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--memory-rows", type=int, default=64)
    p.add_argument("--dim-input", type=int, default=128)
    p.add_argument("--dim-emb", type=int, default=64)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--devices", default=None,
                   help="comma list of device counts; default 1..N pow2")
    args = p.parse_args(argv)

    from qmann_tpu.utils.compile_cache import enable_compilation_cache
    enable_compilation_cache()
    import jax
    total = len(jax.devices())
    if args.devices:
        counts = [int(x) for x in args.devices.split(",")]
        bad = [c for c in counts if c > total]
        if bad:
            # make_mesh would silently truncate to the available devices,
            # reporting an efficiency number for hardware that wasn't used
            print(f"error: requested device counts {bad} exceed the "
                  f"{total} available device(s)", file=sys.stderr)
            return 2
    else:
        counts = [c for c in (1, 2, 4, 8, 16, 32) if c <= total]
    base = None
    for n in counts:
        sps = measure(n, args.batch, args.memory_rows, args.dim_input,
                      args.dim_emb, args.iters)
        if base is None:
            base = sps
        eff = sps / (base * n / counts[0])
        print(json.dumps({"devices": n,
                          "train_samples_per_sec": round(sps, 1),
                          "scaling_efficiency": round(eff, 3)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
