"""Training-collapse diagnosis: per-epoch weight/activation statistics.

Quantized (mode 2, Q5.2) training on qa1 converges to ~1.3% valid error
around epoch 13 and then catastrophically collapses.  This instrument
logs, per epoch: per-matrix max|w| and the reference clip-metric norm of
the last update, plus saturation fractions of the attention scores and
hop activations on a probe batch — to locate which tensor leaves its
Q-format range first.

    python -m qmann_tpu.bench.diagnose [--epochs 20] [--task 1]
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="qmann_tpu.bench.diagnose")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--task", type=int, default=1)
    p.add_argument("--iwl", type=int, default=5)
    p.add_argument("--max-samples", type=int, default=None)
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
    from qmann_tpu.train import eval_split, train_epoch
    from qmann_tpu.train.optim import lr_schedule
    from qmann_tpu.train.trainer import _batched_arrays
    from qmann_tpu.utils.verification import overflow_stats

    cfg = QmannConfig(iwl=args.iwl, num_itr=args.epochs, verbose=False)
    data = load_task_native(cfg.task_name(args.task), cfg.data_path,
                            raw_path=cfg.raw_data_path,
                            limit_train=args.max_samples)
    params = memn2n.init_params(cfg, data.dims, jax.random.PRNGKey(cfg.seed))
    batches = {k: jnp.asarray(v)
               for k, v in _batched_arrays(data.train, cfg.size_batch).items()}

    probe = 256
    pm = jnp.asarray(data.valid.memory[:probe])
    pq = jnp.asarray(data.valid.question[:probe])
    pmask = jnp.asarray(data.valid.mask[:probe])

    for itr, lr, rm in lr_schedule(cfg):
        params, cost, match = train_epoch(params, batches, jnp.float32(lr),
                                          cfg, rm)
        _, err_valid, _ = eval_split(params, data.valid, cfg)
        out = memn2n.forward(params, pm, pq, pmask, cfg)
        from qmann_tpu.numerics import fixed_max_float
        live_scores = np.asarray(out.scores)[np.broadcast_to(
            np.asarray(pmask)[None], out.scores.shape)]
        score_stats = overflow_stats(live_scores, cfg.fmt_att[0])
        # quantized scores clip AT the bound, so count values pinned there
        maxf = float(fixed_max_float(cfg.fmt_att[0].iwl, cfg.fmt_att[0].frac))
        pinned = float((np.abs(live_scores) >= maxf).mean())
        rec = {
            "itr": itr,
            "err_train": round(1.0 - int(match) / len(data.train), 4),
            "err_valid": round(err_valid, 4),
            "scores_pinned_at_bound": round(pinned, 4),
            "scores_max_abs": round(score_stats["max_abs"], 2),
        }
        for k, v in params.items():
            rec[f"max|{k}|"] = round(float(jnp.max(jnp.abs(v))), 3)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
