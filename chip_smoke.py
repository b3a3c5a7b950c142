#!/usr/bin/env python3
"""Smoke test of the GPU path: the quickest proof that the system runs.

    python chip_smoke.py               # one card: train, sweep, serve
    python chip_smoke.py --four-cards  # the sharded paths, on four cards

One process drives everything (a second JAX process on the card would
find its memory taken), and the CPU side of every comparison runs on
jax.devices("cpu") inside it.  One card, in order:

  1. device  — a GPU is required, else exit 1 before any result;
  2. data    — seeded qa1 at the en-10k sizes (qmann_tpu.data.synth),
               loaded through data.native.load_task_native;
  3. train   — the flagship config of `python -m qmann_tpu 1 1 1 5
               --epochs 2` (attention mode 2, Q5.2, 3 hops, dim_emb 60,
               batch 32) through train.train_task; its first SGD step
               checked against the CPU; then one epoch of the vmapped
               family trainer over 2 seeds;
  4. serve   — forward_prepared against forward (modes 2 and 3) on the
               card and against the CPU on the 1,000-query test split,
               then the InferenceEngine answering a few hundred requests;
  5. compiled memory of the train epoch and the serving wave, and each
     phase's compile and run seconds (a smoke, not a benchmark).

--four-cards runs only the sharded paths on a 2x2 ("data", "model") mesh
and compares each with the same work on one card: the GSPMD train step,
the explicit shard_map step, and sharded prepared serving.

Any failed check ends the run with a non-zero exit.  The last line of
standard output, printed only on success, is one JSON object naming the
device as JAX reports it.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# the CPU side of each comparison needs the CPU backend beside the GPU
_platforms = os.environ.get("JAX_PLATFORMS", "")
if _platforms and "cpu" not in _platforms.split(","):
    os.environ["JAX_PLATFORMS"] = _platforms + ",cpu"

import numpy as np  # noqa: E402

SEED = 0
FLAGSHIP_ARGS = ["1", "1", "1", "5", "--epochs", "2"]
N_REQUESTS = 300
TIMES = []          # (phase, compile seconds, run seconds)


def check(cond, what):
    if not cond:
        raise AssertionError(what)
    print(f"  ok: {what}")


def rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def print_memory(label, compiled):
    mem = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    print(f"memory_analysis[{label}]: " + json.dumps(
        {f: getattr(mem, f, None) for f in fields}))


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def phase_device(n_cards: int):
    import jax
    if jax.default_backend() != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX backend "
                         f"{jax.default_backend()!r}); nothing was run")
    gpus = jax.devices()
    if len(gpus) < n_cards:
        raise SystemExit(f"chip_smoke: needs {n_cards} GPUs, JAX sees "
                         f"{len(gpus)}")
    from qmann_tpu.utils.compile_cache import enable_compilation_cache
    cache = enable_compilation_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(f"device: {gpus[0].platform} {gpus[0].device_kind} x{len(gpus)}")
    for line in smi.stdout.strip().splitlines():
        print(f"nvidia-smi: {line.strip()}")
    print(f"XLA_FLAGS: {os.environ.get('XLA_FLAGS', '')!r}")
    print(f"compile cache: {cache}")
    return gpus, jax.devices("cpu")[0]


# ---------------------------------------------------------------------------
# 2. data
# ---------------------------------------------------------------------------

def phase_data():
    from qmann_tpu.data.native import load_task_native
    from qmann_tpu.data.synth import TASK, ensure_qa1
    t0 = time.perf_counter()
    data_dir = ensure_qa1(SEED)
    data = load_task_native(TASK, data_dir, raw_path=data_dir)
    TIMES.append(("data", 0.0, time.perf_counter() - t0))
    print(f"== data: seeded qa1 (seed {SEED}) {data.dims}")
    check((len(data.train), len(data.valid), len(data.test))
          == (9000, 1000, 1000), "en-10k split sizes 9000/1000/1000")
    check(data.dims.max_line == 10 and data.dims.dim_input == 30,
          "qa1 dims: 10 memory rows, 30 input features")
    return data_dir, data


def flagship_config():
    from qmann_tpu.cli import build_parser, config_from_args
    cfg = config_from_args(build_parser().parse_args(FLAGSHIP_ARGS))
    check((cfg.attention_mode, cfg.iwl, cfg.frac, cfg.num_hops,
           cfg.dim_emb, cfg.size_batch) == (2, 5, 2, 3, 60, 32),
          "flagship: mode 2, Q5.2, 3 hops, dim_emb 60, batch 32")
    return cfg


def first_batch(split, n):
    return {"memory": split.memory[:n], "question": split.question[:n],
            "answer": split.answer[:n], "mask": split.mask[:n],
            "sample_mask": np.ones(n, np.float32)}


# ---------------------------------------------------------------------------
# 3. train
# ---------------------------------------------------------------------------

def phase_train(cfg, data, gpu, cpu):
    import jax
    import jax.numpy as jnp
    from qmann_tpu.models import memn2n
    from qmann_tpu.train import train_task
    from qmann_tpu.train.multi import train_tasks_multi
    from qmann_tpu.train.trainer import _batched_arrays, train_epoch

    print("== train: flagship config, 2 epochs")
    # the first SGD step's loss and gradients, card against CPU; the step
    # as train_epoch compiles it (runtime fast-path conds compiled out)
    step_cfg = cfg.replace(en_integer_fast_path=False)
    params0 = memn2n.init_params(cfg, data.dims, jax.random.PRNGKey(cfg.seed))
    batch = first_batch(data.train, cfg.size_batch)

    @jax.jit
    def loss_and_grad_norms(p, b):
        def loss_fn(p_):
            return memn2n.loss_and_metrics(
                p_, b["memory"], b["question"], b["answer"], b["mask"],
                b["sample_mask"], step_cfg)
        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        return loss, {k: jnp.linalg.norm(g) for k, g in grads.items()}

    gpu_loss, gpu_norms = jax.device_get(
        loss_and_grad_norms(*jax.device_put((params0, batch), gpu)))
    cpu_loss, cpu_norms = jax.device_get(
        loss_and_grad_norms(*jax.device_put((params0, batch), cpu)))
    print(f"  first step: loss card {gpu_loss!r} cpu {cpu_loss!r}; "
          f"grad norms card {dict(gpu_norms)} cpu {dict(cpu_norms)}")
    # 1e-5 relative: both sides compute the same float32 math; only the
    # order of the float32 sums differs between the card and the CPU
    check(np.isfinite(gpu_loss) and rel(gpu_loss, cpu_loss) <= 1e-5,
          f"first-step loss card vs CPU within 1e-5 relative "
          f"({rel(gpu_loss, cpu_loss):.2e})")
    worst = max(rel(gpu_norms[k], cpu_norms[k]) for k in cpu_norms)
    check(worst <= 1e-5, f"first-step gradient norms card vs CPU within "
                         f"1e-5 relative (worst {worst:.2e})")

    batches = {k: jnp.asarray(v) for k, v in
               _batched_arrays(data.train, cfg.size_batch).items()}
    check(batches["memory"].shape[:2] == (282, 32),
          "282 batches of 32 per epoch")
    t0 = time.perf_counter()
    compiled = train_epoch.lower(params0, batches, jnp.float32(0.3),
                                 cfg, False).compile()
    t_compile = time.perf_counter() - t0
    print_memory("train epoch (scanned SGD step)", compiled)

    t0 = time.perf_counter()
    res = train_task(cfg, data)
    t_run = time.perf_counter() - t0
    TIMES.append(("train", t_compile, t_run))
    costs = [h.cost_train for h in res.history]
    print(f"  epochs: cost_train {costs}, err_train "
          f"{[h.err_train for h in res.history]}, err_test {res.err_test}")
    check(len(costs) == 2 and all(np.isfinite(costs)), "finite loss")
    # cost is minus the summed probability of the right answer
    check(costs[1] < costs[0], "loss falls from epoch 1 to epoch 2")
    check(0.0 <= res.err_test <= 1.0, "test error in [0, 1]")

    print("== train: vmapped family, 1 epoch x 2 seeds")
    t0 = time.perf_counter()
    fam = train_tasks_multi(cfg.replace(num_itr=1, verbose=False),
                            {1: data}, seeds=[0, 1])
    TIMES.append(("family", 0.0, time.perf_counter() - t0))
    print(f"  family err_test {fam.err_test.tolist()}, cost_train "
          f"{fam.history[0]['cost_train'].tolist()}")
    check(fam.err_test.shape == (2,) and np.isfinite(fam.err_test).all()
          and np.isfinite(fam.history[0]["cost_train"]).all(),
          "family of 2 runs trained with finite metrics")
    return res.params


# ---------------------------------------------------------------------------
# 4. serve
# ---------------------------------------------------------------------------

def phase_numerics(cfg, data, gpu, cpu):
    """forward_prepared against forward on the card, and the card against
    the CPU, at the flagship widths on the 1,000-query test split."""
    import jax
    from qmann_tpu.models import memn2n
    from qmann_tpu.ops import argmax_last

    test = data.test
    inputs = (test.memory, test.question, test.mask)
    bounds = dict(max_count=float(data.dims.max_word + 1),
                  max_rowsum=float(data.dims.max_word + 1))
    for mode in (2, 3):
        mcfg = cfg.replace(attention_mode=mode)
        print(f"== serve numerics: attention mode {mode}, "
              f"{len(test)} queries")
        params = memn2n.init_params(mcfg, data.dims,
                                    jax.random.PRNGKey(SEED + mode))
        prep = memn2n.prepare_inference(params, mcfg, **bounds)
        check(prep.fast, "prepare_inference takes the exact matmul route")

        forward = jax.jit(lambda p, m, q, k: memn2n.forward(p, m, q, k, mcfg))
        prepared = jax.jit(
            lambda m, q, k: memn2n.forward_prepared(prep, m, q, k, mcfg))
        ref = jax.device_get(forward(*jax.device_put((params,) + inputs,
                                                     gpu)))
        out = jax.device_get(prepared(*jax.device_put(inputs, gpu)))
        # the repository's contract: the prepared route is the same
        # arithmetic on the integer grid, so it is bit-identical
        for name in ("logits", "attention", "scores"):
            check(np.array_equal(getattr(out, name), getattr(ref, name)),
                  f"forward_prepared == forward bit for bit ({name})")

        host = jax.device_get(forward(*jax.device_put((params,) + inputs,
                                                      cpu)))
        # quantized scores: every value is on the 2^-frac grid, so the
        # card and the CPU agree exactly
        check(np.array_equal(ref.scores, host.scores),
              "quantized scores card == CPU bit for bit")
        # probabilities: exp and division differ in the last bits
        d_att = float(np.max(np.abs(ref.attention - host.attention)))
        check(d_att <= 1e-6, f"attention probabilities card vs CPU within "
                             f"1e-6 absolute ({d_att:.2e})")
        # answers: a last-bit difference may flip a near-tie argmax
        agree = float(np.mean(np.asarray(argmax_last(ref.logits, -1))
                              == np.asarray(argmax_last(host.logits, -1))))
        d_logit = float(np.max(np.abs(ref.logits - host.logits)))
        print(f"  largest logit difference card vs CPU: {d_logit!r}")
        check(agree >= 0.999, f"answers card == CPU on {agree:.2%} of "
                              f"queries (>= 99.9%)")


def phase_serve(cfg, data_dir, data, params):
    import jax
    import jax.numpy as jnp
    from qmann_tpu.data.babi import load_samples
    from qmann_tpu.data.synth import TASK
    from qmann_tpu.models import memn2n
    from qmann_tpu.ops import argmax_last
    from qmann_tpu.serve import InferenceEngine

    print(f"== serve: InferenceEngine, {N_REQUESTS} requests, trained "
          f"weights")
    samples = load_samples(TASK, "test", data_dir, raw_path=data_dir,
                           limit=N_REQUESTS)
    t0 = time.perf_counter()
    eng = InferenceEngine(params, cfg, data.dims, data.dictionary,
                          batch_size=64, max_wait_ms=2.0)
    # trained weights may outgrow the bounds of the exact matmul route;
    # the engine then serves the runtime-checked forward, same answers
    print(f"  prepared exact-matmul route: {eng.prepared.fast}")
    d = data.dims
    compiled = eng._infer.lower(
        jnp.zeros((64, d.max_line, d.dim_input), jnp.float32),
        jnp.zeros((64, d.dim_input), jnp.float32),
        jnp.zeros((64, d.max_line), bool)).compile()
    t_compile = time.perf_counter() - t0
    print_memory("serving wave (64 requests)", compiled)
    eng.start()
    try:
        t0 = time.perf_counter()
        futures = [eng.submit(s.sentences, s.question) for s in samples]
        answers = np.array([f.result(timeout=600) for f in futures])
        t_run = time.perf_counter() - t0
    finally:
        eng.stop()
    TIMES.append(("serve", t_compile, t_run))

    # the reference: memn2n.forward compiled at the engine's wave shape,
    # over the test split's arrays in zero-padded waves.  The answers of a
    # forward over all N_REQUESTS rows at once are printed beside it, not
    # checked: at another batch shape the card's softmax may round an
    # attention probability differently in its last bit (the quantized
    # scores stay equal), and the requantized weighted sum after it can
    # turn that bit into a whole grid step, which may flip an answer.
    t = data.test
    wave = eng.batch_size
    ref_params = eng.params
    forward = jax.jit(lambda m, q, k: argmax_last(
        memn2n.forward(ref_params, m, q, k, cfg).logits, -1))

    def padded(x):
        n_pad = -N_REQUESTS % wave
        x = x[:N_REQUESTS]
        return np.concatenate([x, np.zeros((n_pad,) + x.shape[1:], x.dtype)])

    mem, que, mask = (padded(x) for x in (t.memory, t.question, t.mask))
    want = np.concatenate([
        np.asarray(forward(mem[i:i + wave], que[i:i + wave],
                           mask[i:i + wave]))
        for i in range(0, len(mem), wave)])[:N_REQUESTS]
    whole = np.asarray(forward(t.memory[:N_REQUESTS],
                               t.question[:N_REQUESTS],
                               t.mask[:N_REQUESTS]))
    print(f"  engine stats {eng.stats.snapshot()}; test accuracy of the "
          f"answers {np.mean(want == t.answer_index[:N_REQUESTS]):.4f}; "
          f"answers of one {N_REQUESTS}-row forward that differ: "
          f"{int(np.sum(whole != answers))}")
    check(eng.stats.failed_waves == 0, "no failed waves")
    check(np.array_equal(answers, want),
          f"engine answers == forward in {wave}-row waves on the card for "
          f"all {N_REQUESTS}")


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def phase_four_cards(cfg, data, gpus):
    import jax
    import jax.numpy as jnp
    from qmann_tpu.models import memn2n
    from qmann_tpu.ops import cross_entropy
    from qmann_tpu.parallel import (
        make_explicit_train_step, make_mesh, make_sharded_prepared_infer,
        make_sharded_train_step, shard_batch, shard_params,
    )

    mesh = make_mesh(4, model_parallelism=2, devices=gpus[:4])
    one = make_mesh(1, devices=gpus[:1])
    print(f"== four cards: mesh {dict(mesh.shape)}")
    params = jax.device_get(memn2n.init_params(
        cfg, data.dims, jax.random.PRNGKey(SEED)))
    batch = first_batch(data.train, cfg.size_batch)
    lr, size_b = jnp.float32(cfg.learning_rate), jnp.float32(cfg.size_batch)

    t0 = time.perf_counter()
    ref_p, ref_cost, ref_matches = jax.device_get(make_sharded_train_step(
        cfg, one)(shard_params(one, params), shard_batch(one, batch),
                  lr, size_b))
    sb = shard_batch(mesh, batch)
    sp = shard_params(mesh, params)
    for k, v in sb.items():
        print(f"  input {k} {tuple(v.shape)}: {v.sharding.spec}")
    for k, v in sp.items():
        print(f"  param {k} {tuple(v.shape)}: {v.sharding.spec}")

    for name, make in (("GSPMD step", make_sharded_train_step),
                       ("explicit shard_map step", make_explicit_train_step)):
        out_p, cost, matches = jax.device_get(make(cfg, mesh)(
            shard_params(mesh, params), sb, lr, size_b))
        # parameters after one step: 1e-5 relative (the float32 sums run
        # in another order across the mesh), with a 1e-6 absolute floor
        # for weights that sit near zero
        worst = max(float(np.max(np.abs(out_p[k] - ref_p[k])
                                 / (1e-6 + 1e-5 * np.abs(ref_p[k]))))
                    for k in ref_p)
        print(f"  {name}: cost {cost!r} (one card {ref_cost!r}), "
              f"matches {int(matches)} ({int(ref_matches)})")
        check(worst <= 1.0, f"{name}: parameters after one step match one "
                            f"card within 1e-5 relative + 1e-6 absolute "
                            f"(worst {worst:.3f} of the bound)")
        check(rel(cost, ref_cost) <= 1e-5 and int(matches)
              == int(ref_matches), f"{name}: cost and matches match")

    test = data.test
    prep = memn2n.prepare_inference(
        memn2n.init_params(cfg, data.dims, jax.random.PRNGKey(SEED)), cfg,
        max_count=float(data.dims.max_word + 1),
        max_rowsum=float(data.dims.max_word + 1))
    check(prep.fast, "prepared exact-matmul route")
    want = jax.jit(lambda m, q, a, k: cross_entropy(
        memn2n.forward_prepared(prep, m, q, k, cfg).logits, a))(
        test.memory, test.question, test.answer, test.mask)
    cost, matches, preds = make_sharded_prepared_infer(prep, cfg, mesh)(
        test.memory, test.question, test.answer, test.mask)
    print(f"  sharded serving: preds {preds.sharding.spec}, matches "
          f"{int(matches)} (one card {int(want.matches)})")
    check(np.array_equal(np.asarray(preds), np.asarray(want.pred)),
          f"sharded prepared serving predictions == one card for all "
          f"{len(test)} queries")
    TIMES.append(("four cards", 0.0, time.perf_counter() - t0))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the sharded paths, on four cards")
    args = p.parse_args(argv)
    n_cards = 4 if args.four_cards else 1

    gpus, cpu = phase_device(n_cards)
    data_dir, data = phase_data()
    cfg = flagship_config()
    if args.four_cards:
        phase_four_cards(cfg, data, gpus)
    else:
        params = phase_train(cfg, data, gpus[0], cpu)
        phase_numerics(cfg, data, gpus[0], cpu)
        phase_serve(cfg, data_dir, data, params)
    for phase, t_compile, t_run in TIMES:
        print(f"time (smoke, not a benchmark) {phase}: compile "
              f"{t_compile:.1f} s, run {t_run:.1f} s")

    import jax
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
