"""Jitted batched trainer replicating the reference training recipe
(MemN2N/MemN2N.c:1065-2238): per-batch accumulate-then-update SGD with the
quirky per-matrix clip, lr halving schedule, optional linear start, NULL
column zeroing, last-partial-batch divisor, per-epoch validation, best
model tracking and early stopping, and the reference's metric definitions.

Design: one `jax.lax.scan` over the epoch's batches runs entirely
on-device — the analog of the reference's once-per-epoch
host-to-device staging (cuda_data_in, MemN2N/MemN2N.c:1164-1178) but with
zero per-sample kernel-launch overhead (the reference launches ~40 kernels
per sample; we launch one program per epoch).
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from qmann_tpu.config import QmannConfig
from qmann_tpu.data.babi import TaskData, VectorizedSplit
from qmann_tpu.models import memn2n
from qmann_tpu.train.optim import lr_schedule, sgd_update, zero_null_columns

Params = Dict[str, jax.Array]


@dataclasses.dataclass
class EpochMetrics:
    cost_train: float
    err_train: float
    cost_valid: float
    err_valid: float
    lr: float


@dataclasses.dataclass
class TrainResult:
    params: Params
    best_params: Optional[Params]
    history: List[EpochMetrics]
    err_test: float
    cost_test: float
    time_train: float
    time_test: float


def _batched_arrays(split: VectorizedSplit, batch_size: int):
    """Pack a split into [NB, B, ...] arrays with a per-sample validity
    mask for the final partial batch."""
    n = len(split)
    nb = -(-n // batch_size)
    pad = nb * batch_size - n

    def pack(x):
        if pad:
            x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
        return x.reshape((nb, batch_size) + x.shape[1:])

    sample_mask = np.ones(n, np.float32)
    return {
        "memory": pack(split.memory),
        "question": pack(split.question),
        "answer": pack(split.answer),
        "mask": pack(split.mask),
        "sample_mask": pack(sample_mask),
        # live-count divisor per batch (MemN2N/MemN2N.c:1222-1227)
        "size_b": pack(sample_mask).sum(axis=1).astype(np.float32),
    }


@functools.partial(jax.jit, static_argnames=("batch_size",))
def _pack_shuffled(memory, question, answer, mask, perm, batch_size: int):
    """Device-side epoch shuffle: gather the once-uploaded sample arrays
    by a [N] permutation and reshape into [nb, B, ...] batches on-device.

    The host-side alternative (fancy-index numpy + re-upload) moves the
    whole epoch to the device every epoch — ~1.3 GB/epoch for EN_JOINT's
    18000x64x256 memory tensor; here only the [N] int32 permutation
    crosses.  Values are identical to _batched_arrays on the
    permuted split (tests/test_model.py::test_device_shuffle_pack_
    matches_host).  sample_mask/size_b are permutation-invariant and are
    reused from the initial packing."""
    n = memory.shape[0]
    nb = -(-n // batch_size)
    pad = nb * batch_size - n

    def pack(x):
        x = jnp.take(x, perm, axis=0)
        if pad:
            x = jnp.concatenate(
                [x, jnp.zeros((pad,) + x.shape[1:], x.dtype)])
        return x.reshape((nb, batch_size) + x.shape[1:])

    return {"memory": pack(memory), "question": pack(question),
            "answer": pack(answer), "mask": pack(mask)}


@functools.partial(jax.jit,
                   static_argnames=("cfg", "remove_softmax", "fast_path"))
def train_epoch(params: Params, batches, lr, cfg: QmannConfig,
                remove_softmax: bool = False, fast_path: str = "force_off"):
    """Scan the SGD step over every batch of the epoch on-device.

    fast_path="force_off" (default): the runtime integer-fast-path
    `lax.cond`s are compiled out of the gradient step — inside the epoch
    while-loop each cond copies its branch operands, while the matmul
    fast branch almost never fires on training-shaped inputs.  Bit-identical either
    way by the fast path's exactness contract (tests/test_ops.py;
    tests/test_model.py::test_train_fast_path_off_is_bit_identical).
    Evaluation (`evaluate`) keeps the configured value — inference is
    where the fast routes pay (BENCH.md).

    fast_path="config": respect cfg.en_integer_fast_path as given — the
    hook that keeps the documented A/B measurable
    (bench.trace_forward --train [--no-fast-path])."""
    if fast_path == "force_off":
        cfg = cfg.replace(en_integer_fast_path=False)
    elif fast_path != "config":
        raise ValueError(f"unknown fast_path {fast_path!r}")

    def step(params, batch):
        def loss_fn(p):
            loss, met = memn2n.loss_and_metrics(
                p, batch["memory"], batch["question"], batch["answer"],
                batch["mask"], batch["sample_mask"], cfg, remove_softmax)
            return loss, met

        grads, met = jax.grad(loss_fn, has_aux=True)(params)
        params = sgd_update(params, grads, lr, batch["size_b"], cfg,
                            scale_dim=batch["mask"].shape[-1])
        params = zero_null_columns(params, cfg)
        return params, (met.cost, met.matches)

    params, (costs, matches) = jax.lax.scan(step, params, batches)
    return params, jnp.sum(costs), jnp.sum(matches)


def _pad_to(x: np.ndarray, n: int) -> np.ndarray:
    """Zero-pad the leading axis to exactly n rows (no-op if already
    there) — the one compile-discipline padding helper shared by
    eval_split and the similarity dump."""
    pad = n - x.shape[0]
    if pad <= 0:
        return x
    return np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])


@functools.partial(jax.jit, static_argnames=("cfg",))
def evaluate(params: Params, memory, question, answer, mask,
             cfg: QmannConfig):
    """Forward-only pass over a whole split (validation/test loops,
    MemN2N/MemN2N.c:1860-2160, :2264-2764)."""
    out = memn2n.forward(params, memory, question, mask, cfg)
    from qmann_tpu.ops import cross_entropy
    met = cross_entropy(out.logits, answer)
    return met.cost, met.matches, met.pred


def eval_split(params: Params, split: VectorizedSplit, cfg: QmannConfig,
               chunk: int = 1024, mesh=None) -> Tuple[float, float, np.ndarray]:
    """Returns (cost, error_rate, predictions).

    Every chunk is zero-padded to the static `chunk` size so a whole run
    compiles ONE evaluate shape (XLA compiles per shape; the remainder
    chunk and each differently-sized split would each trigger a fresh
    compile).  Zero-padded
    samples contribute exactly nothing: cost = -sum(y*probs) and the
    match test hit==1.0 are both null on an all-zero one-hot answer, and
    fully-masked samples are NaN-free by the same mechanism the padded
    training batches rely on (tests/test_model.py).

    mesh: optional jax.sharding.Mesh — chunks are placed batch-over-
    "data" / memory-banks-over-"model" and GSPMD partitions the same
    jitted evaluate (numerically identical to the single-device path,
    tests/test_parallel.py)."""
    n = len(split)
    costs, matches, preds = 0.0, 0, []
    if mesh is not None:
        from jax.sharding import NamedSharding
        from qmann_tpu.parallel.sharding import infer_specs
        specs = infer_specs(mesh, chunk, split.mask.shape[-1])

    def padded(x, name):
        x = _pad_to(x, chunk)
        if mesh is not None:
            return jax.device_put(jnp.asarray(x),
                                  NamedSharding(mesh, specs[name]))
        return jnp.asarray(x)

    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        c, m, p = evaluate(params, padded(split.memory[s:e], "memory"),
                           padded(split.question[s:e], "question"),
                           padded(split.answer[s:e], "answer"),
                           padded(split.mask[s:e], "mask"), cfg)
        costs += float(c)
        matches += int(m)
        preds.append(np.asarray(p)[:e - s])
    err = 1.0 - matches / max(n, 1)
    return costs, err, np.concatenate(preds) if preds else np.zeros(0, np.int32)


def _shard_epoch_batches(mesh, batches):
    """Place [NB, B, ...] epoch arrays on the mesh: batch over 'data',
    the memory-sentence axis over 'model' (GSPMD derives the collectives
    inside the scanned step).  Axes that do not divide the mesh stay
    replicated (the reference's tiny per-task dims don't always divide)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from qmann_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS
    from qmann_tpu.parallel.sharding import axis_if_divisible
    b = axis_if_divisible(mesh, DATA_AXIS, batches["question"].shape[1])
    m = axis_if_divisible(mesh, MODEL_AXIS, batches["mask"].shape[-1])
    specs = {
        "memory": P(None, b, m, None),
        "question": P(None, b, None),
        "answer": P(None, b, None),
        "mask": P(None, b, m),
        "sample_mask": P(None, b),
        "size_b": P(None),
    }
    return {k: jax.device_put(v, NamedSharding(mesh, specs[k]))
            for k, v in batches.items()}


def train_task(cfg: QmannConfig, data: TaskData,
               params: Optional[Params] = None,
               mesh=None, log=print) -> TrainResult:
    """Full training run for one task (the reference's per-task loop body,
    MemN2N/MemN2N.c:990-2238).  mesh: optional jax.sharding.Mesh — batches
    are sharded over it and XLA partitions the scanned train step."""
    key = jax.random.PRNGKey(cfg.seed)
    if params is None:
        params = memn2n.init_params(cfg, data.dims, key)

    n_train = len(data.train)
    batches_np = _batched_arrays(data.train, cfg.size_batch)
    batches = {k: jnp.asarray(v) for k, v in batches_np.items()}
    train_dev = None
    if cfg.en_sample_shuffled and mesh is None:
        # once-per-task upload of the unbatched sample arrays; per-epoch
        # shuffles gather them on-device (_pack_shuffled)
        train_dev = (jnp.asarray(data.train.memory),
                     jnp.asarray(data.train.question),
                     jnp.asarray(data.train.answer),
                     jnp.asarray(data.train.mask))
    if mesh is not None:
        from qmann_tpu.parallel.sharding import shard_params
        params = shard_params(mesh, params)
        batches = _shard_epoch_batches(mesh, batches)

    history: List[EpochMetrics] = []
    analyzer = None
    if cfg.en_similarity_analysis:
        from qmann_tpu.utils.analysis import SimilarityAnalyzer
        total_epochs = cfg.num_itr + (cfg.num_itr_linear_start
                                      if cfg.en_linear_start else 0)
        analyzer = SimilarityAnalyzer(cfg.similarity_analysis_dir,
                                      total_epochs)
    best_params = None
    err_valid_best, cost_valid_best = float("inf"), float("inf")
    ind_early_stopping = 0
    rng = np.random.default_rng(cfg.seed)

    t0 = time.time()
    for itr, lr, remove_softmax in lr_schedule(cfg):
        if cfg.en_sample_shuffled:
            perm = rng.permutation(n_train)
            if train_dev is not None:
                batches = {**batches,
                           **_pack_shuffled(*train_dev,
                                            jnp.asarray(perm),
                                            cfg.size_batch)}
            else:
                shuffled = VectorizedSplit(
                    data.train.memory[perm], data.train.question[perm],
                    data.train.answer[perm], data.train.n_sen[perm],
                    data.train.answer_index[perm])
                batches = {k: jnp.asarray(v) for k, v in
                           _batched_arrays(shuffled, cfg.size_batch).items()}
                if mesh is not None:
                    batches = _shard_epoch_batches(mesh, batches)
        params, cost_train, match_train = train_epoch(
            params, batches, jnp.float32(lr), cfg, remove_softmax)
        err_train = 1.0 - int(match_train) / max(n_train, 1)

        cost_valid, err_valid, _ = eval_split(params, data.valid, cfg,
                                              mesh=mesh)

        if analyzer is not None:
            # EN_SIMILARITY_ANALYSIS (MemN2N/MemN2N.c:1416-1475): dump the
            # attention softmax inputs/outputs.  similarity_probe_size
            # bounds the per-epoch dump; 0 dumps the FULL split (the
            # reference's per-sample fidelity).  Chunks are zero-padded
            # to one static shape (the eval_split compile discipline) and
            # the pad rows sliced off before recording.
            n_valid = len(data.valid)
            probe = (n_valid if cfg.similarity_probe_size == 0
                     else min(cfg.similarity_probe_size, n_valid))
            chunk = min(512, probe) if probe else 0
            for s in range(0, probe, max(chunk, 1)):
                e = min(s + chunk, probe)

                def _pad(x):
                    return jnp.asarray(_pad_to(x[s:e], chunk))

                out = memn2n.forward(
                    params, _pad(data.valid.memory),
                    _pad(data.valid.question), _pad(data.valid.mask), cfg)
                analyzer.record(itr, out.scores[:, :e - s],
                                out.attention[:, :e - s],
                                data.valid.mask[s:e], sample_offset=s)

        # best-model tracking (MemN2N/MemN2N.c:2168-2198)
        if err_valid <= err_valid_best and cost_valid <= cost_valid_best:
            ind_early_stopping = itr
            err_valid_best = err_valid
            cost_valid_best = cost_valid
            if cfg.en_save_best_model:
                best_params = jax.tree.map(lambda x: x.copy(), params)

        history.append(EpochMetrics(float(cost_train), err_train,
                                    cost_valid, err_valid, lr))
        if cfg.verbose:
            log(f"< ITR : {itr:3d} >  (train,valid,valid_best) - "
                f"loss: {float(cost_train):f}, {cost_valid:f}, "
                f"{cost_valid_best:f}, error: {err_train:f}, "
                f"{err_valid:f}, {err_valid_best:f}")

        # early stopping (MemN2N/MemN2N.c:2213-2219)
        if (cfg.en_save_best_model
                and (itr - ind_early_stopping) > cfg.count_early_stopping
                and err_valid > err_valid_best + 0.3):
            break
    time_train = time.time() - t0

    eval_params = best_params if (cfg.en_save_best_model
                                  and best_params is not None) else params
    t0 = time.time()
    cost_test, err_test, _ = eval_split(eval_params, data.test, cfg,
                                        mesh=mesh)
    time_test = time.time() - t0
    return TrainResult(params, best_params, history, err_test, cost_test,
                       time_train, time_test)
