"""Multi-run trainer: R = (tasks x seeds) MemN2N models trained by ONE
jitted per-epoch program.

The reference's sweep protocols re-run a tiny model serially:
MemN2N/run.sh:6-30 is 10 loops x tasks 1-20 (200 full trainings) and
MemN2N/sweep_fixed.sh:5-8 is iwl {0,1} x 20 tasks x 2 loops.  Each run's
matmuls ([32, 114] x [114, 60]) are far too small to fill an
accelerator, so the serial protocol leaves it mostly idle.  Here every run becomes one
slice of a leading R axis: parameters are stacked [R, ...], the SGD step
is `jax.vmap`-ed over R inside the epoch `lax.scan`, and the whole
protocol runs at the wall-clock of roughly ONE training.

Semantics per run are those of `trainer.train_task` with two documented
deviations:

* Early stopping (MemN2N/MemN2N.c:2213-2219) cannot break a vmapped
  program per-run, so every run trains the full schedule.  Best-model
  tracking (the part that decides the reported test error) is identical
  and runs on-device; the epoch the reference would have early-stopped at
  is still recorded per run (`ind_best`).  Training past the stop point
  can only find an equal-or-better best snapshot.
* The per-epoch validation pass is chunked at `eval_chunk` samples; the
  metrics are exact sums, so chunking does not change results.

Batching layout: each task's train split is padded to the global
max-sample count; per-(run, batch) live-sample masks and live counts
reproduce the reference's partial-final-batch divisor
(MemN2N/MemN2N.c:1222-1227), and all-padding batches leave parameters
untouched.  Datasets are stored device-resident in int8 when the
vectorized features are small integers (bag-of-words counts + temporal
one-hots) and gathered/cast per step, so a 20-task x 10-seed protocol
keeps the HBM footprint near 1 GB.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from qmann_tpu.config import QmannConfig
from qmann_tpu.data.babi import TaskData, VectorizedSplit
from qmann_tpu.models import memn2n
from qmann_tpu.ops import cross_entropy
from qmann_tpu.train.optim import lr_schedule, sgd_update, zero_null_columns

Params = Dict[str, jax.Array]


def _compact(x: np.ndarray) -> np.ndarray:
    """Store integral small-range float features as int8 (HBM: 4x less)."""
    if (x.dtype == np.float32 and np.all(x == np.round(x))
            and x.size and -128 <= x.min() and x.max() <= 127):
        return x.astype(np.int8)
    return x


def _stack_split(splits: Sequence[VectorizedSplit]):
    """Stack T task splits into padded [T, N_max, ...] arrays + counts."""
    n_max = max(len(s) for s in splits)

    def pad(x):
        out = np.zeros((len(splits), n_max) + x[0].shape[1:], x[0].dtype)
        for t, a in enumerate(x):
            out[t, : len(a)] = a
        return out

    return {
        "memory": _compact(pad([s.memory for s in splits])),
        "question": _compact(pad([s.question for s in splits])),
        "answer": _compact(pad([s.answer for s in splits])),
        "mask": pad([s.mask for s in splits]),
        "n": np.array([len(s) for s in splits], np.int32),
    }


def _gather(data, task_id, idx):
    """data[task_id[r], idx[r, j]] -> [R, J, ...] float32 batch."""
    mem = data["memory"][task_id[:, None], idx].astype(jnp.float32)
    qst = data["question"][task_id[:, None], idx].astype(jnp.float32)
    ans = data["answer"][task_id[:, None], idx].astype(jnp.float32)
    msk = data["mask"][task_id[:, None], idx]
    return mem, qst, ans, msk


def _masked_eval_metrics(logits, answer, sm):
    """Reference valid/test metrics (cost = -sum p[y], ties-to-last argmax
    matches) restricted to live samples."""
    met = cross_entropy(logits, answer)
    probs = jax.nn.softmax(logits, axis=-1)
    cost = -jnp.sum(jnp.sum(answer * probs, axis=-1) * sm)
    hit = jnp.take_along_axis(answer, met.pred[..., None], axis=-1)[..., 0]
    matches = jnp.sum((hit == 1.0).astype(jnp.float32) * sm)
    return cost, matches


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "remove_softmax", "batch", "eval_chunk"))
def multi_epoch(params, best, best_err, best_cost, ind_best, itr,
                train_data, valid_data, task_id, perm, smask, size_b, lr,
                cfg: QmannConfig, remove_softmax: bool, batch: int,
                eval_chunk: int):
    """One epoch for all R runs: train scan + full validation + on-device
    best-model tracking (MemN2N/MemN2N.c:2168-2198)."""
    nb = perm.shape[1] // batch
    mem_len = train_data["mask"].shape[-1]

    def one_step(p, mem, qst, ans, msk, sm, sb):
        def loss_fn(pp):
            return memn2n.loss_and_metrics(
                pp, mem, qst, ans, msk, sm, cfg, remove_softmax)

        grads, met = jax.grad(loss_fn, has_aux=True)(p)
        p2 = sgd_update(p, grads, lr, jnp.maximum(sb, 1.0), cfg,
                        scale_dim=mem_len)
        p2 = zero_null_columns(p2, cfg)
        # all-padding batches (short tasks under the global batch grid)
        # leave the run's parameters untouched
        p2 = jax.tree.map(lambda a, b: jnp.where(sb > 0, a, b), p2, p)
        return p2, (met.cost, met.matches)

    def step(p, x):
        idx, sm, sb = x
        mem, qst, ans, msk = _gather(train_data, task_id, idx)
        return jax.vmap(one_step)(p, mem, qst, ans, msk, sm, sb)

    xs = (jnp.swapaxes(perm.reshape(-1, nb, batch), 0, 1), smask, size_b)
    params, (costs, matches) = jax.lax.scan(step, params, xs)
    cost_train = jnp.sum(costs, axis=0)
    match_train = jnp.sum(matches, axis=0)

    # full validation pass, chunked (exact: metrics are masked sums)
    nv = valid_data["memory"].shape[1]
    ncheck = -(-nv // eval_chunk)
    vidx = jnp.arange(ncheck * eval_chunk, dtype=jnp.int32) % nv
    vlive = (jnp.arange(ncheck * eval_chunk) < nv)

    def one_eval(p, mem, qst, ans, msk, sm):
        out = memn2n.forward(p, mem, qst, msk, cfg)
        return _masked_eval_metrics(out.logits, ans, sm)

    def vstep(carry, x):
        vi, lv = x
        mem, qst, ans, msk = _gather(valid_data, task_id, vi[None, :])
        sm = lv[None, :] & (vi[None, :] < valid_data["n"][task_id][:, None])
        c, m = jax.vmap(one_eval, in_axes=(0, 0, 0, 0, 0, 0))(
            params, mem, qst, ans, msk, sm.astype(jnp.float32))
        return (carry[0] + c, carry[1] + m), None

    zero = jnp.zeros(cost_train.shape, jnp.float32)
    (cost_valid, match_valid), _ = jax.lax.scan(
        vstep, (zero, zero),
        (vidx.reshape(ncheck, eval_chunk), vlive.reshape(ncheck, eval_chunk)))
    n_valid = valid_data["n"][task_id].astype(jnp.float32)
    err_valid = 1.0 - match_valid / jnp.maximum(n_valid, 1.0)

    # best-model tracking: err AND cost must both not regress
    improved = (err_valid <= best_err) & (cost_valid <= best_cost)
    best_err = jnp.where(improved, err_valid, best_err)
    best_cost = jnp.where(improved, cost_valid, best_cost)
    ind_best = jnp.where(improved, itr, ind_best)
    if cfg.en_save_best_model:
        def sel(b, p):
            imp = improved.reshape((-1,) + (1,) * (p.ndim - 1))
            return jnp.where(imp, p, b)

        best = jax.tree.map(sel, best, params)

    return (params, best, best_err, best_cost, ind_best,
            cost_train, match_train, cost_valid, err_valid)


@functools.partial(jax.jit, static_argnames=("cfg", "eval_chunk"))
def multi_eval(params, data, task_id, cfg: QmannConfig, eval_chunk: int):
    """Chunked forward-only pass over a stacked split for every run."""
    nv = data["memory"].shape[1]
    ncheck = -(-nv // eval_chunk)
    vidx = jnp.arange(ncheck * eval_chunk, dtype=jnp.int32) % nv
    vlive = (jnp.arange(ncheck * eval_chunk) < nv)

    def one_eval(p, mem, qst, ans, msk, sm):
        out = memn2n.forward(p, mem, qst, msk, cfg)
        return _masked_eval_metrics(out.logits, ans, sm)

    def vstep(carry, x):
        vi, lv = x
        mem, qst, ans, msk = _gather(data, task_id, vi[None, :])
        sm = lv[None, :] & (vi[None, :] < data["n"][task_id][:, None])
        c, m = jax.vmap(one_eval, in_axes=(0, 0, 0, 0, 0, 0))(
            params, mem, qst, ans, msk, sm.astype(jnp.float32))
        return (carry[0] + c, carry[1] + m), None

    zero = jnp.zeros((task_id.shape[0],), jnp.float32)
    (cost, match), _ = jax.lax.scan(
        vstep, (zero, zero),
        (vidx.reshape(ncheck, eval_chunk), vlive.reshape(ncheck, eval_chunk)))
    n = data["n"][task_id].astype(jnp.float32)
    return cost, 1.0 - match / jnp.maximum(n, 1.0)


@dataclasses.dataclass
class MultiTrainResult:
    task_indices: List[int]          # [R]
    seeds: List[int]                 # [R]
    err_test: np.ndarray             # [R]
    cost_test: np.ndarray            # [R]
    err_valid_best: np.ndarray       # [R]
    ind_best: np.ndarray             # [R] epoch of the best snapshot
    history: List[dict]              # per-epoch {cost/err train/valid} [R]
    time_train: float
    time_test: float
    params: Params                   # stacked [R, ...] final parameters
    best_params: Optional[Params]    # stacked [R, ...] best snapshots


def train_tasks_multi(cfg: QmannConfig, tasks: Dict[int, TaskData],
                      seeds: Sequence[int], eval_chunk: int = 128,
                      log=print,
                      integer_fast_path: Optional[bool] = None
                      ) -> MultiTrainResult:
    """Train every (task, seed) pair as one vmapped family.

    tasks: {task_index: TaskData} — all tasks must share feature shapes
    (load with pad_dict/pad_line, the sweep's --uniform-shapes layout).
    """
    # The fast paths stay ON here: under vmap the cond predicates are
    # batched (both branches run), but the knob also gates the STATIC
    # integer-input stacked embedding matmul (models/memn2n.py
    # integer_inputs=...), which replaces the [.., M, D, I] product
    # lattice.  The serial trainer compiles the conds out
    # (trainer.train_epoch).  Neither default is measured on the GPU
    # yet.  Bit-identical either way (the fast branch equals the
    # lattice whenever its predicate holds; test_multi run-for-run
    # equality).  integer_fast_path=False is the A/B tool.
    if integer_fast_path is None:
        integer_fast_path = True
    cfg = cfg.replace(en_integer_fast_path=integer_fast_path)
    t_indices = sorted(tasks)
    datas = [tasks[t] for t in t_indices]
    dims = datas[0].dims
    for d in datas[1:]:
        if (d.dims.dim_input != dims.dim_input
                or d.train.memory.shape[1:] != datas[0].train.memory.shape[1:]):
            raise ValueError("train_tasks_multi needs uniform task shapes; "
                             "load with pad_dict/pad_line")

    train_data = {k: jnp.asarray(v) for k, v in
                  _stack_split([d.train for d in datas]).items()}
    valid_data = {k: jnp.asarray(v) for k, v in
                  _stack_split([d.valid for d in datas]).items()}
    test_data = {k: jnp.asarray(v) for k, v in
                 _stack_split([d.test for d in datas]).items()}

    run_task = [ti for ti in range(len(t_indices)) for _ in seeds]
    run_seed = [s for _ in t_indices for s in seeds]
    R = len(run_task)
    task_id = jnp.asarray(np.array(run_task, np.int32))

    keys = jnp.stack([jax.random.PRNGKey(s) for s in run_seed])
    params = jax.vmap(lambda k: memn2n.init_params(cfg, dims, k))(keys)

    B = cfg.size_batch
    n_train = np.array([len(d.train) for d in datas], np.int32)
    nb = int(-(-n_train.max() // B))
    # per-run batching grid: identical to trainer._batched_arrays per task
    grid = np.arange(nb * B)
    perm_base = np.zeros((R, nb * B), np.int32)
    smask = np.zeros((R, nb, B), np.float32)
    for r in range(R):
        n = int(n_train[run_task[r]])
        perm_base[r, :n] = np.arange(n)
        smask[r] = (grid < n).reshape(nb, B)
    size_b = smask.sum(axis=2)                       # [R, nb]
    smask_d = jnp.asarray(np.swapaxes(smask, 0, 1))  # [nb, R, B]
    size_b_d = jnp.asarray(np.swapaxes(size_b, 0, 1))  # [nb, R]

    rngs = [np.random.default_rng(s) for s in run_seed]
    perm_const = jnp.asarray(perm_base)

    best = jax.tree.map(lambda x: x.copy(), params)
    best_err = jnp.full((R,), np.inf, jnp.float32)
    best_cost = jnp.full((R,), np.inf, jnp.float32)
    ind_best = jnp.zeros((R,), jnp.int32)

    history: List[dict] = []
    t0 = time.time()
    for itr, lr, remove_softmax in lr_schedule(cfg):
        if cfg.en_sample_shuffled:
            perm = perm_base.copy()
            for r in range(R):
                n = int(n_train[run_task[r]])
                perm[r, :n] = rngs[r].permutation(n)
            perm_d = jnp.asarray(perm)
        else:
            perm_d = perm_const
        (params, best, best_err, best_cost, ind_best,
         cost_train, match_train, cost_valid, err_valid) = multi_epoch(
            params, best, best_err, best_cost, ind_best,
            jnp.int32(itr), train_data, valid_data, task_id, perm_d,
            smask_d, size_b_d, jnp.float32(lr), cfg, remove_softmax,
            B, eval_chunk)
        err_train = 1.0 - np.asarray(match_train) / np.maximum(
            n_train[run_task], 1)
        history.append({
            "cost_train": np.asarray(cost_train),
            "err_train": err_train,
            "cost_valid": np.asarray(cost_valid),
            "err_valid": np.asarray(err_valid),
            "lr": lr,
        })
        if cfg.verbose:
            log(f"< ITR : {itr:3d} >  mean(err_train)="
                f"{float(err_train.mean()):.4f}  mean(err_valid)="
                f"{float(np.asarray(err_valid).mean()):.4f}  "
                f"mean(err_valid_best)={float(np.asarray(best_err).mean()):.4f}")
    time_train = time.time() - t0

    eval_params = best if cfg.en_save_best_model else params
    t0 = time.time()
    cost_test, err_test = multi_eval(eval_params, test_data, task_id, cfg,
                                     eval_chunk)
    time_test = time.time() - t0

    return MultiTrainResult(
        task_indices=[t_indices[t] for t in run_task],
        seeds=list(run_seed),
        err_test=np.asarray(err_test),
        cost_test=np.asarray(cost_test),
        err_valid_best=np.asarray(best_err),
        ind_best=np.asarray(ind_best),
        history=history,
        time_train=time_train,
        time_test=time_test,
        params=params,
        best_params=best if cfg.en_save_best_model else None,
    )
