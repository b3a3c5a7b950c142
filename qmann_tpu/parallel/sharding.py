"""GSPMD sharding rules and the sharded training step.

Design (the "How to Scale Your Model" recipe: pick a mesh, annotate
shardings, let XLA insert the collectives):

  batch tensors  [B, ...]        -> P("data", ...)        (DP)
  memory         [B, M, I]       -> P("data", "model", -) (memory-bank
        sharding: attention scores/softmax over the sharded M axis compile
        to distributed max/sum — the sequence/context-parallel analog)
  output layer W [I, D]          -> P("model", None)      (vocab TP: the
        logits and the CE log-softmax reduce over the sharded vocab)
  memory embeddings A/C/B [D, I] -> replicated (60x~114 floats — far below
        the cost of gathering activations; sharding them would turn every
        BoW lookup into an all-gather)
  H [D, D], scale                -> replicated

The per-batch SGD update runs inside the same jitted program, so weight
gradients are all-reduced by XLA across the data axis exactly once per
step, overlapping with backprop where profitable.
"""
from __future__ import annotations

import functools
from typing import Dict

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from qmann_tpu.config import QmannConfig
from qmann_tpu.models import memn2n
from qmann_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS
from qmann_tpu.train.optim import sgd_update, zero_null_columns

Params = Dict[str, jax.Array]


def axis_if_divisible(mesh: Mesh, axis_name: str, dim: int):
    """Shard a dimension over a mesh axis only when it divides evenly;
    otherwise replicate that dimension (the reference's tiny task dims —
    e.g. qa1's 30-word vocab — do not always divide the mesh)."""
    size = mesh.shape[axis_name]
    return axis_name if dim % size == 0 else None


def param_shardings(mesh: Mesh, params: Params) -> Dict[str, NamedSharding]:
    specs = {}
    for name, v in params.items():
        if name == "W":
            specs[name] = NamedSharding(
                mesh, P(axis_if_divisible(mesh, MODEL_AXIS, v.shape[0]),
                        None))
        elif name == "E" and v.ndim == 3:
            specs[name] = NamedSharding(mesh, P(None, None, None))
        else:
            specs[name] = NamedSharding(mesh, P(*([None] * v.ndim)))
    return specs


def batch_shardings(mesh: Mesh,
                    batch: Dict[str, jax.Array]) -> Dict[str, NamedSharding]:
    """Shardings for [B, ...] batch tensors; the batch and memory axes are
    sharded only when they divide the mesh axes."""
    b = axis_if_divisible(mesh, DATA_AXIS, batch["question"].shape[0])
    m = axis_if_divisible(mesh, MODEL_AXIS, batch["mask"].shape[-1])
    return {
        "memory": NamedSharding(mesh, P(b, m, None)),
        "question": NamedSharding(mesh, P(b, None)),
        "answer": NamedSharding(mesh, P(b, None)),
        "mask": NamedSharding(mesh, P(b, m)),
        "sample_mask": NamedSharding(mesh, P(b)),
    }


def shard_params(mesh: Mesh, params: Params) -> Params:
    specs = param_shardings(mesh, params)
    return {k: jax.device_put(v, specs[k]) for k, v in params.items()}


def shard_batch(mesh: Mesh, batch: Dict[str, jax.Array]) -> Dict[str, jax.Array]:
    shardings = batch_shardings(mesh, batch)
    return {k: jax.device_put(jnp.asarray(v), shardings[k])
            if k in shardings else jnp.asarray(v)
            for k, v in batch.items()}


def make_sharded_train_step(cfg: QmannConfig, mesh: Mesh):
    """One SGD step, jit-compiled with the sharding annotations above.
    XLA partitions the softmax over the sharded memory axis (distributed
    max + sum), the vocab-sharded output layer/CE, and all-reduces the
    weight gradients over the data axis."""

    @functools.partial(jax.jit,
                       static_argnames=("remove_softmax",),
                       donate_argnums=(0,))
    def step(params, batch, lr, size_b, remove_softmax=False):
        def loss_fn(p):
            loss, met = memn2n.loss_and_metrics(
                p, batch["memory"], batch["question"], batch["answer"],
                batch["mask"], batch["sample_mask"], cfg, remove_softmax)
            return loss, met

        grads, met = jax.grad(loss_fn, has_aux=True)(params)
        params = sgd_update(params, grads, lr, size_b, cfg,
                            scale_dim=batch["mask"].shape[-1])
        params = zero_null_columns(params, cfg)
        return params, met.cost, met.matches

    return step


def make_sharded_eval_step(cfg: QmannConfig, mesh: Mesh):
    @jax.jit
    def eval_step(params, memory, question, answer, mask):
        out = memn2n.forward(params, memory, question, mask, cfg)
        from qmann_tpu.ops import cross_entropy
        met = cross_entropy(out.logits, answer)
        return met.cost, met.matches

    return eval_step


# ---------------------------------------------------------------------------
# Sharded inference/serving
# ---------------------------------------------------------------------------

def _replicate(mesh: Mesh, v: jax.Array) -> jax.Array:
    return jax.device_put(v, NamedSharding(mesh, P(*([None] * v.ndim))))


def infer_specs(mesh: Mesh, batch: int, n_rows: int):
    """PartitionSpecs for inference inputs — batch over "data", memory
    rows over "model" (axes that don't divide stay replicated).  The one
    place the wave/chunk placement rule lives: used by
    make_sharded_prepared_infer, trainer.eval_split, and the serving
    engine's sharded waves."""
    b = axis_if_divisible(mesh, DATA_AXIS, batch)
    m = axis_if_divisible(mesh, MODEL_AXIS, n_rows)
    return {"memory": P(b, m, None), "question": P(b, None),
            "answer": P(b, None), "mask": P(b, m)}


def put_infer_inputs(mesh: Mesh, specs, **arrays):
    """device_put named inference inputs with infer_specs placements."""
    return {k: jax.device_put(jnp.asarray(v),
                              NamedSharding(mesh, specs[k]))
            for k, v in arrays.items()}


def shard_prepared(mesh: Mesh, prep):
    """Place a PreparedInference's serving-layout weights on the mesh:
    everything replicated (the whole parameter set is ~100 KB at the
    reference dims — far below the cost of gathering activations), the
    same reasoning as param_shardings for the training embeddings."""
    from qmann_tpu.models.memn2n import PreparedInference
    raw = {k: _replicate(mesh, jnp.asarray(v)) for k, v in prep.raw.items()}
    return PreparedInference(
        raw, prep.fast,
        _replicate(mesh, prep.query_wt) if prep.query_wt is not None
        else None,
        _replicate(mesh, prep.embed_wt) if prep.embed_wt is not None
        else None)


def make_sharded_prepared_infer(prep, cfg: QmannConfig, mesh: Mesh):
    """Mesh-aware serving forward on the prepared (frozen/stacked) weights:
    batch over the "data" axis, memory banks over the "model" axis (the
    KV-cache-style sharding — XLA partitions the attention softmax over
    the sharded M axis into distributed max/sum), weights replicated.

    The exact-matmul static routes and all quantization semantics are
    those of the single-device path, and the result is bit-identical to
    the single-device prepared forward
    (tests/test_parallel.py::test_sharded_prepared_infer_matches_single).

    Returns run(memory, question, answer, mask) -> (cost, matches, pred).
    """
    sprep = shard_prepared(mesh, prep)

    @jax.jit
    def infer(memory, question, answer, mask):
        out = memn2n.forward_prepared(sprep, memory, question, mask, cfg)
        from qmann_tpu.ops import cross_entropy
        met = cross_entropy(out.logits, answer)
        return met.cost, met.matches, met.pred

    def run(memory, question, answer, mask):
        specs = infer_specs(mesh, question.shape[0], mask.shape[-1])
        put = put_infer_inputs(mesh, specs, memory=memory,
                               question=question, answer=answer, mask=mask)
        return infer(put["memory"], put["question"], put["answer"],
                     put["mask"])

    return run
