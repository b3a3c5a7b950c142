"""Explicit-collective training step: the full SGD step under shard_map.

The GSPMD step (sharding.make_sharded_train_step) annotates shardings and
lets XLA derive collectives.  This module is the hand-scheduled
equivalent — the whole train step runs inside ONE shard_map over the
("data", "model") mesh with every cross-device exchange written out:

  * batch sharded over "data", memory sentences over "model";
  * each hop's attention read is distributed._attention_read_local:
    psum'd softmax statistics + psum'd quantized partial sums over the
    memory shards (two scalar-per-row exchanges per hop);
  * weight gradients cross the wire through the transposes of the
    replicated->varying casts (jax.lax.pcast): parameters are cast
    varying over both mesh axes on entry to the loss, so reverse mode
    automatically psums each gradient over exactly the axes its forward
    use spanned — "data" for every weight, plus "model" for the
    memory-embedding contributions that live on sharded sentence rows;
  * the SGD update then runs replicated on every device — parameters stay
    bit-identical across the mesh without a broadcast.

check_vma=True: the static checker PROVES the outputs' replication
claims; no collective is silently mis-transposed (see distributed.py's
module docstring for the failure mode this prevents).

Scope: the default reference wiring (layer-wise tying TYPE 2, plain exp
softmax, no EN_SC_ATT/maxout/cosine) — the GSPMD path covers the rest.
Numerical equality with the single-device step is tested on the virtual
8-device mesh (tests/test_parallel.py).
"""
from __future__ import annotations

import functools
from typing import Dict

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from qmann_tpu.config import QmannConfig
from qmann_tpu.models.memn2n import _hop_weights, _query_weight
from qmann_tpu.ops import (
    activation, argmax_last, qembed_mat_multi, qmatvec, qsum,
)
from qmann_tpu.parallel.distributed import _attention_read_local, _vary
from qmann_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS
from qmann_tpu.train.optim import sgd_update, zero_null_columns

Params = Dict[str, jax.Array]


def _check_supported(cfg: QmannConfig) -> None:
    unsupported = []
    if cfg.type_weight_tying != 2:
        unsupported.append("type_weight_tying != 2")
    if cfg.en_sc_att or cfg.test_maxout or cfg.en_cosine_sim:
        unsupported.append("sc_att/maxout/cosine attention heads")
    if cfg.en_shift_based_sm or cfg.en_exp_table_based:
        unsupported.append("softmax variants")
    if cfg.en_grad_quant:
        unsupported.append("EN_GRAD_QUANT (use the GSPMD step — it "
                           "partitions the quantized backward "
                           "contractions automatically)")
    if unsupported:
        raise NotImplementedError(
            "explicit-collective step supports the default wiring; "
            f"use the GSPMD step for: {', '.join(unsupported)}")


def make_explicit_train_step(cfg: QmannConfig, mesh: Mesh):
    """One SGD step with hand-written collectives (see module docstring).

    Call as step(params, batch, lr, size_b) with the same arguments as the
    GSPMD step; params replicated, batch sharded by parallel.shard_batch.
    """
    _check_supported(cfg)
    q = cfg.en_fixed_point
    fmt_w, fmt_act = cfg.fmt_w, cfg.fmt_act
    K = cfg.num_hops
    both = (DATA_AXIS, MODEL_AXIS)

    def local_step(params, mem_l, que_l, ans_l, mask_l, smask_l, lr, size_b):
        que_v = _vary(que_l, MODEL_AXIS)
        ans_v = _vary(ans_l, MODEL_AXIS)
        smask_v = _vary(smask_l, MODEL_AXIS)

        def loss_fn(p):
            # enter varying land over both axes; the transpose of this
            # cast psums each weight gradient over both axes
            p = jax.tree.map(lambda w: _vary(w, both), p)
            u = qmatvec(_query_weight(p, cfg), que_v, fmt_w[0], fmt_w[0],
                        quantized=q, integer_inputs=not cfg.en_pe)
            hop_w = [_hop_weights(p, cfg, h) for h in range(K)]
            embeds = qembed_mat_multi(
                mem_l,
                tuple(w[0] for w in hop_w) + tuple(w[1] for w in hop_w),
                tuple(fmt_w[h] for h in range(K)) * 2,
                quantized=q, integer_inputs=True)
            u_h = u
            for h in range(K):
                o, _ = _attention_read_local(
                    embeds[h], embeds[K + h], u_h, mask_l, cfg, h,
                    MODEL_AXIS)
                o = _vary(o, MODEL_AXIS)
                if cfg.en_linear_mapping:
                    u_mapped = qmatvec(hop_w[h][2], u_h, fmt_w[h],
                                       cfg.fmt_bin, quantized=q)
                else:
                    u_mapped = u_h
                u_h = qsum(u_mapped, o, fmt_act[h], quantized=q)
                if cfg.en_non_linearity:
                    u_h = activation(u_h, "RELU", fmt_act[h], q)
            logits = qmatvec(p["W"], u_h, cfg.fmt_ds_ans, cfg.fmt_ds_ans,
                             quantized=False)
            # masked total CE over the local batch shard
            # (models.memn2n.loss_and_metrics semantics)
            logp = jax.nn.log_softmax(logits, axis=-1)
            loss = jnp.sum(-jnp.sum(ans_v * logp, axis=-1) * smask_v)
            probs = jax.lax.stop_gradient(jnp.exp(logp))
            cost = -jnp.sum(jnp.sum(ans_v * probs, axis=-1) * smask_v)
            pred = argmax_last(logits, axis=-1)
            hit = jnp.take_along_axis(ans_v, pred[..., None], axis=-1)[..., 0]
            matches = jnp.sum((hit == 1.0).astype(jnp.float32) * smask_v)
            # every "model" shard computes a replicated COPY of this loss;
            # the pcast transposes SUM the copies' cotangents, so the
            # differentiated objective is the mean over copies — each
            # gradient then comes out exactly equal to the single-copy
            # gradient, for both model-replicated paths (W, H, the query
            # chain) and model-partial paths (the A/C row contributions,
            # which reach every copy's loss through the psums)
            return loss / mesh.shape[MODEL_AXIS], (cost, matches)

        grads, (cost, matches) = jax.grad(loss_fn, has_aux=True)(params)
        # grads arrive replicated over both axes (pcast transposes);
        # the replicated update keeps every device's params bit-identical
        new_params = sgd_update(params, grads, lr, size_b, cfg)
        new_params = zero_null_columns(new_params, cfg)
        # metrics: partial over "data" (psum), numerically identical
        # across "model" copies (pmean re-certifies replication)
        cost = jax.lax.pmean(jax.lax.psum(cost, DATA_AXIS), MODEL_AXIS)
        matches = jax.lax.pmean(jax.lax.psum(matches, DATA_AXIS), MODEL_AXIS)
        return new_params, cost, matches

    def step(params, batch, lr, size_b):
        p_spec = jax.tree.map(lambda _: P(), params)
        mapped = shard_map(
            local_step, mesh=mesh,
            in_specs=(p_spec,
                      P(DATA_AXIS, MODEL_AXIS, None),   # memory
                      P(DATA_AXIS, None),               # question
                      P(DATA_AXIS, None),               # answer
                      P(DATA_AXIS, MODEL_AXIS),         # mask
                      P(DATA_AXIS),                     # sample_mask
                      P(), P()),
            out_specs=(p_spec, P(), P()),
            check_vma=True)
        return mapped(params, batch["memory"], batch["question"],
                      batch["answer"], batch["mask"], batch["sample_mask"],
                      lr, size_b)

    return jax.jit(step, donate_argnums=(0,))
