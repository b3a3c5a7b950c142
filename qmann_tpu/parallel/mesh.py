"""Device mesh construction.

The reference has no distributed layer at all (SURVEY.md section 2.6) —
its only parallelism is single-GPU kernel blocks.  This design is SPMD
over a 2-axis mesh:

  "data"  — batch data parallelism (across hosts when there are several)
  "model" — model parallelism: the memory-sentence axis (memory-bank
            sharding, the KV-cache/sequence-parallel analog for MemN2N's
            memory) and the vocabulary axis of the output layer; kept
            inside one host, whose cards reach each other over NVLink
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(n_devices: Optional[int] = None,
              model_parallelism: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ("data", "model") mesh over the available devices.

    model_parallelism defaults to the largest power of two <= 4 dividing
    the device count (memory-bank shards), with the rest on the data axis.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if model_parallelism is None:
        model_parallelism = 1
        for cand in (4, 2):
            if n % cand == 0:
                model_parallelism = cand
                break
    assert n % model_parallelism == 0, (n, model_parallelism)
    arr = np.asarray(devices).reshape(n // model_parallelism,
                                      model_parallelism)
    return Mesh(arr, (DATA_AXIS, MODEL_AXIS))


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> None:
    """Multi-host bring-up: jax.distributed.initialize.  Call once per
    process before any jax op, with the coordinator's address
    (host:port), the process count and this process's id unless the
    cluster environment supplies them; afterwards make_hybrid_mesh() lays
    out the axes so "model" stays within a process and "data" spans
    processes."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)


def make_hybrid_mesh(model_parallelism: int = 4) -> Mesh:
    """Multi-process mesh: the "model" axis (memory-bank shards + vocab
    TP) is confined to one process's devices, the "data" axis (DP)
    crosses processes.  A plain process-major reshape of the devices:
    every card of a host reaches every other at the same rate, so the
    order inside a row does not matter."""
    devices = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    n = len(devices)
    per_process = n // jax.process_count()
    assert per_process % model_parallelism == 0, (
        "the model axis must fit inside one process", per_process,
        model_parallelism)
    arr = np.asarray(devices).reshape(n // model_parallelism,
                                      model_parallelism)
    return Mesh(arr, (DATA_AXIS, MODEL_AXIS))
