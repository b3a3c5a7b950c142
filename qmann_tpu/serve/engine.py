"""Continuous-batching inference engine.

The reference's only serving path is the FPGA offload: a writer thread
streams the test set and a reader thread collects predicted answer
indices (MemN2N/MemN2N.c:2706-2738).  This engine generalizes
that into a continuous-batching server:

  * requests (stories + questions) enter a queue from any number of
    producer threads (or from a packet stream via serve.packet);
  * a single dispatcher thread drains the queue, pads/masks up to a fixed
    batch shape, and runs ONE jitted forward per wave on the device;
  * answers (dictionary indices) resolve each request's future.

The fixed batch shape keeps a single compiled executable hot (no
recompilation); under-full waves are padded and masked.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence

import numpy as np

from qmann_tpu.config import QmannConfig
from qmann_tpu.data.babi import DataDims, Dictionary
from qmann_tpu.serve.packet import IndexedSample


@dataclasses.dataclass
class Request:
    sentences: List[List[str]]   # story (words)
    question: List[str]
    # explicit per-sentence temporal-encoding indices (absolute input
    # columns); None derives the default dim_dict + ns - j - 1
    te_indices: Optional[List[int]] = None
    future: "Future[int]" = dataclasses.field(default_factory=Future)


@dataclasses.dataclass
class EngineStats:
    """Per-engine wave counters (bench.engine_bench reads these)."""
    waves: int = 0
    requests: int = 0
    vectorize_s: float = 0.0   # host BoW vectorization inside the dispatcher
    infer_s: float = 0.0       # blocked jit-call time (dispatch + device)
    failed_waves: int = 0

    def snapshot(self) -> Dict:
        return dataclasses.asdict(self)


class InferenceEngine:
    def __init__(self, params: Dict, cfg: QmannConfig, dims: DataDims,
                 dictionary: Dictionary, batch_size: int = 64,
                 max_wait_ms: float = 2.0, prepare: bool = True,
                 mesh=None):
        import jax
        import jax.numpy as jnp
        from qmann_tpu.models import memn2n
        from qmann_tpu.ops import argmax_last

        self.mesh = mesh
        self.cfg = cfg
        self.dims = dims
        self.dictionary = dictionary
        self.batch_size = batch_size
        self.max_wait = max_wait_ms / 1000.0
        self.params = {k: jnp.asarray(v) for k, v in params.items()}
        self._queue: "queue.Queue[Optional[Request]]" = queue.Queue()
        self._jnp = jnp
        self.stats = EngineStats()

        # freeze weights into serving layout once per engine: quantized /
        # stacked / cast, exact-matmul routes decided statically against the
        # vectorizer's feature bounds (counts are per-row word counts plus
        # one temporal one-hot, so a row's count sum is < max_word + 1).
        # prepare=False keeps the training forward (per-wave weight
        # processing + runtime fast-path dispatch) — the A/B baseline for
        # bench.engine_bench.
        self.prepared = memn2n.prepare_inference(
            self.params, cfg, max_count=float(dims.max_word + 1),
            max_rowsum=float(dims.max_word + 1)) if prepare else None
        if mesh is not None:
            from qmann_tpu.parallel.sharding import (
                shard_params, shard_prepared)
            self.params = shard_params(mesh, self.params)
            if self.prepared is not None:
                self.prepared = shard_prepared(mesh, self.prepared)
        prepared = self.prepared
        raw_params = self.params

        # the prepared weights are closed over (not jit arguments): the
        # static fast-path decision stays a Python bool and XLA embeds the
        # frozen weights in their serving layout
        @jax.jit
        def _infer(memory, question, mask):
            if prepared is not None:
                out = memn2n.forward_prepared(prepared, memory, question,
                                              mask, cfg)
            else:
                out = memn2n.forward(raw_params, memory, question, mask, cfg)
            return argmax_last(out.logits, axis=-1)

        if mesh is None:
            self._infer = _infer
        else:
            # sharded waves: batch over "data", memory banks over "model"
            # (GSPMD partitions the wave forward across the mesh); the
            # placement rule is parallel.sharding.infer_specs
            from qmann_tpu.parallel.sharding import (
                infer_specs, put_infer_inputs)
            specs = infer_specs(mesh, batch_size, dims.max_line)

            def _infer_sharded(memory, question, mask):
                put = put_infer_inputs(mesh, specs, memory=memory,
                                       question=question, mask=mask)
                return _infer(put["memory"], put["question"], put["mask"])

            self._infer = _infer_sharded
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._running = False

    # ------------------------------------------------------------------
    def start(self):
        self._running = True
        self._thread.start()
        return self

    def stop(self):
        self._running = False
        self._queue.put(None)
        self._thread.join(timeout=10)

    def submit(self, sentences: Sequence[Sequence[str]],
               question: Sequence[str],
               te_indices: Optional[Sequence[int]] = None) -> "Future[int]":
        req = Request([list(s) for s in sentences], list(question),
                      list(te_indices) if te_indices is not None else None)
        self._queue.put(req)
        return req.future

    def submit_indexed(self, sample: IndexedSample) -> "Future[int]":
        """Accept a packet-stream sample (already word indices).  The
        temporal-encoding indices transmitted in the TYPE_*_SEN_DONE
        packets are honored as-is (the reference streams them verbatim,
        MemN2N/sample.c:607-620)."""
        words = self.dictionary.words
        sentences = [[words[i] for i in s if 0 <= i < len(words)]
                     for s in sample.sentences]
        question = [words[i] for i in sample.question
                    if 0 <= i < len(words)]
        return self.submit(sentences, question, te_indices=sample.te_indices)

    def answer_word(self, index: int) -> str:
        return self.dictionary.words[index]

    # ------------------------------------------------------------------
    def _vectorize(self, reqs: List[Request]):
        d = self.dims
        n = self.batch_size
        mem = np.zeros((n, d.max_line, d.dim_input), np.float32)
        que = np.zeros((n, d.dim_input), np.float32)
        mask = np.zeros((n, d.max_line), bool)
        en_time = self.cfg.en_time
        n_words = d.dim_word - 1 if en_time else d.dim_word
        for bi, r in enumerate(reqs):
            drop = max(0, len(r.sentences) - d.max_line)
            sents = r.sentences[drop:]
            te = r.te_indices[drop:] if r.te_indices is not None else None
            ns = len(sents)
            for j, sent in enumerate(sents):
                for w in sent[:n_words]:
                    idx = self.dictionary.lookup(w)
                    if idx >= 0:
                        mem[bi, j, idx] += 1.0
                if en_time:
                    if (te is not None and j < len(te)
                            and 0 <= te[j] < d.dim_input):
                        mem[bi, j, te[j]] = 1.0  # transmitted temporal enc.
                    else:
                        mem[bi, j, d.dim_dict + ns - j - 1] = 1.0
            mask[bi, :ns] = True
            for w in r.question[:n_words]:
                idx = self.dictionary.lookup(w)
                if idx >= 0:
                    que[bi, idx] += 1.0
        return mem, que, mask

    def _loop(self):
        jnp = self._jnp
        while self._running:
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            if first is None:
                break
            wave = [first]
            # continuous batching: drain whatever arrived, up to the wave
            deadline_passed = False
            while len(wave) < self.batch_size and not deadline_passed:
                try:
                    nxt = self._queue.get(timeout=self.max_wait)
                    if nxt is None:
                        deadline_passed = True
                        self._running = False
                    else:
                        wave.append(nxt)
                except queue.Empty:
                    deadline_passed = True
            try:
                t0 = time.perf_counter()
                mem, que, mask = self._vectorize(wave)
                t1 = time.perf_counter()
                preds = np.asarray(self._infer(jnp.asarray(mem),
                                               jnp.asarray(que),
                                               jnp.asarray(mask)))
                t2 = time.perf_counter()
                self.stats.waves += 1
                self.stats.requests += len(wave)
                self.stats.vectorize_s += t1 - t0
                self.stats.infer_s += t2 - t1
            except Exception as exc:  # fail the wave, keep serving
                self.stats.failed_waves += 1
                for r in wave:
                    if not r.future.done():
                        r.future.set_exception(exc)
                continue
            for bi, r in enumerate(wave):
                r.future.set_result(int(preds[bi]))
