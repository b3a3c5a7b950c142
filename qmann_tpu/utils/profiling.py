"""Profiling utilities.

The reference hand-times every (layer, lifecycle-op) pair with clock()
into time_profile[10][7] (MemN2N/MemN2N.c:133-141, report :3000-3021).
Under XLA the per-layer breakdown lives in the compiler's fused program,
so the equivalents here are:
  * PhaseProfiler — wall-clock per pipeline phase (data/train/eval/...),
    the analog of the reference's data-transfer vs compute split;
  * trace() — a jax.profiler trace context producing a TensorBoard/XProf
    dump with the real per-fusion device timeline.
"""
from __future__ import annotations

import collections
import contextlib
import io
import time


class PhaseProfiler:
    def __init__(self):
        self.totals = collections.defaultdict(float)
        self.counts = collections.defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        buf = io.StringIO()
        print("< Time Profile >", file=buf)
        for name, total in sorted(self.totals.items()):
            print(f"    {name:<12s} {total:10.3f}s  "
                  f"({self.counts[name]} calls)", file=buf)
        return buf.getvalue()


@contextlib.contextmanager
def trace(log_dir: str):
    """Device-level profiling via jax.profiler (device timeline)."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str):
    """Named region visible in the XProf timeline."""
    import jax
    with jax.profiler.TraceAnnotation(name):
        yield
