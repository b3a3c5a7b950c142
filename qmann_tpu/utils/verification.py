"""Cross-verification utilities — the analog of the reference's
HW_MODE 21 CPU<->GPU verification mode (MemN2N/define.h:96,108-111), whose
verification_point blocks compare the two paths element-wise against
TH_ERROR_FLOAT = 1e-6 (lib/common.h:178; e.g. dense fwd lib/layer.c:1933-1994).

Here the paired paths are:
  * the quantized model vs its float counterpart (tolerance-free report of
    where quantization changes behavior),
  * saturation/overflow statistics per tensor (the f_overflow capability,
    lib/layer.h:49,232 — allocated but disabled in the reference).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import jax
import jax.numpy as jnp
import numpy as np

from qmann_tpu.config import QmannConfig
from qmann_tpu.numerics import QFormat, fixed_max_float

TH_ERROR_FLOAT = 1e-6  # lib/common.h:178


@dataclasses.dataclass
class VerificationResult:
    name: str
    max_abs_err: float
    num_mismatch: int
    total: int

    @property
    def ok(self) -> bool:
        return self.max_abs_err <= TH_ERROR_FLOAT

    def __str__(self):
        status = "OK " if self.ok else "FAIL"
        return (f"[{status}] {self.name}: max|err|={self.max_abs_err:.3e} "
                f"mismatches {self.num_mismatch}/{self.total}")


def compare(name: str, a, b, threshold: float = TH_ERROR_FLOAT
            ) -> VerificationResult:
    a, b = np.asarray(a), np.asarray(b)
    err = np.abs(a - b)
    return VerificationResult(name, float(err.max()) if err.size else 0.0,
                              int((err > threshold).sum()), int(err.size))


def overflow_stats(x, fmt: QFormat) -> Dict[str, float]:
    """Fraction of values that would saturate / quantize to zero in fmt —
    the observability the reference's f_overflow buffers were meant for
    (CUDA_FIXED_OVERFLOW_F, lib/layer_cuda.h:214)."""
    x = np.asarray(x)
    maxf = float(fixed_max_float(fmt.iwl, fmt.frac))
    step = 2.0 ** (-fmt.frac)
    n = max(x.size, 1)
    return {
        "saturated": float((np.abs(x) > maxf).sum()) / n,
        "underflow_to_zero": float(((np.abs(x) < step) & (x != 0)).sum()) / n,
        "max_abs": float(np.abs(x).max()) if x.size else 0.0,
    }


def verify_model_quantization(cfg: QmannConfig, dims, batch,
                              key=None) -> List[VerificationResult]:
    """Quantized vs float forward on the same weights — reports where the
    Q-format changes predictions (expected to differ; the report is the
    point, as in the reference's similarity-analysis dumps)."""
    from qmann_tpu.models import memn2n
    key = key if key is not None else jax.random.PRNGKey(0)
    params = memn2n.init_params(cfg, dims, key)
    memory, question, mask = batch
    out_q = memn2n.forward(params, memory, question, mask, cfg)
    cfg_f = cfg.replace(en_fixed_point=False, attention_mode=1)
    out_f = memn2n.forward(params, memory, question, mask, cfg_f)
    pred_q = np.asarray(jnp.argmax(out_q.logits, -1))
    pred_f = np.asarray(jnp.argmax(out_f.logits, -1))
    return [
        compare("logits quant-vs-float", out_q.logits, out_f.logits,
                threshold=np.inf),
        VerificationResult("pred agreement", 0.0,
                           int((pred_q != pred_f).sum()), len(pred_q)),
    ]
