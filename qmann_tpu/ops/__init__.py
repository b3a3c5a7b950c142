from qmann_tpu.ops.qlinear import (
    qmatvec, qembed_mat, qembed_mat_multi, qscore, qscore_partial_sum,
    qweighted_sum, qmatvec_reference,
)
from qmann_tpu.ops.attention import (
    hamming_score, binary_score, binarize, attention_score,
    unweighted_similarity, DEFAULT_CONST_SCALE,
)
from qmann_tpu.ops.softmax import (
    softmax, shift_softmax, exp_plan, exp_plan_softmax, exp2_softmax,
    apply_softmax,
)
from qmann_tpu.ops.losses import cross_entropy, squared_error, argmax_last, CEMetrics
from qmann_tpu.ops.elementwise import (
    qsum, activation, scale_apply, qmult, maxout,
)

__all__ = [
    "qmatvec", "qembed_mat", "qembed_mat_multi", "qscore",
    "qscore_partial_sum", "qweighted_sum", "qmatvec_reference",
    "hamming_score", "binary_score", "binarize", "attention_score",
    "unweighted_similarity", "DEFAULT_CONST_SCALE",
    "softmax", "shift_softmax", "exp_plan", "exp_plan_softmax",
    "exp2_softmax", "apply_softmax",
    "cross_entropy", "squared_error", "argmax_last", "CEMetrics",
    "qsum", "activation", "scale_apply", "qmult", "maxout",
]
