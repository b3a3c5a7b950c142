"""qmann_tpu — a JAX framework for Quantized Memory-Augmented Neural
Networks (Q-MANN, AAAI-18).

A from-scratch JAX/XLA re-design with the capabilities of the reference
C/CUDA implementation (seongsikpark/Q-MANN): fixed-point (Q-format)
quantization-aware training and inference of End-to-End Memory Networks on
bAbI, including the hardware-friendly Hamming-similarity "approximate
attention", plus additions the reference lacks: batched jitted training,
SPMD sharding over device meshes, a serving engine, checkpointing, and a
real test suite.

Layering (bottom-up):
    numerics  — the Q-format fixed-point contract (build/freeze first)
    ops       — quantized ops with reference-faithful custom VJPs
    models    — functional MemN2N (and the maxout trial model)
    data      — bAbI parsing/vectorization, seeded qa1 generator
    train     — jitted batched trainer with the reference's recipe
    parallel  — mesh/sharding: DP + TP + memory-bank sharding
    serve     — batched inference engine + packet-stream feed protocol
    utils     — config, profiling, reporting, checkpointing, verification
    bench     — sweep harnesses and throughput benchmarks
"""

__version__ = "0.1.0"
