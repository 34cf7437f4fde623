"""ycnr_tpu — a matrix-factorization recommender framework on JAX.

A ground-up JAX/XLA rebuild of the capability set of the NodeJS engine
``ukrbublik/You-Can-Not-Recommend`` (see SURVEY.md): ALS-WR and biased-SGD
factorization of explicit ratings, confidence-weighted implicit ALS, held-out
RMSE evaluation, and masked top-N recommendation serving.

The reference's master/worker processes over shared-memory factor matrices
(SURVEY.md §1 L3-L4, C2/C3/C6c) become SPMD programs over a
``jax.sharding.Mesh``; its DB-backed row streaming (C7) becomes a blocked,
chunked-CSR layout resident in device memory (``ycnr_tpu.ops.layout``);
its native BLAS/LAPACK addons (C6a/C6b) become XLA einsums and a batched
SPD solve (one CUDA kernel on the GPU, ``ycnr_tpu.ops.cuda_solve``).
"""

__version__ = "0.1.0"

from ycnr_tpu.config import (  # noqa: F401
    ALSConfig,
    DataConfig,
    IALSConfig,
    MeshConfig,
    RunConfig,
    SGDConfig,
    get_preset,
    list_presets,
)
