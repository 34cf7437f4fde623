"""Gather -> Gram-accumulate -> batched-solve: the hot loop of ALS.

This is the rebuild of the reference's hottest path (SURVEY.md call stack 3.2:
per-entity `A = sum v v^T` at O(nnz * k^2), then `solve A u = b`), which the
reference runs per-user in JS with nblas/nlapack C++ BLAS (C6a/C6b). Here the
whole phase is one XLA program per block:

    gather rows of the other factor        (HBM bandwidth-bound)
    chunk Grams via batched einsum         [C_B, L, k] -> [C_B, k, k]
    segment_sum chunk->entity slot         (entities may own many chunks)
    guarded batched SPD solve              [C_B, k, k] (CUDA kernel or XLA)
    scatter solved rows into the factor

Padding needs no masks anywhere: padding gathers the all-zero row (layout.py's
zero-row trick), so its Gram/RHS contribution is exactly 0, and padding slots
solve the guarded identity system to exactly 0, keeping the trash row zero.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax


class BlockData(NamedTuple):
    """One block of a BlockedCSR as device arrays (leading axis = blocks when
    used as lax.scan xs)."""

    other_idx: jnp.ndarray  # [C_B, L] int32
    rating: jnp.ndarray  # [C_B, L] float
    chunk_seg: jnp.ndarray  # [C_B] int32
    entity_ids: jnp.ndarray  # [C_B] int32
    entity_cnt: jnp.ndarray  # [C_B] float


def chunk_gram_rhs(F_gathered: jnp.ndarray, rating: jnp.ndarray,
                   weight: Optional[jnp.ndarray] = None,
                   rhs_weight: Optional[jnp.ndarray] = None,
                   acc_dtype=None):
    """Per-chunk Gram matrices and right-hand sides.

    F_gathered: [C_B, L, k] rows of the other factor for each rating slot.
    weight:     optional per-rating Gram weight w (iALS: alpha*r, giving
                sum w v v^T); None = unweighted ALS Gram.
    rhs_weight: optional per-rating RHS weight (iALS: c = 1 + alpha*r applied
                to p=1); None = the rating itself (explicit ALS RHS).
    Returns (G [C_B, k, k], b [C_B, k]).
    """
    acc = acc_dtype or F_gathered.dtype
    lhs = F_gathered if weight is None else (
        F_gathered * weight.astype(F_gathered.dtype)[..., None])
    G = jnp.einsum("clk,clm->ckm", lhs, F_gathered,
                   preferred_element_type=acc)
    rv = rating if rhs_weight is None else rhs_weight
    b = jnp.einsum("clk,cl->ck", F_gathered, rv.astype(F_gathered.dtype),
                   preferred_element_type=acc)
    return G, b


def segment_reduce_block(G: jnp.ndarray, b: jnp.ndarray,
                         chunk_seg: jnp.ndarray, n_slots: int):
    """Sum chunk Grams/RHS into per-entity slots. chunk_seg is sorted within
    a block (builder packs sequentially; padding -> n_slots, dropped)."""
    A = jax.ops.segment_sum(G, chunk_seg, num_segments=n_slots + 1,
                            indices_are_sorted=True)[:n_slots]
    r = jax.ops.segment_sum(b, chunk_seg, num_segments=n_slots + 1,
                            indices_are_sorted=True)[:n_slots]
    return A, r


_OVERRIDE: Optional[str] = None


def solve_method(dtype, k: int, method: str = "auto",
                 backend: Optional[str] = None,
                 capability: Optional[tuple] = None,
                 toolkit: Optional[bool] = None) -> str:
    """Which batched solve runs: "cuda" (ops/cuda_solve.py, one kernel with
    the system in shared memory) or "xla" (lax.linalg cholesky + two
    triangular solves).

    "auto" takes the kernel for float32 systems of rank <=
    cuda_solve.MAX_RANK on a Hopper GPU (compute capability 9.x, the one
    architecture it is built for) where the kernel is built or nvcc can
    build it, and XLA everywhere else (float64 parity runs, the CPU, other
    GPUs, larger ranks, no CUDA toolkit); inside ``solve_override`` it
    takes the overriding method. Asking for "cuda" where the kernel cannot
    run is an error, not a fallback. ``backend``, ``capability`` and
    ``toolkit`` default to what this process finds."""
    from ycnr_tpu.ops import cuda_solve

    if method not in ("auto", "xla", "cuda"):
        raise ValueError(f"unknown solve method {method!r}")
    backend = backend or jax.default_backend()
    fits = (backend == "gpu" and jnp.dtype(dtype) == jnp.float32
            and k <= cuda_solve.MAX_RANK)
    if fits:
        fits = cuda_solve.runnable(
            cuda_solve.device_capability() if capability is None
            else capability,
            cuda_solve.toolkit_found() if toolkit is None else toolkit)
    if method == "auto":
        method = _OVERRIDE or ("cuda" if fits else "xla")
    if method == "cuda" and not fits:
        raise ValueError(
            f"the CUDA solve needs float32, rank <= {cuda_solve.MAX_RANK}, "
            f"a compute capability 9.x GPU and the CUDA toolkit (got "
            f"{jnp.dtype(dtype).name}, rank {k}, {backend})")
    return method


@contextlib.contextmanager
def solve_override(method: str):
    """Make method="auto" solves use ``method`` inside the block. Its two
    callers are chip_smoke.py's XLA reference run and the epoch A/B of
    tools/bench_solve.py: both compile whole train programs, whose solves
    take no method argument. Jit caches are cleared on entry and exit,
    since the choice is made while tracing."""
    global _OVERRIDE
    if method not in ("xla", "cuda"):
        raise ValueError(f"unknown solve method {method!r}")
    prev, _OVERRIDE = _OVERRIDE, method
    jax.clear_caches()
    try:
        yield
    finally:
        _OVERRIDE = prev
        jax.clear_caches()


def guarded_batched_solve(A: jnp.ndarray, b: jnp.ndarray, reg: jnp.ndarray,
                          method: str = "auto") -> jnp.ndarray:
    """Solve (A + diag-broadcast reg * I) x = b per batch element
    (the reference's nlapack `gesv`/`potrf`-class per-user solves,
    SURVEY.md C6b). A is symmetrised first, so callers may pass a Gram
    whose two triangles differ by rounding.

    reg: [B] per-entity ridge; callers pass lam*n_e + (n_e==0) so empty
    slots solve I x = 0 -> exactly 0 (SURVEY.md §7 hard part: cold-entity
    singularity guard).

    method: "auto" | "xla" | "cuda", resolved by ``solve_method``.
    """
    k = A.shape[-1]
    if solve_method(A.dtype, k, method) == "cuda":
        from ycnr_tpu.ops.cuda_solve import cuda_spd_solve

        return cuda_spd_solve(A, b, reg)

    eye = jnp.eye(k, dtype=A.dtype)
    A = A + reg[:, None, None] * eye
    A = 0.5 * (A + jnp.swapaxes(A, -1, -2))  # enforce symmetry
    chol = lax.linalg.cholesky(A)
    y = lax.linalg.triangular_solve(chol, b[..., None], left_side=True,
                                    lower=True)
    x = lax.linalg.triangular_solve(chol, y, left_side=True, lower=True,
                                    transpose_a=True)
    return x[..., 0]


def solve_block(F_pad: jnp.ndarray, blk: BlockData, lam: float,
                gram_weight_alpha: Optional[float] = None,
                base_gram: Optional[jnp.ndarray] = None,
                base_reg: float = 0.0, gather_bf16: bool = False):
    """Solve one block's entities against the (padded) other factor.

    Explicit ALS-WR:  lam weighting = lam * n_e; no base Gram.
    Implicit iALS:    gram_weight_alpha=alpha (w = alpha*r), base_gram=F^T F,
                      base_reg=lam (constant, not count-weighted), RHS weight
                      c = 1 + alpha*r on p=1.
    gather_bf16: gather F in bfloat16 (half the HBM bytes), accumulate in
    F_pad's dtype.
    Returns (entity_ids, new_rows [C_B, k]).
    """
    acc_dtype = F_pad.dtype
    F_src = F_pad.astype(jnp.bfloat16) if gather_bf16 else F_pad
    Fg = F_src[blk.other_idx]  # [C_B, L, k] gather
    n_slots = blk.entity_ids.shape[0]  # U_B
    if gram_weight_alpha is None:
        G, b = chunk_gram_rhs(Fg, blk.rating, acc_dtype=acc_dtype)
        A, rhs = segment_reduce_block(G, b, blk.chunk_seg, n_slots)
        reg = lam * blk.entity_cnt + (blk.entity_cnt == 0)
    else:
        w = gram_weight_alpha * blk.rating
        G, b = chunk_gram_rhs(Fg, blk.rating, weight=w, rhs_weight=1.0 + w,
                              acc_dtype=acc_dtype)
        A, rhs = segment_reduce_block(G, b, blk.chunk_seg, n_slots)
        A = A + base_gram[None]
        reg = jnp.full_like(blk.entity_cnt, base_reg)
    # Padding slots: explicit path solves I x = 0, implicit path solves
    # (G + lam I) x = 0 — both exactly 0, keeping the trash row zero.
    rows = guarded_batched_solve(A, rhs, reg)
    return blk.entity_ids, rows
