"""Bucketed (segsum-free) solve phases for ALS-WR and iALS.

Same math as ops/gram.solve_block, but per-entity Grams come straight from a
batched einsum over each bucket's uniform row count — no chunk segmentation,
no scatter-add (see ops/bucketed.py for why). Used on the single-chip fast
path; results are bit-comparable to the blocked path up to fp reduction
order (parity-tested in float64).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

from ycnr_tpu.models.base import MFState
from ycnr_tpu.ops.bucketed import BucketedCSR, BucketGroup
from ycnr_tpu.ops.gram import guarded_batched_solve


def device_bucketed(groups, dtype=jnp.float32) -> BucketedCSR:
    return tuple(
        BucketGroup(jnp.asarray(g.other_idx), jnp.asarray(g.rating, dtype),
                    jnp.asarray(g.entity_ids), jnp.asarray(g.entity_cnt, dtype))
        for g in groups)


def zero_bucketed(geometry, n_entities: int, n_other: int,
                  dtype=jnp.float32) -> BucketedCSR:
    """All-padding device layout with the exact shapes build_bucketed will
    produce (geometry = ops.bucketed.bucketed_geometry(counts, ...)).

    Used to warm the epoch program (compile) BEFORE the
    real layout contents finish packing on the host — the shapes are the
    jit cache key, so the warmed executable is the one the real epoch
    reuses. Every slot is padding (other_idx -> the zero trash row,
    entity_ids -> the trash entity, cnt 0), so executing an epoch on it is
    a well-defined no-op-shaped run."""
    return tuple(
        BucketGroup(jnp.full((nb, ne_b, R), n_other, jnp.int32),
                    jnp.zeros((nb, ne_b, R), dtype),
                    jnp.full((nb, ne_b), n_entities, jnp.int32),
                    jnp.zeros((nb, ne_b), dtype))
        for R, nb, ne_b in geometry)


def bucket_solve_rows(Fg: jnp.ndarray, rr: jnp.ndarray, cnt: jnp.ndarray,
                      lam, alpha, base_gram, acc_t,
                      gather_bf16: bool) -> jnp.ndarray:
    """Gram -> guarded solve for one bucket block's gathered rows.

    THE single copy of the per-block ALS-WR/iALS normal-equation math,
    shared by the resident scan (phase_bucketed below) and the out-of-core
    streamed path (models/ooc.py) so the two are the same program body —
    their float64 factor parity is bitwise by construction.

    Fg [NE, R, k] gathered other-factor rows; rr [NE, R] ratings in the
    factor dtype; cnt [NE] float rating counts (0 for padding slots).
    """
    A, b = bucket_normal_eq(Fg, rr, alpha, acc_t, gather_bf16)
    return bucket_finish_solve(A, b, cnt, lam, alpha, base_gram)


def bucket_normal_eq(Fg, rr, alpha, acc_t, gather_bf16):
    """The accumulable part of bucket_solve_rows: per-entity partial
    normal equations over Fg's R axis — no base Gram, no regularizer, so
    chunks of an entity's R axis can be summed (models/ooc._gather_solve
    split-accumulates mega-entity blocks through this)."""
    if gather_bf16:
        rr = rr.astype(jnp.bfloat16)
    if alpha is None:
        A = jnp.einsum("urk,urm->ukm", Fg, Fg,
                       preferred_element_type=acc_t)
        b = jnp.einsum("urk,ur->uk", Fg, rr,
                       preferred_element_type=acc_t)
    else:
        w = alpha * rr
        A = jnp.einsum("urk,ur,urm->ukm", Fg, w, Fg,
                       preferred_element_type=acc_t)
        b = jnp.einsum("urk,ur->uk", Fg, (1.0 + w).astype(Fg.dtype),
                       preferred_element_type=acc_t)
        # padding rows gather the zero factor row, so the +1 in the
        # rhs weight contributes nothing there
    return A, b


def bucket_finish_solve(A, b, cnt, lam, alpha, base_gram):
    """Regularize + solve fully-accumulated normal equations."""
    if alpha is None:
        reg = lam * cnt + (cnt == 0)
    else:
        A = A + base_gram[None]
        reg = jnp.full_like(cnt, lam)
    return guarded_batched_solve(A, b, reg)


def bucket_solve_rows_split(Flo, Fhi, rr, cnt, lam, alpha, base_gram,
                            acc_t, gather_bf16) -> jnp.ndarray:
    """bucket_solve_rows on HALF-WIDTH gathered factors (rank >= 128).

    The Gram comes out block-wise (A11 = lo'lo, A12 = lo'hi, A22 = hi'hi)
    — the same per-element sums over R as the full-width einsum up to
    XLA's shape-dependent reduction blocking, so the assembled normal
    equations match the unsplit path's to f64 reduction-order tightness
    (pinned in tests/test_bucketed.py). Exists to measure whether two
    width-h gathers beat one width-2h gather (bench.py --gather-split)."""
    if gather_bf16:
        rr = rr.astype(jnp.bfloat16)
    if alpha is None:
        w = rr
        rhs_w = rr
    else:
        w = alpha * rr
        rhs_w = (1.0 + w).astype(Flo.dtype)

    def gram(a, b):
        if alpha is None:
            return jnp.einsum("urk,urm->ukm", a, b,
                              preferred_element_type=acc_t)
        return jnp.einsum("urk,ur,urm->ukm", a, w, b,
                          preferred_element_type=acc_t)

    A11, A12, A22 = gram(Flo, Flo), gram(Flo, Fhi), gram(Fhi, Fhi)
    A = jnp.concatenate([
        jnp.concatenate([A11, A12], axis=2),
        jnp.concatenate([jnp.swapaxes(A12, 1, 2), A22], axis=2)], axis=1)
    b = jnp.concatenate(
        [jnp.einsum("urk,ur->uk", Flo, rhs_w, preferred_element_type=acc_t),
         jnp.einsum("urk,ur->uk", Fhi, rhs_w, preferred_element_type=acc_t)],
        axis=1)
    if alpha is None:
        reg = lam * cnt + (cnt == 0)
    else:
        A = A + base_gram[None]
        reg = jnp.full_like(cnt, lam)
    return guarded_batched_solve(A, b, reg)


def phase_bucketed(E: jnp.ndarray, F: jnp.ndarray, groups: BucketedCSR,
                   lam: float, alpha: Optional[float] = None,
                   base_gram: Optional[jnp.ndarray] = None,
                   gather_bf16: bool = False,
                   gather_split: bool = False) -> jnp.ndarray:
    """Re-solve all entity rows of E against F, one bucket group at a time.

    gather_bf16: gather the other factor in bfloat16 (half the HBM gather
    bytes, bf16 Grams with float32 accumulation). Costs ~1e-3
    relative accuracy on the normal equations — acceptable for the 1e-3
    RMSE class, off by default for exact-parity runs.

    gather_split: gather F as two contiguous half-width tables and build
    the Gram block-wise (bitwise the same normal equations) — the rank-128
    gather-cost probe; requires an even k.
    """
    F_g = F.astype(jnp.bfloat16) if gather_bf16 else F
    if gather_split and F.shape[1] % 2:
        raise ValueError("gather_split needs an even factor width")
    if gather_split:
        h = F.shape[1] // 2
        # force two standalone contiguous tables so each gather is truly
        # width-h (a sliced view would still address 2h-strided rows)
        F_lo = jnp.asarray(F_g[:, :h])
        F_hi = jnp.asarray(F_g[:, h:])
    for g in groups:

        def body(Ec, blk):
            oi, rr, eid, cnt = blk
            if gather_split:
                rows = bucket_solve_rows_split(
                    F_lo[oi], F_hi[oi], rr, cnt, lam, alpha, base_gram,
                    E.dtype, gather_bf16)
            else:
                Fg = F_g[oi]  # [NE_b, R, k]
                rows = bucket_solve_rows(Fg, rr, cnt, lam, alpha,
                                         base_gram, E.dtype, gather_bf16)
            return Ec.at[eid].set(rows.astype(Ec.dtype)), None

        E, _ = lax.scan(body, E, tuple(g))
    return E


def als_epoch_fn(user_groups: BucketedCSR, item_groups: BucketedCSR, lam,
                 gather_bf16: bool = False, gather_split: bool = False):
    """state -> state one-epoch closure. ``lam`` may be a Python float or a
    TRACED scalar (phase_bucketed uses it arithmetically) — the single
    source of the ALS epoch body for the jitted wrappers, the fused
    multi-epoch programs, and the tune sweep."""
    def one(st: MFState) -> MFState:
        U = phase_bucketed(st.U, st.V, user_groups, lam,
                           gather_bf16=gather_bf16,
                           gather_split=gather_split)
        V = phase_bucketed(st.V, U, item_groups, lam,
                           gather_bf16=gather_bf16,
                           gather_split=gather_split)
        return st._replace(U=U, V=V)

    return one


def ials_epoch_fn(user_groups: BucketedCSR, item_groups: BucketedCSR, lam,
                  alpha, gather_bf16: bool = False,
                  gather_split: bool = False):
    """iALS analog of als_epoch_fn (global base Gram per sweep side)."""
    def one(st: MFState) -> MFState:
        GV = jnp.einsum("nk,nm->km", st.V, st.V,
                        preferred_element_type=st.V.dtype)
        U = phase_bucketed(st.U, st.V, user_groups, lam, alpha, GV,
                           gather_bf16=gather_bf16,
                           gather_split=gather_split)
        GU = jnp.einsum("nk,nm->km", U, U, preferred_element_type=U.dtype)
        V = phase_bucketed(st.V, U, item_groups, lam, alpha, GU,
                           gather_bf16=gather_bf16,
                           gather_split=gather_split)
        return st._replace(U=U, V=V)

    return one


@partial(jax.jit, static_argnames=("lam", "gather_bf16", "gather_split"),
         donate_argnums=(0,))
def als_epoch_bucketed(state: MFState, user_groups: BucketedCSR,
                       item_groups: BucketedCSR, lam: float,
                       gather_bf16: bool = False,
                       gather_split: bool = False) -> MFState:
    return als_epoch_fn(user_groups, item_groups, lam, gather_bf16,
                        gather_split)(state)


@partial(jax.jit, static_argnames=("lam", "alpha", "gather_bf16",
                                   "gather_split"),
         donate_argnums=(0,))
def ials_epoch_bucketed(state: MFState, user_groups: BucketedCSR,
                        item_groups: BucketedCSR, lam: float, alpha: float,
                        gather_bf16: bool = False,
                        gather_split: bool = False) -> MFState:
    return ials_epoch_fn(user_groups, item_groups, lam, alpha,
                         gather_bf16, gather_split)(state)


# ---------------------------------------------------------------------------
# Fused multi-epoch programs: lax.scan over epochs with the held-out RMSE
# computed in-program. One dispatch (and one host sync) per n_epochs instead
# of two per epoch, so the host-roundtrip floor of a synced dispatch is paid
# once per block (not yet measured on the GPU). Math is identical to
# calling *_epoch_bucketed in a Python loop: the scan body IS the
# single-epoch body, so the RMSE trajectory matches (parity-tested).
# ---------------------------------------------------------------------------


def _epochs_fused(state: MFState, n_epochs: int, epoch_fn, test_coo,
                  train_coo):
    """scan epochs; per-epoch outputs = (rmse_test, rmse_train?).

    train_coo None (an empty pytree, part of the trace signature) skips the
    train-RMSE pass — it gathers factors for every TRAIN rating, the same
    order of work as a solve phase, so it is strictly opt-in.
    """
    from ycnr_tpu.models.base import rmse_padded

    def body(st, _):
        st = epoch_fn(st)
        out = (rmse_padded(st, *test_coo),
               rmse_padded(st, *train_coo) if train_coo is not None else ())
        return st, out

    return lax.scan(body, state, None, length=n_epochs)


@partial(jax.jit, static_argnames=("lam", "n_epochs", "gather_bf16"),
         donate_argnums=(0,))
def als_epochs_bucketed(state: MFState, user_groups: BucketedCSR,
                        item_groups: BucketedCSR, lam: float, n_epochs: int,
                        test_coo, train_coo=None,
                        gather_bf16: bool = False):
    """n_epochs ALS-WR sweeps + per-epoch held-out RMSE in ONE program.

    test_coo/train_coo = (pu, pi, pr, n_real) as in models.base.rmse_padded
    (pad_coo-padded COO on device). Returns
    (final_state, (rmse_test[n_epochs], rmse_train[n_epochs] | ())).
    """
    return _epochs_fused(state, n_epochs,
                         als_epoch_fn(user_groups, item_groups, lam,
                                      gather_bf16), test_coo, train_coo)


@partial(jax.jit, static_argnames=("lam", "alpha", "n_epochs", "gather_bf16"),
         donate_argnums=(0,))
def ials_epochs_bucketed(state: MFState, user_groups: BucketedCSR,
                         item_groups: BucketedCSR, lam: float, alpha: float,
                         n_epochs: int, test_coo, train_coo=None,
                         gather_bf16: bool = False):
    """n_epochs iALS sweeps + per-epoch held-out RMSE in ONE program."""
    return _epochs_fused(state, n_epochs,
                         ials_epoch_fn(user_groups, item_groups, lam,
                                       alpha, gather_bf16),
                         test_coo, train_coo)
