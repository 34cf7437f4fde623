"""Shared factor-model state.

The reference keeps U (users x k) and V (items x k) plus bias vectors in
shared memory visible to all workers (SURVEY.md C1/C6c). Here the state is a
single pytree of device arrays; the "shared view" across chips is a sharding
decision (ycnr_tpu.parallel), not a storage mechanism.

Padding convention: factor matrices carry one trailing all-zero row
([n+1, k]) and bias vectors one trailing zero ([n+1]) — the zero-row trick of
ycnr_tpu.ops.layout. Every op in the framework preserves these invariants.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ycnr_tpu.ops.layout import BlockedCSR


class MFState(NamedTuple):
    """Factors + biases for all three model families. ALS/iALS keep biases at
    zero and mu at 0; SGD uses all fields (r_hat = mu + b_u + b_i + p.q)."""

    U: jnp.ndarray  # [n_users + 1, k], last row zero
    V: jnp.ndarray  # [n_items + 1, k], last row zero
    bu: jnp.ndarray  # [n_users + 1], last entry zero
    bi: jnp.ndarray  # [n_items + 1], last entry zero
    mu: jnp.ndarray  # scalar global mean (0 for ALS/iALS)

    @property
    def n_users(self) -> int:
        return self.U.shape[0] - 1

    @property
    def n_items(self) -> int:
        return self.V.shape[0] - 1

    @property
    def rank(self) -> int:
        return self.U.shape[1]


def init_state(n_users: int, n_items: int, rank: int, seed: int = 0,
               scale: float = 0.1, mu: float = 0.0,
               dtype=jnp.float32) -> MFState:
    """Random-normal factor init (the reference random-inits U, V in shm —
    SURVEY.md call stack 3.2). NumPy RNG so the oracle can share the init."""
    rng = np.random.default_rng(seed)
    U = np.zeros((n_users + 1, rank), np.float64)
    V = np.zeros((n_items + 1, rank), np.float64)
    U[:n_users] = rng.normal(0.0, scale, (n_users, rank))
    V[:n_items] = rng.normal(0.0, scale, (n_items, rank))
    return MFState(
        U=jnp.asarray(U, dtype), V=jnp.asarray(V, dtype),
        bu=jnp.zeros(n_users + 1, dtype), bi=jnp.zeros(n_items + 1, dtype),
        mu=jnp.asarray(mu, dtype),
    )


def grow_state(state: MFState, n_users: int, n_items: int, seed: int = 0,
               scale: float = 0.1) -> MFState:
    """Warm-start growth: extend a trained state to a larger catalog.

    The reference retrains from the database, which silently picks up rows
    for users/items that appeared since the last run (SURVEY.md C7 streaming
    ingest); the device-resident analog is explicit — new entity rows get the
    same random-normal init as init_state (from a stream derived from both
    the seed and the old/new dims, so growth is reproducible), existing
    factor rows and biases are preserved bitwise, and the trailing zero
    padding row is maintained. Shrinking is refused: entity indices are
    positional, so a smaller catalog would silently re-map ids.
    """
    ou, oi, k = state.n_users, state.n_items, state.rank
    if n_users < ou or n_items < oi:
        raise ValueError(
            f"grow_state cannot shrink: checkpoint has {ou} users/{oi} "
            f"items, dataset has {n_users}/{n_items}")
    if n_users == ou and n_items == oi:
        return state
    dt = state.U.dtype
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, ou, oi, n_users, n_items]))
    U = np.zeros((n_users + 1, k), np.float64)
    V = np.zeros((n_items + 1, k), np.float64)
    U[:ou] = np.asarray(state.U, np.float32)[:ou]
    V[:oi] = np.asarray(state.V, np.float32)[:oi]
    U[ou:n_users] = rng.normal(0.0, scale, (n_users - ou, k))
    V[oi:n_items] = rng.normal(0.0, scale, (n_items - oi, k))
    bu = np.zeros(n_users + 1, np.float64)
    bi = np.zeros(n_items + 1, np.float64)
    bu[:ou] = np.asarray(state.bu, np.float32)[:ou]
    bi[:oi] = np.asarray(state.bi, np.float32)[:oi]
    return MFState(jnp.asarray(U, dt), jnp.asarray(V, dt),
                   jnp.asarray(bu, dt), jnp.asarray(bi, dt), state.mu)


def zero_cold_entities(state: MFState, train_u, train_i) -> MFState:
    """Zero the factor/bias rows of entities with no training ratings.

    The solvers' cold-entity contract (SURVEY.md hard-parts guard) is that
    deg==0 rows solve to exactly 0 — the sharded phases enforce it because
    they solve EVERY local row with the (deg==0) -> identity guard, but the
    single-chip layouts pack only active entities, so cold rows would keep
    their random init: train modes would diverge on cold entities and a
    never-rated item would carry a random nonzero serving score. Called once
    at training start by every mode (fresh or resumed state)."""
    au = np.zeros(state.U.shape[0], bool)
    au[np.asarray(train_u)] = True
    ai = np.zeros(state.V.shape[0], bool)
    ai[np.asarray(train_i)] = True
    au, ai = jnp.asarray(au), jnp.asarray(ai)
    return state._replace(
        U=jnp.where(au[:, None], state.U, 0),
        V=jnp.where(ai[:, None], state.V, 0),
        bu=jnp.where(au, state.bu, 0),
        bi=jnp.where(ai, state.bi, 0),
    )


def state_from_numpy(U, V, bu=None, bi=None, mu=0.0,
                     dtype=jnp.float32) -> MFState:
    """Wrap unpadded numpy factors (e.g. the oracle's) as a padded MFState."""
    n_users, k = U.shape
    n_items = V.shape[0]
    Up = np.zeros((n_users + 1, k))
    Vp = np.zeros((n_items + 1, k))
    Up[:n_users], Vp[:n_items] = U, V
    bup = np.zeros(n_users + 1)
    bip = np.zeros(n_items + 1)
    if bu is not None:
        bup[:n_users] = bu
    if bi is not None:
        bip[:n_items] = bi
    return MFState(jnp.asarray(Up, dtype), jnp.asarray(Vp, dtype),
                   jnp.asarray(bup, dtype), jnp.asarray(bip, dtype),
                   jnp.asarray(mu, dtype))


def device_layout(layout: BlockedCSR, dtype=jnp.float32) -> BlockedCSR:
    """Move a host BlockedCSR into device arrays (ratings cast to dtype)."""
    return BlockedCSR(
        other_idx=jnp.asarray(layout.other_idx),
        rating=jnp.asarray(layout.rating, dtype),
        chunk_seg=jnp.asarray(layout.chunk_seg),
        entity_ids=jnp.asarray(layout.entity_ids),
        entity_cnt=jnp.asarray(layout.entity_cnt, dtype),
    )


def unpad(state: MFState):
    """Back to plain numpy (drop padding rows) — checkpoint/inspection."""
    return (np.asarray(state.U)[:-1], np.asarray(state.V)[:-1],
            np.asarray(state.bu)[:-1], np.asarray(state.bi)[:-1],
            float(state.mu))


def predict(state: MFState, user_idx, item_idx):
    """r_hat = mu + b_u + b_i + p_u . q_i on device (Appendix A). The dot
    runs at HIGHEST precision, so a GPU does not round it through TF32."""
    return (state.mu + state.bu[user_idx] + state.bi[item_idx]
            + jnp.einsum("nk,nk->n", state.U[user_idx], state.V[item_idx],
                         precision=jax.lax.Precision.HIGHEST))


_RMSE_CHUNK = 1 << 21  # 2M rows: bounds the gathered factor rows to ~1.5 GB


def rmse_padded(state: MFState, pu, pi, pr, n_real):
    """RMSE over a pad_coo-padded held-out COO (SURVEY.md call stack 3.4).

    Padding rows point at the trash factor rows; with mu possibly nonzero the
    prediction there is mu, so padding is masked explicitly. Large COOs are
    processed in a chunked scan: unchunked, the two [nnz, k] factor gathers
    plus their product peak at ~3 * nnz * k * 4 bytes — 15 GB at ML-20M
    train-RMSE scale.
    """
    def sq_sum(u, i, r):
        err = r - predict(state, u, i)
        err = jnp.where(u < state.n_users, err, 0.0)
        return jnp.sum(err * err)

    m = pu.shape[0]
    if m <= _RMSE_CHUNK:
        total = sq_sum(pu, pi, pr)
    else:
        nb = -(-m // _RMSE_CHUNK)
        pad = nb * _RMSE_CHUNK - m
        # pad with masked rows (trash indices, rating 0)
        pu = jnp.pad(pu, (0, pad), constant_values=state.n_users)
        pi = jnp.pad(pi, (0, pad), constant_values=state.n_items)
        pr = jnp.pad(pr, (0, pad))
        total, _ = jax.lax.scan(
            lambda acc, xs: (acc + sq_sum(*xs), None),
            jnp.zeros((), pr.dtype),
            (pu.reshape(nb, _RMSE_CHUNK), pi.reshape(nb, _RMSE_CHUNK),
             pr.reshape(nb, _RMSE_CHUNK)))
    return jnp.sqrt(total / jnp.maximum(n_real, 1))


rmse_padded_jit = jax.jit(rmse_padded, static_argnames=())
