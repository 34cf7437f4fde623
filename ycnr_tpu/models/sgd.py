"""Biased SGD-MF on device (SURVEY.md C10/M3, Appendix A: Funk/Koren).

The reference runs hogwild SGD: workers race benign writes through shared
memory (call stack 3.3). Races are neither reproducible nor meaningful on
an accelerator; the rebuild uses *deterministic mini-batched SGD*: per batch, gradients
are computed at batch-start parameters and scatter-added (duplicate
users/items within a batch accumulate, matching `np.add.at` semantics — the
oracle implements exactly this, so parity is exact). Same seed => bitwise
same factors (SURVEY.md §5: determinism tests replace race sanitizers).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ycnr_tpu.models.base import MFState


class SGDData(NamedTuple):
    """Train COO padded to a whole number of batches (device arrays).
    Padding points at the trash rows and is masked out of every update."""

    u: jnp.ndarray  # [n_pad] int32
    i: jnp.ndarray  # [n_pad] int32
    r: jnp.ndarray  # [n_pad] float
    n_real: int


def prepare_sgd_data(train_u, train_i, train_r, batch_size: int,
                     n_users: int, n_items: int, dtype=jnp.float32) -> SGDData:
    n = len(train_r)
    n_pad = int(-(-n // batch_size) * batch_size)
    u = np.full(n_pad, n_users, np.int32)
    i = np.full(n_pad, n_items, np.int32)
    r = np.zeros(n_pad, np.float32)
    u[:n], i[:n], r[:n] = train_u, train_i, train_r
    return SGDData(jnp.asarray(u), jnp.asarray(i), jnp.asarray(r, dtype), n)


@partial(jax.jit, static_argnames=("lam", "batch_size", "grad_mode"),
         donate_argnums=(0,))
def sgd_epoch(state: MFState, data: SGDData, perm: jnp.ndarray, lam: float,
              lr: jnp.ndarray, batch_size: int,
              grad_mode: str = "sum") -> MFState:
    """One epoch over all batches in the order given by ``perm``.

    perm permutes the padded COO (the reference shuffles rating order per
    epoch, call stack 3.3); padding rides along and is masked.

    grad_mode:
      "sum"  — duplicates within a batch accumulate (per-sample SGD
               semantics; matches the oracle bit-for-bit)
      "mean" — each entity's accumulated update is divided by its batch
               multiplicity. With power-law data a hot user can appear
               hundreds of times per large batch; "sum" then takes a step
               hundreds of times larger than intended and diverges (NaNs at
               lr that is fine for "mean").
    """
    u = data.u[perm].reshape(-1, batch_size)
    i = data.i[perm].reshape(-1, batch_size)
    r = data.r[perm].reshape(-1, batch_size)
    n_users = state.n_users
    n_items = state.n_items
    lr = jnp.asarray(lr, state.U.dtype)

    def body(carry, batch):
        U, V, bu, bi = carry
        ub, ib, rb = batch
        Uu = U[ub]  # [B, k]
        Vi = V[ib]
        buu = bu[ub]
        bii = bi[ib]
        pred = state.mu + buu + bii + jnp.einsum("nk,nk->n", Uu, Vi)
        m = (ub < n_users).astype(U.dtype)  # padding mask
        e = (rb - pred) * m
        if grad_mode == "mean":
            cu = jnp.zeros(n_users + 1, U.dtype).at[ub].add(m)
            ci = jnp.zeros(n_items + 1, U.dtype).at[ib].add(m)
            wu = m / jnp.maximum(cu[ub], 1.0)
            wi = m / jnp.maximum(ci[ib], 1.0)
        else:
            wu = wi = m
        # updates per Appendix A; every term masked so trash rows stay zero
        U = U.at[ub].add(lr * wu[:, None] * (e[:, None] * Vi - lam * Uu))
        V = V.at[ib].add(lr * wi[:, None] * (e[:, None] * Uu - lam * Vi))
        bu = bu.at[ub].add(lr * wu * (e - lam * buu))
        bi = bi.at[ib].add(lr * wi * (e - lam * bii))
        return (U, V, bu, bi), None

    (U, V, bu, bi), _ = lax.scan(body, (state.U, state.V, state.bu, state.bi),
                                 (u, i, r))
    return state._replace(U=U, V=V, bu=bu, bi=bi)


class BiasedSGD:
    """Engine-facing SGD trainer with per-epoch lr decay (reference decays
    learning rate at the epoch barrier, call stack 3.3)."""

    def __init__(self, lam: float = 0.02, lr: float = 0.01,
                 lr_decay: float = 0.95, batch_size: int = 4096,
                 seed: int = 0, grad_mode: str = "sum"):
        self.lam = float(lam)
        self.lr0 = float(lr)
        self.lr_decay = float(lr_decay)
        self.batch_size = int(batch_size)
        self.seed = seed
        self.grad_mode = grad_mode

    def lr_at(self, epoch: int) -> float:
        return self.lr0 * self.lr_decay**epoch

    def epoch(self, state: MFState, data: SGDData, epoch_idx: int,
              perm=None) -> MFState:
        if perm is None:
            key = jax.random.key(self.seed + 7919 * epoch_idx)
            perm = jax.random.permutation(key, data.u.shape[0])
        return sgd_epoch(state, data, perm, self.lam, self.lr_at(epoch_idx),
                         self.batch_size, self.grad_mode)
