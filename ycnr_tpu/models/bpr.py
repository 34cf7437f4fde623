"""BPR-MF on device: pairwise ranking for implicit feedback (Rendle 2009).

Beyond-parity capability: the reference engine (SURVEY.md C9-C11) trains
pointwise models only (ALS-WR / biased SGD / iALS). Users coming from the
wider MF ecosystem expect a pairwise ranking trainer for implicit data, so
this adds BPR on the same deterministic mini-batch machinery as
models/sgd.py: per batch, gradients are computed at batch-start parameters
and scatter-added (duplicates accumulate — `np.add.at` semantics, matching
oracle/numpy_mf.bpr_epoch_batched exactly).

Device-side negative sampling: per epoch, one uniformly-drawn negative
item per observed (user, item) positive — drawn ON DEVICE with
`jax.random`, validated against a packed rated-bits table ([n_users+1,
ceil(n_items/32)] uint32, the same bitfield trick as the serving mask,
eval/recommend.build_rated_bits). A collision (the "negative" is actually
rated) zero-weights that triple instead of resampling: static shapes, no
data-dependent control flow, and with power-law catalogs the loss is a few
percent of samples for the hottest users. Same seed => bitwise-same
factors (SURVEY.md §5 determinism contract).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ycnr_tpu.models.base import MFState


class BPRData(NamedTuple):
    """Positive pairs padded to whole batches + the rated-bits table +
    the expected-multiplicity weight vectors (read by grad_mode="emean").
    Padding points at the trash rows (u = n_users, i = n_items) and is
    masked out of every update."""

    u: jnp.ndarray      # [n_pad] int32
    i: jnp.ndarray      # [n_pad] int32
    bits: jnp.ndarray   # [n_users + 1, ceil(n_items/32)] uint32
    wu: jnp.ndarray     # [n_users + 1] f32 1/max(1, E[user triples/batch])
    wi: jnp.ndarray     # [n_items + 1] f32 1/max(1, E[item rows/batch])
    n_real: int


def pack_rated_bits(train_u, train_i, n_users: int, n_items: int):
    """Packed rated-set bitfield (host side, one pass over nnz). C++ fast
    path (native/ingest.cc ycnr_pack_bits — ~10x over np.bitwise_or.at at
    20M rows) with the NumPy fallback when no toolchain exists."""
    from ycnr_tpu.native import pack_bits_native

    out = pack_bits_native(train_u, train_i, n_users, n_items)
    if out is not None:
        return out
    W = (int(n_items) + 31) // 32
    bits = np.zeros((int(n_users) + 1, W), np.uint32)
    u = np.asarray(train_u)
    i = np.asarray(train_i)
    np.bitwise_or.at(bits, (u, i // 32),
                     (np.uint32(1) << (i % 32).astype(np.uint32)))
    return bits


def expected_weights(train_u, train_i, batch_size: int, n_users: int,
                     n_items: int):
    """grad_mode="emean" weight vectors: 1/max(1, E[batch multiplicity]).

    E[user u triples per batch]  = deg_u * B / nnz
    E[item t rows per batch]     = deg_t * B / nnz  (as the positive)
                                 + B / n_items      (as a uniform negative)

    Deterministic and precomputable (unlike "mean"'s realized counts, which
    cost ~6 extra random per-row ops per triple on device). Trash rows
    weigh 0."""
    nnz = max(len(np.asarray(train_u)), 1)
    # a batch holds at most min(B, nnz) REAL rows (smaller datasets fit in
    # one padded batch), so the expectation uses the effective batch size —
    # otherwise small-data runs underweight every update by B/nnz
    b_eff = min(int(batch_size), nnz)
    deg_u = np.bincount(np.asarray(train_u), minlength=n_users)
    deg_i = np.bincount(np.asarray(train_i), minlength=n_items)
    wu = np.zeros(int(n_users) + 1, np.float32)
    wi = np.zeros(int(n_items) + 1, np.float32)
    wu[:n_users] = 1.0 / np.maximum(deg_u * (b_eff / nnz), 1.0)
    wi[:n_items] = 1.0 / np.maximum(
        deg_i * (b_eff / nnz) + b_eff / n_items, 1.0)
    return wu, wi


def prepare_bpr_data(train_u, train_i, batch_size: int, n_users: int,
                     n_items: int, shuffle_rows_seed=None) -> BPRData:
    """``shuffle_rows_seed``: one host-side row permutation applied before
    padding — used by the "batches" shuffle mode so its FIXED batch
    composition is a random partition rather than the file order (which
    for MovieLens exports is user-sorted: contiguous user runs would
    concentrate hot users in batches)."""
    n = len(train_u)
    if shuffle_rows_seed is not None:
        order = np.random.default_rng(shuffle_rows_seed).permutation(n)
        train_u = np.asarray(train_u)[order]
        train_i = np.asarray(train_i)[order]
    n_pad = int(-(-n // batch_size) * batch_size)
    u = np.full(n_pad, n_users, np.int32)
    i = np.full(n_pad, n_items, np.int32)
    u[:n], i[:n] = train_u, train_i
    bits = pack_rated_bits(train_u, train_i, n_users, n_items)
    wu, wi = expected_weights(train_u, train_i, batch_size, n_users,
                              n_items)
    return BPRData(jnp.asarray(u), jnp.asarray(i), jnp.asarray(bits),
                   jnp.asarray(wu), jnp.asarray(wi), n)


_GRAD_MODES = ("sum", "mean", "emean")
_SHUFFLES = ("rows", "batches")


def check_shuffle(shuffle: str):
    """Shared by every shuffle-mode consumer (trainer, sharded epoch,
    tune runner) so a config typo errors instead of silently training
    in "rows" mode."""
    if shuffle not in _SHUFFLES:
        raise ValueError(f"shuffle must be one of {_SHUFFLES}, got "
                         f"{shuffle!r}")


def _check_grad_mode(grad_mode: str):
    if grad_mode not in _GRAD_MODES:
        raise ValueError(f"grad_mode must be one of {_GRAD_MODES}, got "
                         f"{grad_mode!r} (a typo would silently train "
                         f"with 'sum' semantics otherwise)")


def fuse_bpr_state(U, V, bi, wu, wi, grad_mode: str = "emean"):
    """(Uf, Vf) with the extra columns the epoch-scan carries:

        Uf = [U | 1 | wu?]        Vf = [V | bi | wi?]

    Column k (ones / bias) makes the fused dot produce x = U.(Vi-Vj) +
    (bi_i - bi_j) and makes the joint Vf update's bias column the exact
    b_i update (the stream-SGD trick). For grad_mode="emean" a second
    extra column carries the per-row expected-multiplicity weights ALONG
    WITH the factor gathers, so the weighting costs zero extra per-row
    ops (vs "mean"'s realized counts); sum/mean modes skip it (no bandwidth for a
    column they never read — grad_mode is static at trace time)."""
    _check_grad_mode(grad_mode)
    dt = U.dtype
    cu = [U, jnp.ones((U.shape[0], 1), dt)]
    cv = [V, bi[:, None].astype(dt)]
    if grad_mode == "emean":
        cu.append(wu[:, None].astype(dt))
        cv.append(wi[:, None].astype(dt))
    return jnp.concatenate(cu, axis=1), jnp.concatenate(cv, axis=1)


def bpr_epoch_core(U, V, bi, u, i, j, bits, wu, wi, lam, lr,
                   grad_mode: str):
    """Batched-triple scan with TRACED lam/lr (so the hyperparameter sweep
    can map over them as per-model data, train/tune.py). u/i/j are already
    permuted + reshaped to [n_batches, B]; wu/wi are the expected-weight
    vectors from BPRData. Returns (U, V, bi)."""
    n_users = U.shape[0] - 1
    k = U.shape[1]
    lr = jnp.asarray(lr, U.dtype)
    Uf, Vf = fuse_bpr_state(U, V, bi, wu, wi, grad_mode)

    def body(carry, batch):
        Uf, Vf = carry
        ub, ib, jb = batch
        du, dvi, dvj = bpr_batch_deltas(Uf, Vf, bits, ub, ib, jb,
                                        n_users, lam, lr, grad_mode)
        Uf = Uf.at[ub].add(du)
        Vf = Vf.at[ib].add(dvi).at[jb].add(dvj)
        return (Uf, Vf), None

    (Uf, Vf), _ = lax.scan(body, (Uf, Vf), (u, i, j))
    return Uf[:, :k], Vf[:, :k], Vf[:, k].astype(bi.dtype)


def bpr_batch_deltas(Uf, Vf, bits, ub, ib, jb, pad_row, lam, lr,
                     grad_mode: str):
    """One batch's per-row update terms over the FUSED arrays — the single
    copy of the BPR math shared by the single-chip scan above and the
    sharded body (parallel/shard._bpr_epoch_fn, which psums the scattered
    V deltas per batch). Returns (du [B,k+2], dvi [B,k+2], dvj [B,k+2]);
    callers scatter du at ub, dvi at ib, dvj at jb. ``pad_row`` is the
    first padding user index (n_users single-chip, upd per shard).

    grad_mode: "sum" (per-sample accumulation, oracle-exact), "mean"
    (realized batch multiplicities — stable but ~6 extra random per-row
    ops), "emean" (expected multiplicities from the fused weight columns
    — mean-class stability at near-sum speed; see expected_weights)."""
    _check_grad_mode(grad_mode)
    extra = 2 if grad_mode == "emean" else 1
    k = Uf.shape[1] - extra
    dt = Uf.dtype
    # column roles: 0..k-1 factors, k ones/bias, (emean) k+1 weights
    colU = jnp.concatenate([jnp.ones(k, dt), jnp.zeros(extra, dt)])
    colV = jnp.concatenate([jnp.ones(k + 1, dt),
                            jnp.zeros(extra - 1, dt)])
    pad = ub < pad_row
    # collision test: is j in u's rated set? (padding rows of `bits` are
    # all-zero, so padded samples read bit 0 — the pad mask kills them)
    word = bits[jnp.minimum(ub, bits.shape[0] - 1), jb // 32]
    hit = (word >> (jb % 32).astype(jnp.uint32)) & jnp.uint32(1)
    m = (pad & (hit == 0)).astype(dt)
    Uu = Uf[ub]
    Vi = Vf[ib]
    Vj = Vf[jb]
    # the dot runs over factor+bias columns only (slices, not a masked
    # 3-operand einsum)
    x = jnp.einsum("nk,nk->n", Uu[:, :k + 1],
                   Vi[:, :k + 1] - Vj[:, :k + 1])
    s = m * jax.nn.sigmoid(-x)
    if grad_mode == "mean":
        cu = jnp.zeros(Uf.shape[0], dt).at[ub].add(m)
        ci = jnp.zeros(Vf.shape[0], dt).at[ib].add(m).at[jb].add(m)
        wu = m / jnp.maximum(cu[ub], 1.0)
        wi = m / jnp.maximum(ci[ib], 1.0)
        wj = m / jnp.maximum(ci[jb], 1.0)
    elif grad_mode == "emean":
        # the weights arrived with the factor gathers — zero extra ops
        wu = m * Uu[:, k + 1]
        wi = m * Vi[:, k + 1]
        wj = m * Vj[:, k + 1]
    else:
        wu = wi = wj = m
    du = colU * (lr * wu[:, None] * (s[:, None] * (Vi - Vj) - lam * Uu))
    dvi = colV * (lr * wi[:, None] * (s[:, None] * Uu - lam * Vi))
    dvj = colV * (lr * wj[:, None] * (-s[:, None] * Uu - lam * Vj))
    return du, dvi, dvj


@partial(jax.jit, static_argnames=("lam", "batch_size", "grad_mode"),
         donate_argnums=(0,))
def bpr_epoch(state: MFState, data: BPRData, perm: jnp.ndarray,
              negs: jnp.ndarray, lam: float, lr, batch_size: int,
              grad_mode: str = "sum") -> MFState:
    """One epoch over all batches in the order given by ``perm`` with the
    per-triple negatives ``negs`` (same length as the padded positives —
    pass the same arrays to the oracle for parity runs).

    Math per oracle/numpy_mf.bpr_epoch_batched:
        x = U[u].(V[i]-V[j]) + bi[i] - bi[j];  s = sigmoid(-x)
    with collision-masked, grad_mode-weighted scatter-added updates. bu and
    mu stay untouched (BPR scores are per-user-invariant in them; the item
    bias captures popularity).
    """
    u = data.u[perm].reshape(-1, batch_size)
    i = data.i[perm].reshape(-1, batch_size)
    j = negs.reshape(-1, batch_size)
    U, V, bi = bpr_epoch_core(state.U, state.V, state.bi, u, i, j,
                              data.bits, data.wu, data.wi, lam, lr,
                              grad_mode)
    return state._replace(U=U, V=V, bi=bi)


def bpr_epoch_batches_core(U, V, bi, u2, i2, border, j2, bits, wu, wi,
                           lam, lr, grad_mode: str):
    """"batches" shuffle-mode epoch with TRACED lam/lr (tune sweeps map
    over them): u2/i2 are the prepared [NB, B] positives, border the
    per-epoch batch-order permutation, j2 [NB, B] fresh negatives. One
    [B] row slice per scan step — no permuted copy of the stream."""
    n_users = U.shape[0] - 1
    k = U.shape[1]
    lr = jnp.asarray(lr, U.dtype)
    Uf, Vf = fuse_bpr_state(U, V, bi, wu, wi, grad_mode)

    def body(carry, step):
        Uf, Vf = carry
        bidx, jb = step
        ub = u2[bidx]
        ib = i2[bidx]
        du, dvi, dvj = bpr_batch_deltas(Uf, Vf, bits, ub, ib, jb,
                                        n_users, lam, lr, grad_mode)
        Uf = Uf.at[ub].add(du)
        Vf = Vf.at[ib].add(dvi).at[jb].add(dvj)
        return (Uf, Vf), None

    (Uf, Vf), _ = lax.scan(body, (Uf, Vf), (border, j2))
    return Uf[:, :k], Vf[:, :k], Vf[:, k].astype(bi.dtype)


@partial(jax.jit, static_argnames=("lam", "batch_size", "grad_mode"),
         donate_argnums=(0,))
def bpr_epoch_batches(state: MFState, data: BPRData, border: jnp.ndarray,
                      negs: jnp.ndarray, lam: float, lr, batch_size: int,
                      grad_mode: str = "sum") -> MFState:
    """One epoch in "batches" shuffle mode: batch COMPOSITION is fixed at
    prepare time (rows chunked in prepared order — see prepare_bpr_data's
    shuffle_rows_seed) and only the batch ORDER reshuffles per epoch,
    while negatives stay fresh per epoch. Kills the per-epoch full-row
    device permutation AND its two apply-gathers — the rows mode's
    largest non-update cost, with the same hit@10 trajectory. Same trade as stream-SGD's
    batch-order reshuffle; fresh negative draws keep per-epoch
    stochasticity. The default (BPRConfig.shuffle).
    """
    u2 = data.u.reshape(-1, batch_size)
    i2 = data.i.reshape(-1, batch_size)
    j2 = negs.reshape(-1, batch_size)
    U, V, bi = bpr_epoch_batches_core(
        state.U, state.V, state.bi, u2, i2, border, j2, data.bits,
        data.wu, data.wi, lam, lr, grad_mode)
    return state._replace(U=U, V=V, bi=bi)


class BPRTrainer:
    """Engine-facing BPR trainer: per-epoch shuffle + fresh on-device
    negative draws, lr decay at the epoch barrier (mirrors BiasedSGD)."""

    def __init__(self, lam: float = 0.01, lr: float = 0.05,
                 lr_decay: float = 0.98, batch_size: int = 8192,
                 seed: int = 0, grad_mode: str = "sum",
                 shuffle: str = "rows"):
        check_shuffle(shuffle)
        self.lam = float(lam)
        self.lr0 = float(lr)
        self.lr_decay = float(lr_decay)
        self.batch_size = int(batch_size)
        self.seed = seed
        self.grad_mode = grad_mode
        self.shuffle = shuffle

    def lr_at(self, epoch: int) -> float:
        return self.lr0 * self.lr_decay**epoch

    def epoch(self, state: MFState, data: BPRData, epoch_idx: int,
              perm=None, negs=None) -> MFState:
        n_pad = data.u.shape[0]
        if (perm is None) != (negs is None):
            raise ValueError("pass perm AND negs together (parity runs) "
                             "or neither (fresh per-epoch draws)")
        if perm is not None:
            want = (n_pad // self.batch_size if self.shuffle == "batches"
                    else n_pad)
            if perm.shape[0] != want:
                raise ValueError(
                    f"perm length {perm.shape[0]} does not match shuffle="
                    f"{self.shuffle!r} (expected {want}: batch-order "
                    f"indices for 'batches', row indices for 'rows')")
        if perm is None:
            key = jax.random.key(self.seed + 7919 * epoch_idx)
            kp, kn = jax.random.split(key)
            negs = jax.random.randint(kn, (n_pad,), 0, state.n_items,
                                      jnp.int32)
            perm = jax.random.permutation(
                kp, n_pad // self.batch_size if self.shuffle == "batches"
                else n_pad)
        if self.shuffle == "batches":
            return bpr_epoch_batches(state, data, perm, negs, self.lam,
                                     self.lr_at(epoch_idx),
                                     self.batch_size, self.grad_mode)
        return bpr_epoch(state, data, perm, negs, self.lam,
                         self.lr_at(epoch_idx), self.batch_size,
                         self.grad_mode)
