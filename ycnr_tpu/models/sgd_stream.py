"""Stream-SGD: the SGD epoch restructured around per-row memory access.

models/sgd.py processes uniformly-shuffled batches: 2 random-row gathers +
4 scatter-adds per batch. On the accelerator this was first tuned for,
every per-row random-access primitive — scatter-add, sorted or unsorted
segment_sum, cumsum — cost about the same per row regardless of table
size, so the lever was the NUMBER of per-row ops per rating (not yet
re-measured on the GPU). This module keeps the exact
per-batch update MATH (gradients at batch-start parameters, duplicate
handling per grad_mode — the reference being the hogwild stream of
SURVEY.md call stack 3.3) and restructures the epoch down to FOUR per-row
ops per rating:

* The stream is sorted by user once at prepare time, batches are
  consecutive segments, and each batch's rows are then re-sorted by item.
  The user rows a batch touches live in one contiguous window, so the
  U side is dynamic_slice tile + segment-sum into the tile + dense
  slice write (the segment indices are tile-local); the item side is a
  sorted segment-sum over the small V table + dense add. No scatters.
* User/item biases ride as a 65th factor column for the epoch (built
  once per epoch, split at the end), so the bias gathers/updates fuse
  into the factor-row ops instead of doubling the per-row op count.
* grad_mode="mean" weights depend only on batch composition, which is
  fixed at prepare time — they are precomputed host-side, removing two
  more per-row counting ops per batch.
* Per-epoch stochasticity comes from permuting the BATCH ORDER every
  epoch (classic incremental-gradient reordering; the convergence band
  vs the uniformly-shuffled reference path is pinned in
  tests/test_sgd_stream.py).

"sum" mode is numerically equivalent to models/sgd.sgd_epoch run with the
stream order as its permutation (the segment sums accumulate the same
terms, in a different association order); parity is pinned in float64 in
tests/test_sgd_stream.py. NOTE the stream order CONCENTRATES each user's
ratings, which is exactly the case "sum" handles badly (models/sgd.py
docstring) while plain "mean" under-steps hot entities (one averaged
update where the shuffled path applies ~c*B/nnz sequential ones —
measured several-fold slower convergence). The stream default is
therefore "capped" (weight min(multiplicity, cap)/multiplicity) plus
round-robin pass striping, which reproduces the shuffled-batch "sum"
trajectory without its divergence (tests/test_sgd_stream.py pins the
band).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ycnr_tpu.models.base import MFState


class StreamSGDData(NamedTuple):
    """User-sorted, per-batch-item-sorted stream as [NB, B] device arrays.

    Padding rows carry item id n_items (the zero trash row) and weight 0.
    ``ul`` is the LOCAL user row within the batch's U-tile (global id -
    u_lo); ``u_lo`` is each batch's tile start, clamped so a full
    [tile, k+1] dynamic_slice stays in bounds. ``wu``/``wi`` are the
    per-row update weights (mask for "sum", mask/multiplicity for
    "mean") — precomputed because batch composition is static.
    """

    ul: jnp.ndarray  # [NB, B] int32 local user row in the batch tile
    ib: jnp.ndarray  # [NB, B] int32 global item id, sorted per batch
    rb: jnp.ndarray  # [NB, B] float rating (pad -> 0)
    wu: jnp.ndarray  # [NB, B] float user-side update weight (pad -> 0)
    wi: jnp.ndarray  # [NB, B] float item-side update weight (pad -> 0)
    u_lo: jnp.ndarray  # [NB] int32 tile start row
    n_real: int
    tile: int  # static tile height (max user span over batches, padded)
    grad_mode: str  # weights were built for this mode


def prepare_stream_sgd(train_u, train_i, train_r, batch_size: int,
                       n_users: int, n_items: int, seed: int = 0,
                       dtype=jnp.float32, grad_mode: str = "capped",
                       tile: int | None = None, passes: int | None = None,
                       cap: int = 32, device: bool = True):
    """Build the stream (host, once per dataset).

    Returns (StreamSGDData, order) where ``order`` maps stream position ->
    original padded-COO position (exposed so tests can replay the exact
    stream through models/sgd.sgd_epoch for parity). ``tile`` forces a
    specific tile height (>= the computed one; the sharded builder aligns
    shards to a common tile).

    ``passes`` (default min(16, n_batches)) stripes each user's shuffled
    ratings round-robin over that many user-sorted sub-streams. Without it
    a hot user's whole history lands in ONE batch, so "mean" mode gives
    them a single averaged step per epoch — measured to slow convergence
    badly vs the shuffled-batch path (a user rated c times gets ~c*B/nnz
    sequential steps there). R passes restore R sequential mean steps per
    hot user per epoch while every batch still covers a contiguous user
    window (the tile property the whole layout exists for); passes=1
    reproduces the plain user-major stream.
    """
    n = len(train_r)
    if n >= 2**31 - 1:
        raise ValueError("stream prep indexes positions in int32")
    nb = -(-n // batch_size)
    n_pad = nb * batch_size
    # every host stage here is page-fault/bandwidth bound on big datasets
    # (flat profile), so indices and ids are int32 throughout — same
    # values, half the bytes
    u = np.full(n_pad, n_users, np.int32)
    i = np.full(n_pad, n_items, np.int32)
    r = np.zeros(n_pad, np.float32)
    u[:n], i[:n], r[:n] = train_u, train_i, train_r
    rng = np.random.default_rng(seed)
    # permute an int32 iota: identical sequence of swaps (and thus the
    # identical permutation) as permutation(n_pad), minus the int64 blob
    shuf = rng.permutation(np.arange(n_pad, dtype=np.int32))
    order = shuf[np.argsort(u[shuf], kind="stable")]
    us = u[order]
    R = min(16, nb) if passes is None else max(1, int(passes))
    if R > 1:
        # position within each user's (shuffled) run -> pass id; stable
        # re-sort by (pass, user) keeps user-major order within each pass
        run_starts = np.flatnonzero(
            np.r_[True, us[1:] != us[:-1]]).astype(np.int32)
        run_id = np.zeros(n_pad, np.int32)
        run_id[run_starts[1:]] = 1
        run_id = np.cumsum(run_id, dtype=np.int32)
        pos = np.arange(n_pad, dtype=np.int32) - run_starts[run_id]
        p = (pos % R).astype(np.int8 if R <= 127 else np.int32)
        # order is already user-sorted, so ONE stable sort by pass keeps
        # user-major order within each pass (a 3-key lexsort costs ~2x)
        order = order[np.argsort(p, kind="stable")]
        # pad every pass to a whole number of batches (sentinel -1 ->
        # trash ids): a batch straddling a pass boundary would otherwise
        # span the full user-id range and blow the tile to n_users
        # (measured: ML-20M tile 138k and +56% epoch time without this)
        pv = np.sort(p)
        seg_end = np.flatnonzero(np.r_[pv[1:] != pv[:-1], True]) + 1
        parts = []
        for ch in np.split(order, seg_end[:-1]):
            parts.append(ch)
            short = (-len(ch)) % batch_size
            if short:
                parts.append(np.full(short, -1, np.int32))
        order = np.concatenate(parts)
        nb = len(order) // batch_size
        n_pad = nb * batch_size

    def take(a, fill):
        out = a[np.maximum(order, 0)].copy()
        out[order < 0] = fill
        return out

    us = take(u, n_users)

    def _run_multiplicity(keys):
        """count of equal consecutive keys within each batch, broadcast per
        element (O(n)). Runs break at batch boundaries directly instead of
        via a composite (batch, key) int64 key — three full-length int64
        temporaries fewer on this page-fault-bound host."""
        brk = np.empty(len(keys), np.bool_)
        brk[0] = True
        np.not_equal(keys[1:], keys[:-1], out=brk[1:])
        brk[::batch_size] = True
        starts = np.flatnonzero(brk)
        lens = np.diff(np.r_[starts, len(keys)]).astype(np.int32)
        return np.repeat(lens, lens)

    # host weight dtype: f64 only when training in f64 (oracle parity);
    # f32 runs skip ~1 GB of f64 temporaries at Netflix scale
    wdt = np.float64 if jnp.dtype(dtype) == jnp.float64 else np.float32
    # user-side 1/multiplicity per batch, computed on the user-major
    # stream (user runs are contiguous within a batch: passes are padded
    # to batch boundaries above)
    if grad_mode in ("mean", "capped"):
        wu = wdt(1.0) / _run_multiplicity(us).astype(wdt)
    # re-sort each batch's rows by item id (keeps the item-side segment
    # sum on the sorted fast path with no runtime permute)
    isort = np.argsort(take(i, n_items).reshape(nb, batch_size), axis=1,
                       kind="stable")
    order = order.reshape(nb, batch_size)[
        np.arange(nb)[:, None], isort].reshape(-1)
    us, is_, rs = take(u, n_users), take(i, n_items), take(r, 0.0)

    first = us.reshape(nb, batch_size).min(axis=1)
    last = us.reshape(nb, batch_size).max(axis=1)
    need = int((last - first).max(initial=0)) + 1
    if tile is None:
        tile = min(-(-need // 8) * 8, n_users + 1)  # sublane multiple
    elif tile < min(need, n_users + 1):
        raise ValueError(f"tile override {tile} < required {need}")
    tile = min(tile, n_users + 1)
    u_lo = np.minimum(first, n_users + 1 - tile).astype(np.int32)
    ul = us - np.repeat(u_lo, batch_size)  # int32 - int32

    m = (is_ < n_items).astype(wdt)
    if grad_mode in ("mean", "capped"):
        # "mean": weight 1/mult (entity's batch update = mean of its row
        # grads — every entity gets effective lr*1 per batch). "capped":
        # weight min(mult, cap)/mult — effective lr*min(mult, cap),
        # matching the shuffled-batch "sum" path's natural multiplicity
        # (~c_u*B/nnz, bounded) without its hot-entity divergence;
        # measured to reproduce batched-sum convergence where "mean" is
        # several times slower per epoch.
        t = wdt(1.0) if grad_mode == "mean" else wdt(cap)
        wu_m = wu  # 1/mult from the pre-sort pass
        wu = (np.minimum(wdt(1.0) / wu_m, t) * wu_m).reshape(
            nb, batch_size)[np.arange(nb)[:, None], isort].reshape(-1) * m
        wi_m = wdt(1.0) / _run_multiplicity(is_).astype(wdt)
        wi = np.minimum(wdt(1.0) / wi_m, t) * wi_m * m
    else:
        wu = wi = m
    # device=False keeps the stream on host (numpy) for the out-of-core
    # epoch (sgd_stream_epoch_ooc) — HBM then holds only the factors
    put = jax.device_put if device else np.ascontiguousarray
    ndt = np.dtype(dtype)
    data = StreamSGDData(
        ul=put(ul.reshape(nb, batch_size)),
        ib=put(is_.reshape(nb, batch_size).astype(np.int32)),
        rb=put(rs.reshape(nb, batch_size).astype(ndt)),
        wu=put(wu.reshape(nb, batch_size).astype(ndt)),
        wi=put(wi.reshape(nb, batch_size).astype(ndt)),
        u_lo=put(u_lo),
        n_real=n, tile=tile, grad_mode=grad_mode)
    return data, order


def _batch_update(Ue, Ve, mu, one_col, lam_, lr, tile: int, n_items: int,
                  ulb, ibb, rbb, wub, wib, lo):
    """THE single copy of the per-batch update math, shared by the
    resident epoch, the out-of-core streamed epoch, and the compact-wire
    epochs (flat and decoded inputs meet here) so their float64 parity is
    bitwise by construction — the same association order either way.

    Per rating, exactly 4 per-row ops: tile gather, V gather, tile
    segment-sum, item segment-sum (sorted). Biases ride as column k of
    the extended factor tables."""
    k = Ue.shape[1] - 1
    zero = jnp.zeros((), lo.dtype)  # match index dtypes (x64 tests)
    Ut = lax.dynamic_slice(Ue, (lo, zero), (tile, k + 1))
    ue = Ut[ulb]  # [B, k+1] gather from the tile        (per-row op 1)
    ve = Ve[ibb]  # [B, k+1] gather from the item table  (per-row op 2)
    pred = (mu + ue[:, k] + ve[:, k]
            + jnp.einsum("nk,nk->n", ue[:, :k], ve[:, :k]))
    e = rbb - pred  # weights carry the padding mask
    # gradient rows, uniform across factor cols and the bias col:
    # replacing the partner's bias col with 1 makes  e*partner - lam*own
    # compute the bias update in the same fused elementwise expression
    ve1 = ve * (1 - one_col) + one_col
    ue1 = ue * (1 - one_col) + one_col
    gu = (lr * wub)[:, None] * (e[:, None] * ve1 - lam_ * ue)
    gv = (lr * wib)[:, None] * (e[:, None] * ue1 - lam_ * ve)
    dU = jax.ops.segment_sum(gu, ulb, num_segments=tile)  # (op 3)
    dV = jax.ops.segment_sum(gv, ibb, num_segments=n_items + 1,
                             indices_are_sorted=True)     # (op 4)
    Ue = lax.dynamic_update_slice(Ue, Ut + dU, (lo, zero))
    Ve = Ve + dV
    return Ue, Ve


def _bias_col(Ue):
    # [1, k+1] selector of the bias column (column k)
    k = Ue.shape[1] - 1
    return (jax.lax.broadcasted_iota(jnp.int32, (1, k + 1), 1)
            == k).astype(Ue.dtype)


def _epoch_scan(Ue, Ve, mu, xs, lam_, lr, tile: int, n_items: int):
    """Scan the shared batch body over xs = (ul, ib, rb, wu, wi, u_lo)."""
    one_col = _bias_col(Ue)

    def body(carry, xs_b):
        return _batch_update(*carry, mu, one_col, lam_, lr, tile,
                             n_items, *xs_b), None

    (Ue, Ve), _ = lax.scan(body, (Ue, Ve), xs)
    return Ue, Ve


def stream_epoch_core(state: MFState, ul, ib, rb, wu, wi, u_lo, order,
                      lam, lr, tile: int) -> MFState:
    """One epoch over the stream in batch order ``order`` ([NB] int32
    permutation — reshuffled per epoch for stochasticity).

    Unjitted core: ``lam``/``lr`` are plain arithmetic inputs, so callers
    may pass them TRACED (the tune sweep runs many (lam, lr) models inside
    one program) — the jitted wrapper below keeps lam static for the
    single-model path.
    """
    lr = jnp.asarray(lr, state.U.dtype)
    lam_ = jnp.asarray(lam, state.U.dtype)
    # extended tables: factors with the bias as column k
    Ue = jnp.concatenate([state.U, state.bu[:, None]], axis=1)
    Ve = jnp.concatenate([state.V, state.bi[:, None]], axis=1)
    # materialize the epoch's batch order once (leading-axis gather)
    xs = (ul[order], ib[order], rb[order], wu[order], wi[order],
          u_lo[order])
    Ue, Ve = _epoch_scan(Ue, Ve, state.mu, xs, lam_, lr, tile,
                         state.n_items)
    k = state.U.shape[1]
    return state._replace(U=Ue[:, :k], V=Ve[:, :k],
                          bu=Ue[:, k], bi=Ve[:, k])


@partial(jax.jit, static_argnames=("lam", "tile"), donate_argnums=(0,))
def sgd_stream_epoch(state: MFState, ul, ib, rb, wu, wi, u_lo, order,
                     lam: float, lr, tile: int) -> MFState:
    return stream_epoch_core(state, ul, ib, rb, wu, wi, u_lo, order,
                             lam, lr, tile)


# ------------------------- out-of-core streamed epoch (SURVEY §3.3) ----
#
# The reference streams the SGD rating partition from the DB for every
# worker; the resident path above instead holds the whole [NB, B] stream
# in HBM (~20 B/rating — the bound models/ooc.py:4-12 documents for ALS
# applies here at ~2.5x the rate). The OOC tier keeps the stream on HOST
# (numpy/memmap) and ships permuted chunks of batches ahead of the scan,
# exactly like models/ooc.phase_packed's streamed tier: HBM holds only
# the extended factor tables + (prefetch+1) in-flight chunks. Where the
# host link is slow the streamed epoch is bound by it; on a PCIe-class
# link it approaches the resident epoch. Parity: bitwise vs the resident
# epoch in float64 for the SAME batch order (shared _epoch_scan body).

_SGD_CHUNK_TARGET_BYTES = 48 * 2**20


@partial(jax.jit, static_argnames=("lam", "tile", "n_items"),
         donate_argnums=(0, 1))
def _sgd_chunk_step(Ue, Ve, mu, ul, ib, rb, wu, wi, u_lo,
                    lam: float, lr, tile: int, n_items: int):
    lam_ = jnp.asarray(lam, Ue.dtype)
    return _epoch_scan(Ue, Ve, mu, (ul, ib, rb, wu, wi, u_lo),
                       lam_, lr.astype(Ue.dtype), tile, n_items)


def sgd_stream_epoch_ooc(state: MFState, data: StreamSGDData, order,
                         lam: float, lr,
                         chunk_batches: int | None = None,
                         prefetch: int = 2) -> MFState:
    """One stream-SGD epoch with the stream resident on HOST.

    ``data`` holds numpy (or memmapped) arrays — prepare_stream_sgd with
    device=False. ``order`` is the epoch's [NB] batch permutation; the
    host gathers each chunk's batches in permuted order (host-bandwidth
    cheap next to the wire), so the trajectory is IDENTICAL to the
    resident epoch under the same order. The final short chunk is padded
    with zero-weight no-op batches to keep one compiled chunk shape.
    """
    names = ("ul", "ib", "rb", "wu", "wi", "u_lo")
    NB, B = data.ul.shape
    if chunk_batches is None:
        per_batch = 4 + B * sum(
            np.asarray(getattr(data, n)).dtype.itemsize
            for n in names[:-1])
        chunk_batches = max(1, min(NB, _SGD_CHUNK_TARGET_BYTES
                                   // per_batch))
    order = np.asarray(order, np.int64)
    k = state.U.shape[1]
    Ue = jnp.concatenate([state.U, state.bu[:, None]], axis=1)
    Ve = jnp.concatenate([state.V, state.bi[:, None]], axis=1)
    lr_ = jnp.asarray(lr, Ue.dtype)
    mu = jnp.asarray(state.mu, Ue.dtype)

    def step(Ue, Ve, ch):
        return _sgd_chunk_step(Ue, Ve, mu, *ch, lam, lr_, data.tile,
                               state.n_items)

    q = []
    for c0 in range(0, NB, chunk_batches):
        sel = order[c0:c0 + chunk_batches]
        pad = chunk_batches - len(sel)
        ch = []
        for n in names:
            a = np.asarray(getattr(data, n))[sel]
            if pad:  # zero weights make the pad batches exact no-ops
                a = np.concatenate(
                    [a, np.zeros((pad,) + a.shape[1:], a.dtype)])
            ch.append(jax.device_put(a))
        q.append(tuple(ch))
        if len(q) > prefetch:
            Ue, Ve = step(Ue, Ve, q.pop(0))
    for ch in q:
        Ue, Ve = step(Ue, Ve, ch)
    return state._replace(U=Ue[:, :k], V=Ve[:, :k],
                          bu=Ue[:, k], bi=Ve[:, k])


# ------------------- compact-wire epochs (the SGD pin tier) ------------
#
# ops/sgd_wire.CompactStreamSGD is the 5-9 B/rating encoding of the flat
# stream (u16 tile-local users, delta-coded items with an overflow
# side-channel, int8 half-star ratings, u16 multiplicities with weights
# recomputed on device). The decode below is the device twin of
# ops/sgd_wire.decode_compact — the wire builder validates the two agree
# bitwise on host — and its output feeds the SAME _batch_update body as
# the flat epochs, so float64 trajectories are bitwise across all four
# paths (flat/compact x resident/streamed) under one batch order.
# Decode cost per rating: ONE per-row op (the item-delta cumsum) on top
# of the epoch's four; the overflow scatter touches H << B rows and the
# weight recompute is elementwise.


def _decode_compact_batch(ulb, ilob, hp, hv, rqb, mub, mib,
                          n_items: int, cap: int, grad_mode: str,
                          rating_kind: str, dtype):
    """One batch of wire rows -> the flat (ul, ib, rb, wu, wi) arrays."""
    ul = ulb.astype(jnp.int32)
    # item ids: low bits + sparse high-bit corrections, then prefix-sum
    # the deltas (element 0 carried the absolute id). Padding (0, 0)
    # side-channel entries add 0 at position 0 — an exact no-op.
    d = ilob.astype(jnp.int32).at[hp].add(jnp.left_shift(hv, 16))
    ib = jnp.cumsum(d)                       # (the +1 per-row op)
    mask = (ib < n_items).astype(dtype)
    if rating_kind == "half":
        rb = rqb.astype(dtype) * jnp.asarray(0.5, dtype)
    else:
        rb = rqb.astype(dtype)
    if grad_mode == "sum":
        return ul, ib, rb, mask, mask
    # weights: min(mult, t)/mult, computed EXACTLY as the flat builder
    # (q = 1/m first, then min(1/q, t) * q * mask) for bitwise parity
    t = jnp.asarray(1.0 if grad_mode == "mean" else cap, dtype)
    one = jnp.asarray(1, dtype)

    def w(menc):
        q = one / (menc.astype(dtype) + one)
        return jnp.minimum(one / q, t) * q * mask

    return ul, ib, rb, w(mub), w(mib)


_COMPACT_NAMES = ("ul", "ilo", "ihi_pos", "ihi_val", "rq", "mu", "mi",
                  "u_lo")


def _compact_epoch_scan(Ue, Ve, mu, xs, lam_, lr, tile: int, n_items: int,
                        cap: int, grad_mode: str, rating_kind: str):
    one_col = _bias_col(Ue)

    def body(carry, xs_b):
        (ulb, ilob, hp, hv, rqb, mub, mib, lo) = xs_b
        dec = _decode_compact_batch(ulb, ilob, hp, hv, rqb, mub, mib,
                                    n_items, cap, grad_mode, rating_kind,
                                    Ue.dtype)
        return _batch_update(*carry, mu, one_col, lam_, lr, tile,
                             n_items, *dec, lo), None

    (Ue, Ve), _ = lax.scan(body, (Ue, Ve), xs)
    return Ue, Ve


@partial(jax.jit, static_argnames=("lam", "tile", "n_items", "cap",
                                   "grad_mode", "rating_kind"),
         donate_argnums=(0,))
def _compact_epoch_jit(state: MFState, arrs, order, lam: float, lr,
                       tile: int, n_items: int, cap: int, grad_mode: str,
                       rating_kind: str) -> MFState:
    lr = jnp.asarray(lr, state.U.dtype)
    lam_ = jnp.asarray(lam, state.U.dtype)
    Ue = jnp.concatenate([state.U, state.bu[:, None]], axis=1)
    Ve = jnp.concatenate([state.V, state.bi[:, None]], axis=1)
    one_col = _bias_col(Ue)
    mu = state.mu

    # scan over the batch ORDER and dynamic-slice each batch out of the
    # pinned arrays — a whole-wire permuted gather (xs = a[order]) would
    # hold a second copy of the wire for the epoch, doubling peak HBM and
    # OOMing runs the sgd_wire_budget pin check admitted at ~1x
    def body(carry, idx):
        (ulb, ilob, hp, hv, rqb, mub, mib, lo) = tuple(
            lax.dynamic_index_in_dim(a, idx, 0, keepdims=False)
            for a in arrs)
        dec = _decode_compact_batch(ulb, ilob, hp, hv, rqb, mub, mib,
                                    n_items, cap, grad_mode, rating_kind,
                                    Ue.dtype)
        return _batch_update(*carry, mu, one_col, lam_, lr, tile,
                             n_items, *dec, lo), None

    (Ue, Ve), _ = lax.scan(body, (Ue, Ve), order)
    k = state.U.shape[1]
    return state._replace(U=Ue[:, :k], V=Ve[:, :k],
                          bu=Ue[:, k], bi=Ve[:, k])


def sgd_stream_epoch_pinned(state: MFState, comp, order, lam: float,
                            lr) -> MFState:
    """One epoch over a compact wire PINNED in HBM (put_compact) —
    near-resident speed at 0.25-0.45x the flat stream's memory."""
    arrs = tuple(getattr(comp, n) for n in _COMPACT_NAMES)
    return _compact_epoch_jit(state, arrs, order, lam, lr, comp.tile,
                              state.n_items, comp.cap, comp.grad_mode,
                              comp.rating_kind)


@partial(jax.jit, static_argnames=("lam", "tile", "n_items", "cap",
                                   "grad_mode", "rating_kind"),
         donate_argnums=(0, 1))
def _compact_chunk_step(Ue, Ve, mu, arrs, lam: float, lr, tile: int,
                        n_items: int, cap: int, grad_mode: str,
                        rating_kind: str):
    lam_ = jnp.asarray(lam, Ue.dtype)
    return _compact_epoch_scan(Ue, Ve, mu, arrs, lam_,
                               lr.astype(Ue.dtype), tile, n_items, cap,
                               grad_mode, rating_kind)


def _compact_pad_rows(comp, pad: int):
    """``pad`` wire batches that decode to pure no-ops: every row's item
    id decodes to n_items (the trash row), so mask -> weights -> 0."""
    NB, B = comp.ul.shape
    H = comp.ihi_pos.shape[1]
    ilo = np.zeros((pad, B), np.uint16)
    ilo[:, 0] = comp.n_items & 0xFFFF
    hv = np.zeros((pad, H), np.int32)
    hv[:, 0] = comp.n_items >> 16  # a REAL (pos 0, hi) entry, not padding
    return dict(
        ul=np.zeros((pad, B), np.uint16), ilo=ilo,
        ihi_pos=np.zeros((pad, H), np.int32), ihi_val=hv,
        rq=np.zeros((pad, B), comp.rq.dtype),
        mu=np.zeros((pad,) + np.asarray(comp.mu).shape[1:], np.uint16),
        mi=np.zeros((pad,) + np.asarray(comp.mi).shape[1:], np.uint16),
        u_lo=np.zeros(pad, np.int32))


def _compact_epoch_ooc(state: MFState, comp, order, lam: float, lr,
                       chunk_batches: int | None = None,
                       prefetch: int = 2) -> MFState:
    """Compact wire resident on HOST: permuted chunks stream ahead of the
    scan, exactly like the flat OOC epoch but at 2.2-4x fewer wire bytes."""
    NB, B = comp.ul.shape
    if chunk_batches is None:
        per_batch = 4 + sum(
            int(np.prod(np.asarray(getattr(comp, n)).shape[1:]))
            * np.asarray(getattr(comp, n)).dtype.itemsize
            for n in _COMPACT_NAMES[:-1])
        chunk_batches = max(1, min(NB, _SGD_CHUNK_TARGET_BYTES
                                   // per_batch))
    order = np.asarray(order, np.int64)
    k = state.U.shape[1]
    Ue = jnp.concatenate([state.U, state.bu[:, None]], axis=1)
    Ve = jnp.concatenate([state.V, state.bi[:, None]], axis=1)
    lr_ = jnp.asarray(lr, Ue.dtype)
    mu = jnp.asarray(state.mu, Ue.dtype)

    def step(Ue, Ve, ch):
        return _compact_chunk_step(Ue, Ve, mu, ch, lam, lr_, comp.tile,
                                   state.n_items, comp.cap,
                                   comp.grad_mode, comp.rating_kind)

    q = []
    for c0 in range(0, NB, chunk_batches):
        sel = order[c0:c0 + chunk_batches]
        pad = chunk_batches - len(sel)
        pads = _compact_pad_rows(comp, pad) if pad else None
        ch = []
        for n in _COMPACT_NAMES:
            a = np.asarray(getattr(comp, n))[sel]
            if pad:
                a = np.concatenate([a, pads[n]])
            ch.append(jax.device_put(a))
        q.append(tuple(ch))
        if len(q) > prefetch:
            Ue, Ve = step(Ue, Ve, q.pop(0))
    for ch in q:
        Ue, Ve = step(Ue, Ve, ch)
    return state._replace(U=Ue[:, :k], V=Ve[:, :k],
                          bu=Ue[:, k], bi=Ve[:, k])


class StreamSGD:
    """Engine-facing stream-SGD trainer (drop-in for models/sgd.BiasedSGD
    where the dataset was prepared with prepare_stream_sgd)."""

    def __init__(self, lam: float = 0.02, lr: float = 0.01,
                 lr_decay: float = 0.95, seed: int = 0,
                 grad_mode: str = "capped"):
        self.lam = float(lam)
        self.lr0 = float(lr)
        self.lr_decay = float(lr_decay)
        self.seed = seed
        self.grad_mode = grad_mode

    def lr_at(self, epoch: int) -> float:
        return self.lr0 * self.lr_decay**epoch

    def epoch(self, state: MFState, data, epoch_idx: int) -> MFState:
        """``data`` is a StreamSGDData (flat) or ops/sgd_wire's
        CompactStreamSGD (the pin/stream wire tier), each either device-
        resident or host-resident — four paths, one trajectory (same
        batch order => float64-bitwise factors, tests/test_sgd_wire.py)."""
        if data.grad_mode != self.grad_mode:
            raise ValueError(
                f"data was prepared for grad_mode={data.grad_mode!r}; "
                f"trainer wants {self.grad_mode!r} — re-run "
                f"prepare_stream_sgd with matching grad_mode")
        nb = data.ul.shape[0]
        key = jax.random.key(self.seed + 7919 * epoch_idx)
        order = jax.random.permutation(key, nb)
        lr = self.lr_at(epoch_idx)
        if not isinstance(data, StreamSGDData):  # compact wire
            if isinstance(data.ul, np.ndarray):  # host -> streamed chunks
                return _compact_epoch_ooc(state, data, np.asarray(order),
                                          self.lam, lr)
            return sgd_stream_epoch_pinned(state, data, order, self.lam,
                                           lr)
        if isinstance(data.ul, np.ndarray):  # host stream -> OOC epoch
            return sgd_stream_epoch_ooc(state, data, np.asarray(order),
                                        self.lam, lr)
        return sgd_stream_epoch(state, data.ul, data.ib, data.rb, data.wu,
                                data.wi, data.u_lo, order, self.lam,
                                lr, data.tile)
