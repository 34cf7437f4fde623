"""Top-N recommendation serving (SURVEY.md C13, call stack 3.5).

scores = U[u] . V^T with already-rated items masked to -inf, then top-k —
exactly the reference's serving path, run fully on device and batched:

* ``recommend_all``: scans the user-major blocked layout, so the rated-item
  masks come straight from the training layout (no per-user host work). This
  is the throughput path behind the "top-10 recs/sec" metric (BASELINE.json:2).
* ``recommend_users``: ad-hoc user list; the rated lists are sliced on host
  (the reference reads them from Postgres) and padded to one rectangle.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ycnr_tpu.models.base import MFState
from ycnr_tpu.ops.gram import BlockData
from ycnr_tpu.ops.layout import BlockedCSR

NEG_INF = -3.0e38  # large-negative fill (safe in fp32, avoids inf-inf NaNs)


def overfetch_n(n: int, n_extra: int) -> int:
    """Next power of two >= n + n_extra — the exclusion over-fetch width
    (bounds the set of compiled scorer shapes; the single definition the
    serving engine and the CLI bulk path share)."""
    return 1 << max(int(n) + int(n_extra) - 1, 0).bit_length()


def top_popular(item_idx, n_items: int, n: int) -> np.ndarray:
    """Top-n item ids by rating count — the zero-history fallback shared by
    ``serve.engine.Recommender.popular`` and ``recommend --popular`` (one
    implementation so tie order / zero-count filtering cannot drift).
    Host-side: a bincount over nnz beats shipping it to the device.
    Never-rated items are excluded, so fewer than n ids may return."""
    counts = np.bincount(np.asarray(item_idx), minlength=int(n_items))
    n_eff = min(int(n), len(counts))
    if n_eff <= 0:
        return np.empty(0, np.int64)
    top = np.argpartition(-counts, n_eff - 1)[:n_eff]
    top = top[np.argsort(-counts[top], kind="stable")].astype(np.int64)
    return top[counts[top] > 0]


def build_rated_bits(layout: BlockedCSR, n_items: int) -> np.ndarray:
    """Precompute the rated-items mask as a packed bitfield, host-side.

    A per-call scatter of -inf into the [U_B, n_items] score matrix is an
    element-op-bound pass over the whole score tensor. This one-time pack
    turns the mask into [..., U_B, W] uint32 words (W = ceil((n_items+1)/32))
    that the scorer unpacks with two fused elementwise ops per call.

    Accepts single ([NB, C_B, L]) or sharded ([D, NB, C_B, L]) layouts; bit
    for the trash column ``n_items`` is always set. Runs vectorized off the
    layout's sort order (entities ascending, items ascending per entity), so
    the group-reduce is a single ``bitwise_or.reduceat``.
    """
    oi = np.asarray(layout.other_idx)
    seg = np.asarray(layout.chunk_seg)
    U_B = layout.entity_ids.shape[-1]
    lead = oi.shape[:-2]
    C_B, L = oi.shape[-2:]
    # W aligned to 4 words = 128 bits, matching _segment_topn's segment
    # length, so W*32 == the padded score width exactly
    W = 4 * (-(-(n_items + 1) // 128))
    oi2 = oi.reshape(-1, C_B, L)
    seg2 = seg.reshape(-1, C_B)
    P_ = oi2.shape[0]
    pref = np.arange(P_, dtype=np.int64)[:, None]
    slot = np.minimum(seg2, U_B - 1).astype(np.int64)  # [P, C_B]
    key = ((pref * U_B + slot)[:, :, None] * W
           + (oi2 >> 5).astype(np.int64))  # [P, C_B, L]
    val = (np.uint32(1) << (oi2 & 31).astype(np.uint32))
    real = (seg2 < U_B)[:, :, None] & np.ones((1, 1, L), bool)
    key = key[real]  # sorted: blocks asc, slots asc, items asc per entity
    val = val[real]
    out = np.zeros(P_ * U_B * W, np.uint32)
    if key.size:
        starts = np.flatnonzero(np.r_[True, np.diff(key) != 0])
        out[key[starts]] = np.bitwise_or.reduceat(val, starts)
    out = out.reshape(*lead, U_B, W)
    # mask the trash column and every pad column up to the word boundary, so
    # the scorer can run on a V padded to a multiple of the segment length
    # (pad rows of V are zero -> scores mu + b_u there would otherwise rank)
    out[..., :, n_items >> 5] |= ~np.uint32(
        (np.uint32(1) << np.uint32(n_items & 31)) - 1)
    out[..., :, (n_items >> 5) + 1 :] = np.uint32(0xFFFFFFFF)
    return out


def _pad_items(V, bi, W):
    """Pad the item factor/bias to the bitmask's W*32 columns (zero rows;
    the bits builder masks every column >= n_items)."""
    M = W * 32
    add = M - V.shape[0]
    if add <= 0:
        return V, bi
    Vp = jnp.concatenate([V, jnp.zeros((add, V.shape[1]), V.dtype)])
    bip = jnp.concatenate([bi, jnp.zeros((add,), bi.dtype)])
    return Vp, bip


def _mask_scores_bits(scores, bits):
    """scores [U_B, M] with bit-marked positions set to NEG_INF (fused).

    Unpacks byte-wise (bitcast to uint8, 8 shift lanes), which XLA fuses
    into the masking pass.
    """
    U_B, M = scores.shape
    b8 = jax.lax.bitcast_convert_type(bits, jnp.uint8)  # [U_B, W, 4] LE
    shifts = jnp.arange(8, dtype=jnp.uint8)
    m = (b8[..., None] >> shifts) & jnp.uint8(1)  # [U_B, W, 4, 8]
    m = m.reshape(U_B, -1)[:, :M]
    return jnp.where(m != 0, NEG_INF, scores)


def _segment_topn(scores, n: int, seg_len: int = 128):
    """Exact top-n without a full-width sort: lax.top_k sorts the whole row,
    but every global top-n element lives
    in a segment whose max is among the n largest segment maxes. So: segment
    max (one bandwidth-bound pass), top-n segments (tiny sort), gather those
    n*seg_len candidates, top-n of the candidates. Ties at the n-th value may
    resolve to a different equal-scored item than a full sort would.
    """
    U_B, M = scores.shape
    S = -(-M // seg_len)
    if S <= n:  # tiny item spaces: plain sort is cheap and exact
        v, i = lax.top_k(scores, n)
        return i.astype(jnp.int32), v
    if S * seg_len != M:  # callers pad V up front to skip this full copy
        scores = jnp.pad(scores, ((0, 0), (0, S * seg_len - M)),
                         constant_values=NEG_INF)
    s3 = scores.reshape(U_B, S, seg_len)
    _, top_seg = lax.top_k(s3.max(axis=2), n)  # [U_B, n]
    # extract the n winning segments with a one-hot matmul, which streams
    # s3 at full bandwidth where a row gather would not. HIGHEST keeps
    # values exact (0/1 weights; a reduced-precision pass, TF32 on the
    # GPU, would perturb the scores).
    oh = jax.nn.one_hot(top_seg, S, dtype=s3.dtype)  # [U_B, n, S]
    cand = jnp.einsum("uns,usl->unl", oh, s3,
                      precision=jax.lax.Precision.HIGHEST)
    v, loc = lax.top_k(cand.reshape(U_B, n * seg_len), n)
    segsel, off = loc // seg_len, loc % seg_len
    items = jnp.take_along_axis(top_seg, segsel, axis=1) * seg_len + off
    return items.astype(jnp.int32), v


def topn_block(U, V, bu, bi, mu, blk: BlockData, n: int, rated_bits=None):
    """Masked top-n for one layout block: scores U[slots] . V^T with this
    block's rated pairs set to -inf. Shared by the single-chip and sharded
    serving paths (U/bu may be a local shard; blk.entity_ids index into U).

    rated_bits [U_B, W]: packed rated mask from build_rated_bits — the fast
    path (fused unpack + exact segment top-k). None falls back to the
    scatter + full top_k reference path (kept for parity tests).
    """
    n_items = V.shape[0] - 1
    rows = U[blk.entity_ids]  # [U_B, k]
    scores = (mu + bu[blk.entity_ids][:, None] + bi[None, :]
              + jnp.matmul(rows, V.T, precision=lax.Precision.HIGHEST))
    if rated_bits is not None:
        return _segment_topn(_mask_scores_bits(scores, rated_bits), n)
    U_B = blk.entity_ids.shape[0]
    slot = jnp.minimum(blk.chunk_seg, U_B - 1)  # padding chunks -> safe row
    flat_rows = jnp.repeat(slot, blk.other_idx.shape[1])
    flat_cols = blk.other_idx.reshape(-1)  # padding -> col n_items
    scores = scores.at[flat_rows, flat_cols].set(NEG_INF)
    scores = scores.at[:, n_items].set(NEG_INF)  # trash column off
    top_s, top_i = lax.top_k(scores, n)
    return top_i.astype(jnp.int32), top_s


@partial(jax.jit, static_argnames=("n",))
def _topn_blocks(state: MFState, layout: BlockedCSR, n: int,
                 rated_bits=None):
    """[NB, U_B, n] top items + scores per entity slot, rated items masked.

    rated_bits [NB, U_B, W] (see build_rated_bits) selects the fast path.
    """
    if rated_bits is None:
        def body(_, blk_arrays):
            blk = BlockData(*blk_arrays)
            return None, topn_block(state.U, state.V, state.bu, state.bi,
                                    state.mu, blk, n)

        _, (ids, sc) = lax.scan(body, None, tuple(layout))
        return ids, sc

    # pad V/bi to a whole number of segments ONCE, so the per-block matmul
    # emits already-aligned scores (a post-hoc pad copies the whole score
    # tensor); the bits builder masks every pad column
    Vp, bip = _pad_items(state.V, state.bi, rated_bits.shape[-1])

    def body_bits(_, xs):
        blk = BlockData(*xs[:-1])
        return None, topn_block(state.U, Vp, state.bu, bip,
                                state.mu, blk, n, rated_bits=xs[-1])

    _, (ids, sc) = lax.scan(body_bits, None, tuple(layout) + (rated_bits,))
    return ids, sc


def recommend_all(state: MFState, user_layout: BlockedCSR, n: int = 10,
                  rated_bits=None):
    """Top-N for every user with >=1 training rating.

    Returns (user_ids [m], item_ids [m, n], scores [m, n]) as numpy.
    rated_bits: packed mask from ``build_rated_bits(user_layout, n_items)``;
    built automatically when the layout is host-resident (numpy). Pass it
    explicitly for repeated serving so the pack happens once.

    Scores are float32 end to end: the U.V^T product runs at HIGHEST
    precision, so a GPU does not round it through TF32.
    """
    n = min(int(n), state.n_items)  # top_k crashes past the catalog size
    if rated_bits is None and isinstance(user_layout.other_idx, np.ndarray):
        rated_bits = build_rated_bits(user_layout, state.n_items)
    ids, sc = _topn_blocks(state, user_layout, n, rated_bits)
    eids = np.asarray(user_layout.entity_ids).reshape(-1)
    ids = np.asarray(ids).reshape(-1, n)
    sc = np.asarray(sc).reshape(-1, n)
    real = eids < state.n_users
    return eids[real], ids[real], sc[real]


@partial(jax.jit, static_argnames=("n",))
def _topn_users(state: MFState, user_ids: jnp.ndarray,
                rated_padded: jnp.ndarray, n: int):
    n_items = state.V.shape[0] - 1
    rows = state.U[user_ids]
    scores = (state.mu + state.bu[user_ids][:, None] + state.bi[None, :]
              + jnp.matmul(rows, state.V.T,
                           precision=lax.Precision.HIGHEST))
    b = jax.lax.broadcasted_iota(jnp.int32, rated_padded.shape, 0)
    scores = scores.at[b.reshape(-1), rated_padded.reshape(-1)].set(NEG_INF)
    scores = scores.at[:, n_items].set(NEG_INF)
    return lax.top_k(scores, n)


def sort_ratings_by_user(train_u, train_i):
    """One-time host index for serving: (sorted_u, sorted_i). Build once and
    pass to recommend_users to avoid re-sorting the COO per request."""
    train_u = np.asarray(train_u)
    train_i = np.asarray(train_i)
    order = np.argsort(train_u, kind="stable")
    return train_u[order], train_i[order]


def recommend_users(state: MFState, train_u, train_i, user_ids, n: int = 10,
                    sorted_index=None, rated_lists=None, min_width=None):
    """Top-N for an explicit user list (the reference's recommend(userId, N)
    entry). Rated lists are gathered host-side and padded with n_items.

    sorted_index: optional (sorted_u, sorted_i) from sort_ratings_by_user —
    pass it for repeated serving so the O(nnz log nnz) sort happens once.
    rated_lists: optional explicit per-user rated-item arrays (one per
    user_id), overriding the train_u/train_i lookup entirely — the serving
    engine passes these when it holds pending (not yet compacted) online
    updates. The mask width is padded to a power of two so the jitted
    scorer compiles once per width bucket rather than once per distinct
    rated-count; long-running servers pass min_width = the catalog's max
    rated count so EVERY request hits one width bucket (each new bucket
    is a fresh XLA compile).
    """
    n = min(int(n), state.n_items)  # top_k crashes past the catalog size
    user_ids = np.asarray(user_ids, np.int32)
    if rated_lists is not None:
        lists = list(rated_lists)
    else:
        su, si = sorted_index if sorted_index is not None else (
            sort_ratings_by_user(train_u, train_i))
        lists = []
        for u in user_ids:
            s, t = np.searchsorted(su, u), np.searchsorted(su, u, "right")
            lists.append(si[s:t])
    width = max(8, max((len(x) for x in lists), default=1), min_width or 0)
    width = 1 << int(np.ceil(np.log2(width)))  # bound recompilations
    rated = np.full((len(user_ids), width), state.n_items, np.int32)
    for j, x in enumerate(lists):
        rated[j, : len(x)] = x
    top_s, top_i = _topn_users(state, jnp.asarray(user_ids),
                               jnp.asarray(rated), n)
    return np.asarray(top_i), np.asarray(top_s)
