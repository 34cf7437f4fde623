"""Sharded training: the reference's worker parallelism as SPMD programs.

Mapping (SURVEY.md §2 parallelism inventory):

* P1 (row-sharded U-step): users are partitioned across the mesh (balanced by
  rating count, LPT); each device solves only its users' normal equations
  against a replicated V — exactly the reference's "worker solves users
  [a, b) reading shared V", minus the shared memory.
* P2 (V-step): ratings stay sharded by *user*; each device accumulates
  partial per-item Gram matrices + RHS from its rating shard and the mesh
  `psum`s them over NVLink before one replicated batched solve. This is the
  BASELINE.json:5-prescribed collective ("allreduces item Gram matrices") and avoids re-bucketing ratings by item across the mesh (SURVEY.md M6).
* P3 (SGD data parallelism): each device runs the rating stream of its user
  shard; U/b_u updates are purely local, V/b_i deltas are `psum`'d per batch
  — the deterministic analog of the reference's hogwild shm races.
* P4 (epoch barrier): implicit in SPMD program order; the collectives are
  the barrier.

State layout: U/b_u are sharded on a leading device axis with *local* user
indexing ([D, upd+1, k]; row `upd` is each shard's trash row); V/b_i/mu are
replicated. `gather_state`/`scatter_state` convert to/from the single-chip
MFState.
"""

from __future__ import annotations

import os

from dataclasses import dataclass
from functools import lru_cache, partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ycnr_tpu.models.base import MFState
from ycnr_tpu.ops.gram import (
    BlockData,
    chunk_gram_rhs,
    guarded_batched_solve,
    segment_reduce_block,
    solve_block,
)
from ycnr_tpu.ops.layout import BlockedCSR, build_blocked_csr
from ycnr_tpu.parallel.mesh import AXIS


class ShardedState(NamedTuple):
    U: jnp.ndarray  # [D, upd+1, k] sharded on axis 0, local user rows
    V: jnp.ndarray  # [n_items+1, k] replicated
    bu: jnp.ndarray  # [D, upd+1] sharded
    bi: jnp.ndarray  # [n_items+1] replicated
    mu: jnp.ndarray  # scalar replicated


class ShardedData(NamedTuple):
    """Device arrays only (a pytree). Leading axis D is the mesh axis."""

    user_layout: BlockedCSR  # leaves [D, NB_u, ...]; entity=LOCAL user
    item_layout: BlockedCSR  # leaves [D, NB_i, ...]; entity=GLOBAL item,
    #                           other=LOCAL user
    item_deg: jnp.ndarray  # [n_items+1] global item degree (float)
    sgd_u: jnp.ndarray  # [D, n_sgd] LOCAL user idx (pad -> upd)
    sgd_i: jnp.ndarray  # [D, n_sgd] GLOBAL item idx (pad -> n_items)
    sgd_r: jnp.ndarray  # [D, n_sgd]
    test_u: jnp.ndarray  # [D, n_test] LOCAL user idx (pad -> upd)
    test_i: jnp.ndarray  # [D, n_test] GLOBAL item idx
    test_r: jnp.ndarray  # [D, n_test]


@dataclass
class ShardedMeta:
    """Host-side bookkeeping that must not be traced."""

    n_users: int
    n_items: int
    n_shards: int
    upd: int  # users per device (padded)
    user_map: np.ndarray  # [D, upd] global user id per local row (pad n_users)
    user_local: np.ndarray  # [n_users] (shard, local) packed: shard*upd+local
    test_n: int  # real held-out count
    sgd_n: int  # real train count in the sgd stream
    user_layout_host: "BlockedCSR | None" = None  # numpy [D, NB, ...] copy of
    #   the per-shard user layout (pre-device_put), for host-side builders
    #   like eval.recommend.build_rated_bits (sharded serving fast path)


def _lpt_partition(degrees: np.ndarray, D: int):
    """Longest-processing-time entity partition balanced by rating count.

    Zero-degree entities carry no load, so plain LPT would pile them all on
    one argmin shard — inflating the padded per-shard entity count (upd) and
    every [D, upd+1, k] buffer by up to the inactive-entity count; they are
    dealt to the smallest member lists instead, balancing counts. Heap-based
    (O(n log D)); the argmin-scan original was O(n*D) host work per build.
    """
    import heapq

    order = np.argsort(-degrees, kind="stable")
    n_active = int((degrees > 0).sum())
    shard_of = np.zeros(len(degrees), np.int32)
    members: list[list[int]] = [[] for _ in range(D)]
    heap = [(0, d) for d in range(D)]  # (load, shard); ties -> lowest shard
    for u in order[:n_active]:
        load, d = heapq.heappop(heap)
        shard_of[u] = d
        members[d].append(int(u))
        heapq.heappush(heap, (load + int(degrees[u]), d))
    if n_active < len(order):
        by_count = sorted(range(D), key=lambda d: len(members[d]))
        for j, u in enumerate(order[n_active:]):
            d = by_count[j % D]
            shard_of[u] = d
            members[d].append(int(u))
    return members, shard_of


def _pad_blocks(layout: BlockedCSR, nb: int, n_entities: int,
                n_other: int) -> BlockedCSR:
    """Pad a layout to nb blocks with fully-empty blocks."""
    add = nb - layout.n_blocks
    if add == 0:
        return layout
    C_B, L, U_B = layout.block_chunks, layout.chunk_len, layout.block_entities
    return BlockedCSR(
        np.concatenate([layout.other_idx,
                        np.full((add, C_B, L), n_other, np.int32)]),
        np.concatenate([layout.rating, np.zeros((add, C_B, L), np.float32)]),
        np.concatenate([layout.chunk_seg, np.full((add, C_B), U_B, np.int32)]),
        np.concatenate([layout.entity_ids,
                        np.full((add, U_B), n_entities, np.int32)]),
        np.concatenate([layout.entity_cnt, np.zeros((add, U_B), np.float32)]),
    )


def _stack_layouts(lays: list) -> BlockedCSR:
    """Stack per-shard layouts into one [D, ...]-leading BlockedCSR."""
    return BlockedCSR(*(np.stack([getattr(l, f) for l in lays])
                        for f in BlockedCSR._fields))


def _device_stacked(lay: BlockedCSR, dtype) -> BlockedCSR:
    """Host stacked layout -> device arrays (ratings/counts in dtype)."""
    return BlockedCSR(jnp.asarray(lay.other_idx),
                      jnp.asarray(lay.rating, dtype),
                      jnp.asarray(lay.chunk_seg),
                      jnp.asarray(lay.entity_ids),
                      jnp.asarray(lay.entity_cnt, dtype))


def _stack_ragged(per_shard: list, pads: tuple, round_to: int = 8):
    """Pad a per-shard tuple of equal-length 1-D arrays into [D, n] blocks
    (n = max shard length rounded up to `round_to`; float pads -> float32
    output, int pads -> int32). Shared by the test-COO and SGD-stream
    builders of both sharded modes."""
    D = len(per_shard)
    n = max(1, max(len(t[0]) for t in per_shard))
    n = int(-(-n // round_to) * round_to)
    outs = []
    for c, pad in enumerate(pads):
        dt = np.float32 if isinstance(pad, float) else np.int32
        a = np.full((D, n), pad, dt)
        for d, t in enumerate(per_shard):
            a[d, : len(t[c])] = t[c]
        outs.append(a)
    return outs


def build_sharded_data(
    train_u, train_i, train_r, n_users: int, n_items: int, n_shards: int,
    chunk_len: int = 32, block_chunks=None, rank_hint: int = 64,
    test_u=None, test_i=None, test_r=None, sgd_batch: int = 4096,
    dtype=jnp.float32, mesh: Mesh | None = None,
    host_user_layout: bool = False, algo: str = "all",
):
    """Partition ratings by user across shards and build all device inputs.

    Returns (ShardedData, ShardedMeta). If ``mesh`` is given, arrays are
    device_put with their final shardings (leading axis over the mesh).
    host_user_layout=True keeps the numpy per-shard user layout on
    ``meta.user_layout_host`` for host-side builders (serving bits); it pins
    nnz-proportional host RAM, so it is opt-in.

    ``algo`` ("als"/"ials"/"sgd"/"bpr"/"all") gates the expensive inputs:
    the alternating solvers never read the SGD/BPR stream and SGD/BPR never
    read the blocked layouts — building both costs O(nnz) host work and GB-scale
    HBM for nothing. Unused fields become empty placeholders (same pytree
    structure).
    """
    # serving (host_user_layout) reads the USER layout regardless of algo;
    # the item layout is only ever read by the alternating solvers
    need_user_layout = algo in ("all", "als", "ials") or host_user_layout
    need_item_layout = algo in ("all", "als", "ials")
    need_sgd = algo in ("all", "sgd", "bpr")
    D = n_shards
    train_u = np.asarray(train_u)
    train_i = np.asarray(train_i)
    train_r = np.asarray(train_r, np.float32)
    deg_u = np.bincount(train_u, minlength=n_users)
    members, shard_of = _lpt_partition(deg_u, D)
    upd = max(len(m) for m in members)

    user_map = np.full((D, upd), n_users, np.int32)
    user_local = np.zeros(n_users, np.int64)
    for d, m in enumerate(members):
        user_map[d, : len(m)] = m
        for j, u in enumerate(m):
            user_local[u] = d * upd + j
    local_of = user_local % upd  # [n_users] local row

    # --- per-shard COO ---
    shard_idx = shard_of[train_u]
    per = [np.nonzero(shard_idx == d)[0] for d in range(D)]

    # choose one C_B valid for every shard's user- and item-major layouts
    max_user_chunks = int(np.max(-(-deg_u // chunk_len), initial=1))
    deg_i_per = [np.bincount(train_i[p], minlength=n_items) for p in per]
    max_item_chunks = max(int(np.max(-(-di // chunk_len), initial=1))
                          for di in deg_i_per)
    if block_chunks is None:
        from ycnr_tpu.ops.layout import _auto_block_chunks
        total = int(-(-len(train_r) // (chunk_len * max(D, 1))))
        block_chunks = _auto_block_chunks(max(total, 1), chunk_len, rank_hint)
    C_B = max(block_chunks, max_user_chunks, max_item_chunks)

    # uniform entity budgets across shards (stacked arrays must agree)
    from ycnr_tpu.ops.layout import _auto_block_entities
    ub_user, ub_item = 8, 8
    for d, p in enumerate(per):
        du = np.bincount(train_u[p], minlength=1)
        du = du[du > 0]
        chunks_u = int(np.sum(-(-du // chunk_len))) or 1
        ub_user = max(ub_user, _auto_block_entities(C_B, len(du), chunks_u))
        di = deg_i_per[d][deg_i_per[d] > 0]
        chunks_i = int(np.sum(-(-di // chunk_len))) or 1
        ub_item = max(ub_item, _auto_block_entities(C_B, len(di), chunks_i))

    def user_view(pfull):
        pu = pfull if need_user_layout else pfull[:0]
        return build_blocked_csr(
            local_of[train_u[pu]].astype(np.int64), train_i[pu], train_r[pu],
            upd, n_items, chunk_len, C_B, block_entities=ub_user)

    def item_view(pfull):
        pi = pfull if need_item_layout else pfull[:0]
        return build_blocked_csr(
            train_i[pi], local_of[train_u[pi]].astype(np.int64), train_r[pi],
            n_items, upd, chunk_len, C_B, block_entities=ub_item)

    # the 2D per-shard builds are independent and spend their time in
    # NumPy sorts/gathers and the native packer, which release the GIL
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=min(2 * D, os.cpu_count() or 1)) \
            as pool:
        u_futs = [pool.submit(user_view, p) for p in per]
        i_futs = [pool.submit(item_view, p) for p in per]
        u_lays = [f.result() for f in u_futs]
        i_lays = [f.result() for f in i_futs]
    nb_u = max(l.n_blocks for l in u_lays)
    nb_i = max(l.n_blocks for l in i_lays)
    u_lays = [_pad_blocks(l, nb_u, upd, n_items) for l in u_lays]
    i_lays = [_pad_blocks(l, nb_i, n_items, upd) for l in i_lays]
    user_layout = _stack_layouts(u_lays)
    item_layout = _stack_layouts(i_lays)

    item_deg = np.zeros(n_items + 1, np.float32)
    item_deg[:n_items] = np.bincount(train_i, minlength=n_items)

    # --- SGD stream: each shard's ratings, padded to a common length that is
    # a whole number of local batches ---
    b_local = max(1, sgd_batch // D)
    sgd_per = per if need_sgd else [p[:0] for p in per]
    if algo == "bpr":
        # one fixed per-shard row shuffle so the "batches" shuffle mode's
        # FIXED batch composition is a random partition of each shard's
        # stream, not the file order (MovieLens exports are user-sorted);
        # the "rows" mode re-permutes per epoch anyway, so this is inert
        # there
        rng = np.random.default_rng(0)
        sgd_per = [rng.permutation(p) for p in sgd_per]
    sgd_u, sgd_i, sgd_r = _stack_ragged(
        [(local_of[train_u[p]], train_i[p], train_r[p]) for p in sgd_per],
        pads=(upd, n_items, 0.0), round_to=b_local)

    # --- held-out COO sharded by the same user partition ---
    if test_u is None:
        test_u = np.zeros(0, np.int32)
        test_i = np.zeros(0, np.int32)
        test_r = np.zeros(0, np.float32)
    test_u = np.asarray(test_u)
    test_i = np.asarray(test_i)
    test_r = np.asarray(test_r, np.float32)
    tper = [np.nonzero(shard_of[test_u] == d)[0] for d in range(D)]
    tu, ti, tr = _stack_ragged(
        [(local_of[test_u[p]], test_i[p], test_r[p]) for p in tper],
        pads=(upd, n_items, 0.0))

    data = ShardedData(
        user_layout=_device_stacked(user_layout, dtype),
        item_layout=_device_stacked(item_layout, dtype),
        item_deg=jnp.asarray(item_deg, dtype),
        sgd_u=jnp.asarray(sgd_u), sgd_i=jnp.asarray(sgd_i),
        sgd_r=jnp.asarray(sgd_r, dtype),
        test_u=jnp.asarray(tu), test_i=jnp.asarray(ti),
        test_r=jnp.asarray(tr, dtype),
    )
    meta = ShardedMeta(n_users=n_users, n_items=n_items, n_shards=D, upd=upd,
                       user_map=user_map, user_local=user_local,
                       test_n=len(test_r), sgd_n=len(train_r),
                       user_layout_host=(user_layout if host_user_layout
                                         else None))
    if mesh is not None:
        data = put_sharded(data, mesh)
    return data, meta


def _data_specs() -> ShardedData:
    lay = BlockedCSR(*(P(AXIS) for _ in BlockedCSR._fields))
    return ShardedData(user_layout=lay, item_layout=lay, item_deg=P(),
                       sgd_u=P(AXIS), sgd_i=P(AXIS), sgd_r=P(AXIS),
                       test_u=P(AXIS), test_i=P(AXIS), test_r=P(AXIS))


def _state_specs() -> ShardedState:
    return ShardedState(U=P(AXIS), V=P(), bu=P(AXIS), bi=P(), mu=P())


def put_sharded(data: ShardedData, mesh: Mesh) -> ShardedData:
    specs = _data_specs()
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), data, specs)


def scatter_state(state: MFState, meta: ShardedMeta,
                  mesh: Mesh | None = None) -> ShardedState:
    """Global MFState -> sharded layout (host-side reshuffle)."""
    D, upd = meta.n_shards, meta.upd
    k = state.U.shape[1]
    U = np.asarray(state.U)
    bu = np.asarray(state.bu)
    Ush = np.zeros((D, upd + 1, k), U.dtype)
    bush = np.zeros((D, upd + 1), bu.dtype)
    # user_map pad entries point at n_users == the global trash row (zeros)
    Ush[:, :upd] = U[meta.user_map]
    bush[:, :upd] = bu[meta.user_map]
    st = ShardedState(jnp.asarray(Ush), state.V, jnp.asarray(bush), state.bi,
                      state.mu)
    if mesh is not None:
        st = jax.tree.map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), st,
            _state_specs())
    return st


@lru_cache(maxsize=16)
def _replicator(mesh: Mesh):
    # one compiled identity-with-all-gather per mesh; a fresh lambda per
    # call would re-trace and re-compile on every epoch's gather
    return jax.jit(lambda a: a, out_shardings=NamedSharding(mesh, P()))


def host_fetch(x) -> np.ndarray:
    """np.asarray that also works on multi-host (DCN) global arrays.

    In a multi-process job a P(AXIS)-sharded array is not fully addressable
    from any one process, so np.asarray raises; replicate it first through a
    jitted identity (XLA inserts the all-gather between devices and hosts). Every process
    must call this at the same point — it is a collective there.
    """
    if hasattr(x, "is_fully_addressable") and not x.is_fully_addressable:
        x = _replicator(x.sharding.mesh)(x)
    return np.asarray(x)


def gather_state(st: ShardedState, meta: ShardedMeta) -> MFState:
    """Sharded -> global MFState (host-side inverse of scatter_state).
    Multi-host: collective (see host_fetch) — call on every process."""
    Ush = host_fetch(st.U)
    bush = host_fetch(st.bu)
    k = Ush.shape[-1]
    U = np.zeros((meta.n_users + 1, k), Ush.dtype)
    bu = np.zeros(meta.n_users + 1, bush.dtype)
    valid = meta.user_map < meta.n_users  # [D, upd]
    U[meta.user_map[valid]] = Ush[:, :-1][valid]
    bu[meta.user_map[valid]] = bush[:, :-1][valid]
    return MFState(jnp.asarray(U), st.V, jnp.asarray(bu), st.bi, st.mu)


# ---------------------------------------------------------------------------
# Local (per-device) phase bodies
# ---------------------------------------------------------------------------

def _solve_phase_local(E, F, layout: BlockedCSR, lam: float,
                       alpha=None, base_gram=None, gather_bf16=False):
    """Per-device: re-solve local entity rows of E against F (U-phase)."""
    El = E[0]

    def body(Ec, blk_arrays):
        blk = BlockData(*blk_arrays)
        eid, rows = solve_block(F, blk, lam, gram_weight_alpha=alpha,
                                base_gram=base_gram,
                                base_reg=lam if alpha is not None else 0.0,
                                gather_bf16=gather_bf16)
        return Ec.at[eid].set(rows.astype(Ec.dtype)), None

    El, _ = lax.scan(body, El, tuple(x[0] for x in layout))
    return El[None]


def _gram_psum_phase_local(F_local, layout: BlockedCSR, entity_deg, *,
                           lam: float, n_entities: int,
                           alpha=None, base_gram=None, gather_bf16=False):
    """Per-device: accumulate partial per-entity Grams/RHS from the local
    rating shard, psum over NVLink, then one replicated batched solve.

    This is the SURVEY.md M6 / BASELINE.json:5 V-step: ratings sharded by
    user, per-item Gram matrices all-reduced over the interconnect.
    """
    Fl = F_local[0]
    k = Fl.shape[-1]
    dt = Fl.dtype
    # zeros are "unvarying" under shard_map's VMA tracking; the scan body
    # makes the carry device-varying, so cast the init accordingly
    A0 = lax.pcast(jnp.zeros((n_entities + 1, k, k), dt), (AXIS,),
                   to="varying")
    b0 = lax.pcast(jnp.zeros((n_entities + 1, k), dt), (AXIS,), to="varying")

    F_src = Fl.astype(jnp.bfloat16) if gather_bf16 else Fl

    def body(carry, blk_arrays):
        A, b = carry
        blk = BlockData(*blk_arrays)
        Fg = F_src[blk.other_idx]
        if alpha is None:
            G, bb = chunk_gram_rhs(Fg, blk.rating, acc_dtype=dt)
        else:
            w = alpha * blk.rating
            G, bb = chunk_gram_rhs(Fg, blk.rating, weight=w,
                                   rhs_weight=1.0 + w, acc_dtype=dt)
        As, bs = segment_reduce_block(G, bb, blk.chunk_seg,
                                      blk.entity_ids.shape[0])
        return (A.at[blk.entity_ids].add(As),
                b.at[blk.entity_ids].add(bs)), None

    (A, b), _ = lax.scan(body, (A0, b0), tuple(x[0] for x in layout))
    A = lax.psum(A, AXIS)  # item Gram all-reduce over NVLink [BASELINE.json:5]
    b = lax.psum(b, AXIS)
    if alpha is None:
        reg = lam * entity_deg + (entity_deg == 0)
    else:
        A = A + base_gram[None]
        reg = jnp.full_like(entity_deg, lam)
    return guarded_batched_solve(A, b, reg)


# ---------------------------------------------------------------------------
# Epoch programs (cached per mesh + hyperparams)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=64)
def _als_epoch_fn(mesh: Mesh, lam: float, gather_bf16: bool = False):
    lay_spec = BlockedCSR(*(P(AXIS) for _ in BlockedCSR._fields))

    u_phase = jax.shard_map(
        partial(_solve_phase_local, lam=lam, gather_bf16=gather_bf16),
        mesh=mesh, in_specs=(P(AXIS), P(), lay_spec), out_specs=P(AXIS))

    def epoch(st: ShardedState, data: ShardedData) -> ShardedState:
        n_items = st.V.shape[0] - 1
        U = u_phase(st.U, st.V, data.user_layout)
        v_phase = jax.shard_map(
            partial(_gram_psum_phase_local, lam=lam, n_entities=n_items,
                    gather_bf16=gather_bf16),
            mesh=mesh, in_specs=(P(AXIS), lay_spec, P()), out_specs=P())
        V = v_phase(U, data.item_layout, data.item_deg)
        return st._replace(U=U, V=V)

    return jax.jit(epoch, donate_argnums=(0,))


def sharded_als_epoch(mesh: Mesh, st: ShardedState, data: ShardedData,
                      lam: float, gather_bf16: bool = False) -> ShardedState:
    return _als_epoch_fn(mesh, float(lam), bool(gather_bf16))(st, data)


@lru_cache(maxsize=64)
def _ials_epoch_fn(mesh: Mesh, lam: float, alpha: float,
                   gather_bf16: bool = False):
    lay_spec = BlockedCSR(*(P(AXIS) for _ in BlockedCSR._fields))

    def epoch(st: ShardedState, data: ShardedData) -> ShardedState:
        n_items = st.V.shape[0] - 1
        GV = jnp.einsum("nk,nm->km", st.V, st.V,
                        preferred_element_type=st.V.dtype)

        def u_local(E, F, layout, G):
            return _solve_phase_local(E, F, layout, lam, alpha=alpha,
                                      base_gram=G, gather_bf16=gather_bf16)

        u_phase = jax.shard_map(
            u_local, mesh=mesh,
            in_specs=(P(AXIS), P(), lay_spec, P()), out_specs=P(AXIS))
        U = u_phase(st.U, st.V, data.user_layout, GV)

        def v_local(U_local, layout, deg):
            Ul = U_local[0]
            GU = lax.psum(jnp.einsum("nk,nm->km", Ul, Ul,
                                     preferred_element_type=Ul.dtype), AXIS)
            return _gram_psum_phase_local(U_local, layout, deg, lam=lam,
                                          n_entities=n_items, alpha=alpha,
                                          base_gram=GU,
                                          gather_bf16=gather_bf16)

        v_phase = jax.shard_map(v_local, mesh=mesh,
                                in_specs=(P(AXIS), lay_spec, P()),
                                out_specs=P())
        V = v_phase(U, data.item_layout, data.item_deg)
        return st._replace(U=U, V=V)

    return jax.jit(epoch, donate_argnums=(0,))


def sharded_ials_epoch(mesh: Mesh, st: ShardedState, data: ShardedData,
                       lam: float, alpha: float,
                       gather_bf16: bool = False) -> ShardedState:
    return _ials_epoch_fn(mesh, float(lam), float(alpha),
                          bool(gather_bf16))(st, data)


@lru_cache(maxsize=64)
def _sgd_epoch_fn(mesh: Mesh, lam: float, b_local: int):
    def local(U, bu, V, bi, mu, u, i, r, key, lr):
        Ul, bul = U[0], bu[0]
        upd = Ul.shape[0] - 1
        d = lax.axis_index(AXIS)
        perm = jax.random.permutation(jax.random.fold_in(key, d),
                                      u.shape[1])
        ub = u[0][perm].reshape(-1, b_local)
        ib = i[0][perm].reshape(-1, b_local)
        rb = r[0][perm].reshape(-1, b_local)

        def body(carry, batch):
            Ul, bul, V, bi = carry
            ubt, ibt, rbt = batch
            Uu = Ul[ubt]
            Vi = V[ibt]
            buu = bul[ubt]
            bii = bi[ibt]
            pred = mu + buu + bii + jnp.einsum("nk,nk->n", Uu, Vi)
            m = (ubt < upd).astype(Ul.dtype)
            e = (rbt - pred) * m
            Ul = Ul.at[ubt].add(lr * m[:, None] * (e[:, None] * Vi - lam * Uu))
            bul = bul.at[ubt].add(lr * m * (e - lam * buu))
            # V / b_i deltas cross user shards: psum per batch (P3)
            dV = jnp.zeros_like(V).at[ibt].add(
                lr * m[:, None] * (e[:, None] * Uu - lam * Vi))
            dbi = jnp.zeros_like(bi).at[ibt].add(lr * m * (e - lam * bii))
            V = V + lax.psum(dV, AXIS)
            bi = bi + lax.psum(dbi, AXIS)
            return (Ul, bul, V, bi), None

        (Ul, bul, V, bi), _ = lax.scan(body, (Ul, bul, V, bi), (ub, ib, rb))
        return Ul[None], bul[None], V, bi

    shmapped = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(), P(), P(), P(AXIS), P(AXIS), P(AXIS),
                  P(), P()),
        out_specs=(P(AXIS), P(AXIS), P(), P()))

    def epoch(st: ShardedState, data: ShardedData, key, lr) -> ShardedState:
        U, bu, V, bi = shmapped(st.U, st.bu, st.V, st.bi, st.mu,
                                data.sgd_u, data.sgd_i, data.sgd_r, key, lr)
        return ShardedState(U, V, bu, bi, st.mu)

    return jax.jit(epoch, donate_argnums=(0,))


def sharded_sgd_epoch(mesh: Mesh, st: ShardedState, data: ShardedData,
                      lam: float, lr, key, batch_size: int) -> ShardedState:
    b_local = max(1, batch_size // mesh.devices.size)
    return _sgd_epoch_fn(mesh, float(lam), b_local)(
        st, data, key, jnp.asarray(lr, st.V.dtype))


class BPRShardAux(NamedTuple):
    """Per-shard BPR side tables (leading axis D = the mesh axis)."""

    bits: jnp.ndarray  # [D, upd+1, W] uint32 local-user rated bits
    wu: jnp.ndarray    # [D, upd+1] f32 per-shard "emean" user weights
    wi: jnp.ndarray    # [D, n_items+1] f32 per-shard "emean" item weights


def build_bpr_bits(train_u, train_i, meta: ShardedMeta, batch_size: int,
                   mesh: Mesh | None = None) -> BPRShardAux:
    """Per-shard BPR tables: the packed rated-bits collision slabs (one
    per device, local user rows; trailing trash row zero) plus the
    expected-multiplicity weight vectors for grad_mode="emean", computed
    per shard from ITS stream (local degrees, local batch size — the same
    per-device semantics the sharded "mean" mode has)."""
    from ycnr_tpu.models.bpr import expected_weights, pack_rated_bits

    D, upd = meta.n_shards, meta.upd
    if batch_size <= 0:  # b_local=1 would silently turn emean into sum
        raise ValueError("build_bpr_bits needs the training batch_size "
                         "(the emean weights are per-batch expectations)")
    b_local = max(1, int(batch_size) // D)
    W = (int(meta.n_items) + 31) // 32
    bits = np.zeros((D, upd + 1, W), np.uint32)
    wu = np.zeros((D, upd + 1), np.float32)
    wi = np.zeros((D, int(meta.n_items) + 1), np.float32)
    u = np.asarray(train_u)
    i = np.asarray(train_i)
    shard = meta.user_local[u] // upd
    local = meta.user_local[u] % upd
    for d in range(D):
        m = shard == d
        bits[d] = pack_rated_bits(local[m], i[m], upd, meta.n_items)
        wu[d], wi[d] = expected_weights(local[m], i[m], b_local, upd,
                                        meta.n_items)
    aux = BPRShardAux(jnp.asarray(bits), jnp.asarray(wu), jnp.asarray(wi))
    if mesh is not None:
        aux = jax.tree.map(
            lambda x: jax.device_put(x, NamedSharding(mesh, P(AXIS))), aux)
    return aux


@lru_cache(maxsize=64)
def _bpr_epoch_fn(mesh: Mesh, lam: float, b_local: int, grad_mode: str,
                  shuffle: str = "rows"):
    """DP pairwise-ranking epoch (models/bpr.py on the mesh): positives
    ride the user-sharded SGD stream, negatives are drawn per device, U
    updates stay local, and V / b_i deltas cross user shards via a psum
    per batch (P3, like sharded SGD). Semantics delta vs single-chip: each
    device shuffles and batches ITS OWN rating stream (local batches), and
    grad_mode="mean" multiplicities are per-device — the same local-batch
    delta the sharded SGD path documents (docs/SCALING.md)."""

    def local(U, bi, V, u, i, aux, key, lr):
        Ul, bitsl = U[0], aux.bits[0]
        upd = Ul.shape[0] - 1
        n_items = V.shape[0] - 1
        k = Ul.shape[1]
        d = lax.axis_index(AXIS)
        kp, kn = jax.random.split(jax.random.fold_in(key, d))
        jb = jax.random.randint(kn, (u.shape[1],), 0, n_items,
                                jnp.int32).reshape(-1, b_local)
        if shuffle == "batches":
            # fixed composition (build-time per-shard row shuffle), fresh
            # batch order + negatives per epoch — skips the per-epoch
            # full-row device permutation (models/bpr.bpr_epoch_batches)
            u2 = u[0].reshape(-1, b_local)
            i2 = i[0].reshape(-1, b_local)
            border = jax.random.permutation(kp, u.shape[1] // b_local)
        else:
            perm = jax.random.permutation(kp, u.shape[1])
            ub = u[0][perm].reshape(-1, b_local)
            ib = i[0][perm].reshape(-1, b_local)
        # bias+weight column fusion (models/bpr.bpr_batch_deltas — the ONE
        # copy of the BPR batch math): kills the per-row bias ops AND
        # merges the dV/dbi psums into one collective
        from ycnr_tpu.models.bpr import bpr_batch_deltas, fuse_bpr_state

        Uf, Vf = fuse_bpr_state(Ul, V, bi, aux.wu[0], aux.wi[0],
                                grad_mode)

        def step(Uf, Vf, ubt, ibt, jbt):
            du, dvi, dvj = bpr_batch_deltas(Uf, Vf, bitsl, ubt, ibt, jbt,
                                            upd, lam, lr, grad_mode)
            Uf = Uf.at[ubt].add(du)  # local users: no collective
            # V/b_i rows cross user shards: psum the scattered deltas (P3)
            dVf = jnp.zeros_like(Vf).at[ibt].add(dvi).at[jbt].add(dvj)
            return Uf, Vf + lax.psum(dVf, AXIS)

        if shuffle == "batches":
            def body(carry, s):
                bidx, jbt = s
                Uf, Vf = step(*carry, u2[bidx], i2[bidx], jbt)
                return (Uf, Vf), None

            (Uf, Vf), _ = lax.scan(body, (Uf, Vf), (border, jb))
        else:
            def body(carry, batch):
                ubt, ibt, jbt = batch
                Uf, Vf = step(*carry, ubt, ibt, jbt)
                return (Uf, Vf), None

            (Uf, Vf), _ = lax.scan(body, (Uf, Vf), (ub, ib, jb))
        return Uf[None, :, :k], Vf[:, :k], Vf[:, k].astype(bi.dtype)

    aux_spec = BPRShardAux(P(AXIS), P(AXIS), P(AXIS))
    # check_vma off: Vf carries the per-shard weight column, so the
    # checker cannot statically infer that the returned V/bi slices are
    # replicated — they are (every device adds the SAME psum total to the
    # same replicated input; the weight column never leaks into cols 0..k).
    # The dynamic replacement for the static check is
    # tests/test_bpr_sharded.py::test_sharded_bpr_replica_agreement: bitwise
    # cross-device agreement of V/bi after epochs, all grad_mode x shuffle
    shmapped = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(AXIS), P(), P(), P(AXIS), P(AXIS), aux_spec, P(), P()),
        out_specs=(P(AXIS), P(), P()), check_vma=False)

    def epoch(st: ShardedState, data: ShardedData, aux, key,
              lr) -> ShardedState:
        U, V, bi = shmapped(st.U, st.bi, st.V, data.sgd_u, data.sgd_i,
                            aux, key, lr)
        return st._replace(U=U, V=V, bi=bi)

    return jax.jit(epoch, donate_argnums=(0,))


def sharded_bpr_epoch(mesh: Mesh, st: ShardedState, data: ShardedData,
                      aux: BPRShardAux, lam: float, lr, key,
                      batch_size: int, grad_mode: str = "mean",
                      shuffle: str = "rows") -> ShardedState:
    from ycnr_tpu.models.bpr import check_shuffle

    check_shuffle(shuffle)
    b_local = max(1, batch_size // mesh.devices.size)
    return _bpr_epoch_fn(mesh, float(lam), b_local, str(grad_mode),
                         str(shuffle))(
        st, data, aux, key, jnp.asarray(lr, st.V.dtype))


@lru_cache(maxsize=16)
def _topn_fn(mesh: Mesh, n: int, with_bits: bool):
    lay_spec = BlockedCSR(*(P(AXIS) for _ in BlockedCSR._fields))

    def local(U, bu, V, bi, mu, lay_arrays, bits):
        from ycnr_tpu.eval.recommend import _pad_items, topn_block
        from ycnr_tpu.ops.gram import BlockData as BD

        if with_bits:  # align scores to the bitmask width (see _topn_blocks)
            V, bi = _pad_items(V, bi, bits.shape[-1])

        def body(_, xs):
            blk = BD(*xs[:5])
            rb = xs[5] if with_bits else None
            return None, topn_block(U[0], V, bu[0], bi, mu, blk, n,
                                    rated_bits=rb)

        xs = tuple(x[0] for x in lay_arrays)
        if with_bits:
            xs = xs + (bits[0],)
        _, (ids, sc) = lax.scan(body, None, xs)
        return ids[None], sc[None]

    return jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(), P(), P(), lay_spec,
                  P(AXIS) if with_bits else P()),
        out_specs=(P(AXIS), P(AXIS)), check_vma=True))


def sharded_recommend_all(mesh: Mesh, st: ShardedState, data: ShardedData,
                          meta: ShardedMeta, n: int = 10, rated_bits=None):
    """Top-N for every rated user, computed ON the mesh: each device scores
    its own user shard against the replicated V and masks with its local
    layout (BASELINE config 5: 'full top-N serving over the mesh').

    rated_bits [D, NB, U_B, W]: packed rated mask from
    ``eval.recommend.build_rated_bits`` applied to the HOST per-shard user
    layout (before device_put), sharded like the layout. Selects the fused
    mask + segment-top-k fast path; None keeps the scatter reference path.

    Returns (user_ids, item_ids [m, n], scores [m, n]) as numpy in GLOBAL
    user ids.
    """
    with_bits = rated_bits is not None
    bits_arg = rated_bits if with_bits else jnp.zeros((), jnp.uint32)
    ids, sc = _topn_fn(mesh, n, with_bits)(
        st.U, st.bu, st.V, st.bi, st.mu, data.user_layout, bits_arg)
    ids = host_fetch(ids)  # [D, NB, U_B, n]
    sc = host_fetch(sc)
    eids_local = host_fetch(data.user_layout.entity_ids)  # [D, NB, U_B]
    D = meta.n_shards
    out_u, out_i, out_s = [], [], []
    for d in range(D):
        slots = eids_local[d].reshape(-1)
        real = slots < meta.upd
        out_u.append(meta.user_map[d][slots[real]])
        out_i.append(ids[d].reshape(-1, n)[real])
        out_s.append(sc[d].reshape(-1, n)[real])
    return (np.concatenate(out_u), np.concatenate(out_i),
            np.concatenate(out_s))


@lru_cache(maxsize=8)
def _rmse_fn(mesh: Mesh):
    def local(U, bu, V, bi, mu, tu, ti, tr):
        Ul, bul = U[0], bu[0]
        upd = Ul.shape[0] - 1
        pred = mu + bul[tu[0]] + bi[ti[0]] + jnp.einsum(
            "nk,nk->n", Ul[tu[0]], V[ti[0]])
        e = jnp.where(tu[0] < upd, tr[0] - pred, 0.0)
        return lax.psum(jnp.sum(e * e, keepdims=True), AXIS)

    shmapped = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(), P(), P(), P(AXIS), P(AXIS), P(AXIS)),
        out_specs=P())

    def rmse_sq(st: ShardedState, data: ShardedData):
        return shmapped(st.U, st.bu, st.V, st.bi, st.mu,
                        data.test_u, data.test_i, data.test_r)

    return jax.jit(rmse_sq)


def sharded_rmse(mesh: Mesh, st: ShardedState, data: ShardedData,
                 test_n: int) -> float:
    sq = _rmse_fn(mesh)(st, data)
    return float(np.sqrt(np.asarray(sq)[0] / max(test_n, 1)))
