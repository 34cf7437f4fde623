"""Dual-sharded ALS/iALS: users AND items sharded; all-gather the other side.

The second V-step strategy of SURVEY.md M6 ("item_sharded"): instead of
keeping ratings user-sharded and psum-ing per-item Gram matrices
([n_items, k, k] — 0.44 GB at ML-20M rank 64), shard the item axis too and
re-bucket each shard's ratings by item. Per epoch the mesh then moves only
two factor all-gathers (U: ~35 MB, V: ~7 MB at ML-20M) over NVLink, and the
item solves are sharded instead of replicated.

Index convention ("cat space"): with D shards and per-shard padded sizes
upd/ipd, global user u living at (shard d, local j) is addressed as
d*(upd+1)+j in the all-gathered U_cat = all_gather(U_local) of shape
[D*(upd+1), k]. Every shard's row `upd` is an all-zero trash row, so layout
padding points at cat index D*(upd+1)-1 (the last shard's trash row) and
the zero-row trick holds unchanged.

SGD keeps the V-replicated scheme of parallel.shard (its per-batch V deltas
are global); this module covers the alternating solvers.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ycnr_tpu.models.base import MFState
from ycnr_tpu.ops.gram import BlockData, solve_block
from ycnr_tpu.ops.layout import BlockedCSR, build_blocked_csr
from ycnr_tpu.parallel.mesh import AXIS
from ycnr_tpu.parallel.shard import (
    _device_stacked,
    _lpt_partition,
    _pad_blocks,
    _stack_layouts,
    _stack_ragged,
)


class DualState(NamedTuple):
    U: jnp.ndarray  # [D, upd+1, k] sharded on axis 0 (local user rows)
    V: jnp.ndarray  # [D, ipd+1, k] sharded on axis 0 (local item rows)
    mu: jnp.ndarray  # scalar (ALS/iALS keep no biases)


class DualData(NamedTuple):
    user_layout: BlockedCSR  # [D, NB_u, ...] entity=local user, other=V cat
    item_layout: BlockedCSR  # [D, NB_i, ...] entity=local item, other=U cat
    test_u: jnp.ndarray  # [D, n_test] local user idx (pad -> upd)
    test_i: jnp.ndarray  # [D, n_test] V cat idx (pad -> ipd)
    test_r: jnp.ndarray  # [D, n_test]


@dataclass
class DualMeta:
    n_users: int
    n_items: int
    n_shards: int
    upd: int
    ipd: int
    user_map: np.ndarray  # [D, upd] global user per slot (pad n_users)
    item_map: np.ndarray  # [D, ipd] global item per slot (pad n_items)
    user_cat: np.ndarray  # [n_users] cat index of each user
    item_cat: np.ndarray  # [n_items] cat index of each item
    test_n: int
    user_layout_host: "BlockedCSR | None" = None  # numpy copy for serving
    #   mask builders (dual_rated_bits); kept only when requested


def _partition(idx_count: np.ndarray, D: int):
    members, shard_of = _lpt_partition(idx_count, D)
    pd = max(len(m) for m in members)
    emap = np.full((D, pd), len(idx_count), np.int32)
    cat = np.zeros(len(idx_count), np.int64)
    for d, m in enumerate(members):
        emap[d, : len(m)] = m
        for j, e in enumerate(m):
            cat[e] = d * (pd + 1) + j
    return members, shard_of, pd, emap, cat


def build_dual_sharded_data(
    train_u, train_i, train_r, n_users: int, n_items: int, n_shards: int,
    chunk_len: int = 32, block_chunks=None, rank_hint: int = 64,
    test_u=None, test_i=None, test_r=None, dtype=jnp.float32,
    mesh: Mesh | None = None, host_user_layout: bool = False,
):
    D = n_shards
    train_u = np.asarray(train_u)
    train_i = np.asarray(train_i)
    train_r = np.asarray(train_r, np.float32)
    deg_u = np.bincount(train_u, minlength=n_users)
    deg_i = np.bincount(train_i, minlength=n_items)
    _, ushard, upd, user_map, user_cat = _partition(deg_u, D)
    _, ishard, ipd, item_map, item_cat = _partition(deg_i, D)

    uper = [np.nonzero(ushard[train_u] == d)[0] for d in range(D)]
    iper = [np.nonzero(ishard[train_i] == d)[0] for d in range(D)]

    max_user_chunks = int(np.max(-(-deg_u // chunk_len), initial=1))
    max_item_chunks = int(np.max(-(-deg_i // chunk_len), initial=1))
    if block_chunks is None:
        from ycnr_tpu.ops.layout import _auto_block_chunks

        total = int(-(-len(train_r) // (chunk_len * max(D, 1))))
        block_chunks = _auto_block_chunks(max(total, 1), chunk_len, rank_hint)
    C_B = max(block_chunks, max_user_chunks, max_item_chunks)

    from ycnr_tpu.ops.layout import _auto_block_entities

    ub_u = max(_auto_block_entities(
        C_B, max(1, int(np.count_nonzero(np.bincount(train_u[p], minlength=1)))),
        max(1, int(-(-len(p) // chunk_len)))) for p in uper)
    ub_i = max(_auto_block_entities(
        C_B, max(1, int(np.count_nonzero(np.bincount(train_i[p], minlength=1)))),
        max(1, int(-(-len(p) // chunk_len)))) for p in iper)

    u_local = user_cat % (upd + 1)
    i_local = item_cat % (ipd + 1)
    u_lays, i_lays = [], []
    for d in range(D):
        p = uper[d]
        u_lays.append(build_blocked_csr(
            u_local[train_u[p]], item_cat[train_i[p]], train_r[p],
            upd, D * (ipd + 1) - 1, chunk_len, C_B, block_entities=ub_u))
        q = iper[d]
        i_lays.append(build_blocked_csr(
            i_local[train_i[q]], user_cat[train_u[q]], train_r[q],
            ipd, D * (upd + 1) - 1, chunk_len, C_B, block_entities=ub_i))
    nb_u = max(l.n_blocks for l in u_lays)
    nb_i = max(l.n_blocks for l in i_lays)
    u_lays = [_pad_blocks(l, nb_u, upd, D * (ipd + 1) - 1) for l in u_lays]
    i_lays = [_pad_blocks(l, nb_i, ipd, D * (upd + 1) - 1) for l in i_lays]
    user_layout, item_layout = _stack_layouts(u_lays), _stack_layouts(i_lays)

    if test_u is None:
        test_u = np.zeros(0, np.int32)
        test_i = np.zeros(0, np.int32)
        test_r = np.zeros(0, np.float32)
    test_u = np.asarray(test_u)
    test_i = np.asarray(test_i)
    test_r = np.asarray(test_r, np.float32)
    tper = [np.nonzero(ushard[test_u] == d)[0] for d in range(D)]
    # test item padding -> ipd = shard-0's trash row in cat space
    tu, ti, tr = _stack_ragged(
        [(u_local[test_u[p]], item_cat[test_i[p]], test_r[p]) for p in tper],
        pads=(upd, ipd, 0.0))

    data = DualData(user_layout=_device_stacked(user_layout, dtype),
                    item_layout=_device_stacked(item_layout, dtype),
                    test_u=jnp.asarray(tu), test_i=jnp.asarray(ti),
                    test_r=jnp.asarray(tr, dtype))
    meta = DualMeta(n_users=n_users, n_items=n_items, n_shards=D, upd=upd,
                    ipd=ipd, user_map=user_map, item_map=item_map,
                    user_cat=user_cat, item_cat=item_cat, test_n=len(test_r),
                    user_layout_host=user_layout if host_user_layout
                    else None)
    if mesh is not None:
        lay_spec = BlockedCSR(*(P(AXIS) for _ in BlockedCSR._fields))
        specs = DualData(user_layout=lay_spec, item_layout=lay_spec,
                         test_u=P(AXIS), test_i=P(AXIS), test_r=P(AXIS))
        data = jax.tree.map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), data,
            specs)
    return data, meta


def dual_scatter_state(state: MFState, meta: DualMeta,
                       mesh: Mesh | None = None) -> DualState:
    k = state.U.shape[1]
    U = np.asarray(state.U)
    V = np.asarray(state.V)
    Ush = np.zeros((meta.n_shards, meta.upd + 1, k), U.dtype)
    Vsh = np.zeros((meta.n_shards, meta.ipd + 1, k), V.dtype)
    Ush[:, : meta.upd] = U[meta.user_map]
    Vsh[:, : meta.ipd] = V[meta.item_map]
    st = DualState(jnp.asarray(Ush), jnp.asarray(Vsh), state.mu)
    if mesh is not None:
        st = jax.tree.map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), st,
            DualState(P(AXIS), P(AXIS), P()))
    return st


def dual_gather_state(st: DualState, meta: DualMeta) -> MFState:
    from ycnr_tpu.parallel.shard import host_fetch

    Ush = host_fetch(st.U)
    Vsh = host_fetch(st.V)
    k = Ush.shape[-1]
    U = np.zeros((meta.n_users + 1, k), Ush.dtype)
    V = np.zeros((meta.n_items + 1, k), Vsh.dtype)
    uv = meta.user_map < meta.n_users
    iv = meta.item_map < meta.n_items
    U[meta.user_map[uv]] = Ush[:, :-1][uv]
    V[meta.item_map[iv]] = Vsh[:, :-1][iv]
    dt = st.U.dtype
    return MFState(jnp.asarray(U), jnp.asarray(V),
                   jnp.zeros(meta.n_users + 1, dt),
                   jnp.zeros(meta.n_items + 1, dt), st.mu)


def _phase_local(E_local, F_cat, layout: BlockedCSR, lam, alpha=None,
                 base_gram=None, gather_bf16=False):
    def body(Ec, blk_arrays):
        blk = BlockData(*blk_arrays)
        eid, rows = solve_block(F_cat, blk, lam, gram_weight_alpha=alpha,
                                base_gram=base_gram,
                                base_reg=lam if alpha is not None else 0.0,
                                gather_bf16=gather_bf16)
        return Ec.at[eid].set(rows.astype(Ec.dtype)), None

    E_local, _ = lax.scan(body, E_local, tuple(x[0] for x in layout))
    return E_local


@lru_cache(maxsize=64)
def _dual_epoch_fn(mesh: Mesh, lam: float, alpha, gather_bf16: bool = False):
    lay_spec = BlockedCSR(*(P(AXIS) for _ in BlockedCSR._fields))

    def local(U, V, ul_arrays, il_arrays):
        # U [1, upd+1, k] local; V [1, ipd+1, k] local
        if alpha is None:
            GV = GU_fn = None
            V_cat = lax.all_gather(V[0], AXIS, axis=0, tiled=True)
            Ul = _phase_local(U[0], V_cat, ul_arrays, lam,
                              gather_bf16=gather_bf16)
            U_cat = lax.all_gather(Ul, AXIS, axis=0, tiled=True)
            Vl = _phase_local(V[0], U_cat, il_arrays, lam,
                              gather_bf16=gather_bf16)
        else:
            V_cat = lax.all_gather(V[0], AXIS, axis=0, tiled=True)
            GV = lax.psum(jnp.einsum("nk,nm->km", V[0], V[0],
                                     preferred_element_type=V.dtype), AXIS)
            Ul = _phase_local(U[0], V_cat, ul_arrays, lam, alpha, GV,
                              gather_bf16=gather_bf16)
            U_cat = lax.all_gather(Ul, AXIS, axis=0, tiled=True)
            GU = lax.psum(jnp.einsum("nk,nm->km", Ul, Ul,
                                     preferred_element_type=U.dtype), AXIS)
            Vl = _phase_local(V[0], U_cat, il_arrays, lam, alpha, GU,
                              gather_bf16=gather_bf16)
        return Ul[None], Vl[None]

    shmapped = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), lay_spec, lay_spec),
        out_specs=(P(AXIS), P(AXIS)))

    def epoch(st: DualState, data: DualData) -> DualState:
        U, V = shmapped(st.U, st.V, data.user_layout, data.item_layout)
        return DualState(U, V, st.mu)

    return jax.jit(epoch, donate_argnums=(0,))


def dual_als_epoch(mesh: Mesh, st: DualState, data: DualData,
                   lam: float, gather_bf16: bool = False) -> DualState:
    return _dual_epoch_fn(mesh, float(lam), None, bool(gather_bf16))(st, data)


def dual_ials_epoch(mesh: Mesh, st: DualState, data: DualData, lam: float,
                    alpha: float, gather_bf16: bool = False) -> DualState:
    return _dual_epoch_fn(mesh, float(lam), float(alpha),
                          bool(gather_bf16))(st, data)


@lru_cache(maxsize=8)
def _dual_rmse_fn(mesh: Mesh):
    def local(U, V, mu, tu, ti, tr):
        V_cat = lax.all_gather(V[0], AXIS, axis=0, tiled=True)
        upd = U.shape[1] - 1
        pred = mu + jnp.einsum("nk,nk->n", U[0][tu[0]], V_cat[ti[0]])
        e = jnp.where(tu[0] < upd, tr[0] - pred, 0.0)
        return lax.psum(jnp.sum(e * e, keepdims=True), AXIS)

    shmapped = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(), P(AXIS), P(AXIS), P(AXIS)),
        out_specs=P())
    return jax.jit(lambda st, data: shmapped(
        st.U, st.V, st.mu, data.test_u, data.test_i, data.test_r))


def dual_rmse(mesh: Mesh, st: DualState, data: DualData,
              test_n: int) -> float:
    sq = _dual_rmse_fn(mesh)(st, data)
    return float(np.sqrt(np.asarray(sq)[0] / max(test_n, 1)))


def dual_rated_bits(meta: DualMeta) -> np.ndarray:
    """Packed serving mask in item-CAT space [D, NB, U_B, W].

    Beyond each user's rated items, every cat slot that is not a real item
    (per-shard padding slots and trash rows — their V rows are zero, so
    they'd score mu and outrank negatively-scored real items) is masked.
    Needs build_dual_sharded_data(host_user_layout=True).
    """
    from ycnr_tpu.eval.recommend import build_rated_bits

    if meta.user_layout_host is None:
        raise ValueError("build data with host_user_layout=True for serving")
    n_cat = meta.n_shards * (meta.ipd + 1)
    bits = build_rated_bits(meta.user_layout_host, n_cat - 1)
    valid = np.zeros(bits.shape[-1] * 32, bool)
    for d in range(meta.n_shards):
        base = d * (meta.ipd + 1)
        valid[base : base + meta.ipd] = meta.item_map[d] < meta.n_items
    shifts = (np.uint32(1) << np.arange(32, dtype=np.uint32))[None, :]
    inv_words = np.bitwise_or.reduce(
        np.where(~valid.reshape(-1, 32), shifts, np.uint32(0)), axis=1)
    return bits | inv_words  # broadcast over [D, NB, U_B, W]


@lru_cache(maxsize=16)
def _dual_topn_fn(mesh: Mesh, n: int):
    """Top-n on the mesh with V sharded: all-gather V into cat space once
    per call, score each shard's local users against it, mask with the
    cat-space rated bits, exact segment top-k (eval.recommend fast path)."""
    lay_spec = BlockedCSR(*(P(AXIS) for _ in BlockedCSR._fields))

    def local(U, V, mu, lay_arrays, bits):
        from ycnr_tpu.eval.recommend import _pad_items, topn_block

        V_cat = lax.all_gather(V[0], AXIS, axis=0, tiled=True)
        bi = jnp.zeros(V_cat.shape[0], V_cat.dtype)
        bu = jnp.zeros(U.shape[1], U.dtype)
        Vp, bip = _pad_items(V_cat, bi, bits.shape[-1])

        def body(_, xs):
            blk = BlockData(*xs[:5])
            return None, topn_block(U[0], Vp, bu, bip, mu, blk, n,
                                    rated_bits=xs[5])

        xs = tuple(x[0] for x in lay_arrays) + (bits[0],)
        _, (ids, sc) = lax.scan(body, None, xs)
        return ids[None], sc[None]

    return jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(), lay_spec, P(AXIS)),
        out_specs=(P(AXIS), P(AXIS)), check_vma=True))


def dual_recommend_all(mesh: Mesh, st: DualState, data: DualData,
                       meta: DualMeta, n: int = 10, rated_bits=None):
    """Top-N for every rated user ON the mesh in dual (item-sharded) mode.

    Returns (user_ids, item_ids [m, n], scores [m, n]) as numpy in GLOBAL
    ids. rated_bits: device-put dual_rated_bits(meta) for repeated serving;
    built (and left unsharded) automatically when None.
    """
    if meta.user_layout_host is None:
        # needed below for entity ids even when rated_bits is prebuilt
        raise ValueError("build data with host_user_layout=True for serving")
    if rated_bits is None:
        rated_bits = jax.device_put(dual_rated_bits(meta),
                                    NamedSharding(mesh, P(AXIS)))
    ids, sc = _dual_topn_fn(mesh, n)(st.U, st.V, st.mu,
                                             data.user_layout, rated_bits)
    from ycnr_tpu.parallel.shard import host_fetch

    ids = host_fetch(ids)  # [D, NB, U_B, n] item-cat indices
    sc = host_fetch(sc)
    # cat -> global item lookup (padded score columns -> n_items)
    n_cat = meta.n_shards * (meta.ipd + 1)
    lut = np.full(rated_bits.shape[-1] * 32, meta.n_items, np.int64)
    for d in range(meta.n_shards):
        base = d * (meta.ipd + 1)
        lut[base : base + meta.ipd] = meta.item_map[d]
    assert n_cat <= len(lut)
    eids_local = np.asarray(meta.user_layout_host.entity_ids)  # [D, NB, U_B]
    out_u, out_i, out_s = [], [], []
    for d in range(meta.n_shards):
        slots = eids_local[d].reshape(-1)
        real = slots < meta.upd
        out_u.append(meta.user_map[d][slots[real]])
        out_i.append(lut[ids[d].reshape(-1, n)[real]])
        out_s.append(sc[d].reshape(-1, n)[real])
    return (np.concatenate(out_u), np.concatenate(out_i),
            np.concatenate(out_s))
