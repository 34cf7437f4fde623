"""Sharded out-of-core training: the OOC wire format over a device mesh.

Mode A (docs/SCALING.md "OOC x mesh") composed with the wire tiers of
models/ooc.py:

* U-step (P1): the GLOBAL user-view wire is sliced into contiguous
  per-shard block runs group by group — blocks hold disjoint consecutive
  entities (ops/packed.py), so any block partition is a user partition,
  and equal slices of a rung group are load-balanced to within one block
  (same NE x R cost per block; the LPT pass of the resident sharded path
  is unnecessary here). Each device decodes its blocks, solves against
  the replicated V, and writes a LOCAL wire-ordered table; the local
  factor assembles by gather (scatter-free, models/ooc.py rationale).
* V-step (P2): each shard re-encodes ITS ratings as a local ITEM-view
  wire (entity = global item, other = LOCAL user row), accumulates
  partial per-item normal equations from the decode, and the mesh
  `psum`s them before one replicated guarded solve — the
  BASELINE.json:5 collective, identical to parallel/shard.py's
  `_gram_psum_phase_local` with the block source swapped from the
  resident layout to the wire decode.
* P4: SPMD program order; the psum is the epoch barrier.

Device memory per card holds factors + 1/D of the wire (2.6-3x smaller
than the decoded layout), so D cards raise the full-speed pinned bound
D-fold. Beyond the pin,
the STREAMED tier re-feeds the wire per epoch with per-process transport:
`feed_sharded_wire` uploads only the [D]-axis rows each process's local
devices own (make_array_from_single_device_arrays over addressable
shards), and `make_sharded_ooc_epoch(..., wire_as_args=True)` donates
the wire buffers so a shard's wire occupies HBM only while its epoch
consumes it. On a real multi-host pod each host therefore streams just
its own shard over its own PCIe link; tests/dcn_worker.py proves the
locality on a 2-process DCN rendezvous by corrupting every non-local
row before feeding (results stay bitwise equal to the pinned epoch).
Chunk-granular overlap of feed and compute within an epoch (the
single-chip models/ooc.py prefetch ladder) composes per host on top of
this transport and is left to real-pod tuning.

State reuses parallel/shard.ShardedState ([D, upd+1, k] local-user U,
replicated V) and is convertible with scatter_state/gather_state through
a compatible ShardedMeta, so checkpointing, serving, and eval compose
unchanged. Parity: sharded-OOC factors match the single-chip OOC epoch
to f64 reduction-order tightness (tests/test_ooc_mesh.py), the same
standard as the resident sharded suite (BASELINE.json:5 asks 1e-5).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ycnr_tpu.models.bucketed_phase import bucket_normal_eq
from ycnr_tpu.models.ooc import decode_block, decode_block_rect
from ycnr_tpu.ops.gram import guarded_batched_solve
from ycnr_tpu.ops.packed import PackedGroup, build_packed
from ycnr_tpu.parallel.mesh import AXIS
from ycnr_tpu.parallel.shard import ShardedMeta, ShardedState

_WIRE = ("lo", "hi_pos", "hi_val", "rat", "cnt", "eid")


class ShardedWire(NamedTuple):
    """Device-ready sharded wire for one ALS/iALS mode-A epoch.

    ``ugroups``/``igroups``: tuples of PackedGroup whose array leaves
    carry a leading [D] mesh axis ([D, NB, ...]); u-view eid is the
    GLOBAL user id (pad n_users), i-view eid the GLOBAL item id (pad
    n_items), i-view deltas encode LOCAL user rows (pad upd).
    ``u_off``: per u-group [NB] local wire-order row offsets (identical
    across shards by construction). ``inv_local`` [D, upd+1] maps local
    user row -> wire-order row (sentinel u_rows = cold/trash -> 0).
    ``item_deg`` [n_items+1] global item degrees (solve regularizer)."""

    ugroups: Tuple[PackedGroup, ...]
    igroups: Tuple[PackedGroup, ...]
    u_off: Tuple[np.ndarray, ...]
    inv_local: jnp.ndarray
    item_deg: jnp.ndarray
    u_rows: int      # local wire-order rows (incl. none of the scratch)
    u_scratch: int   # scratch rows appended for chunk-pad writes


def _slice_group(g: PackedGroup, D: int) -> PackedGroup:
    """[NB, ...] wire group -> [D, NBD, ...] contiguous block slices,
    padded with empty blocks (cnt 0, eid n_entities — decode to nothing)."""
    nb = g.n_blocks
    nbd = -(-nb // D)
    out = {}
    for name in _WIRE:
        a = np.asarray(getattr(g, name))
        pad_shape = (nbd * D - nb,) + a.shape[1:]
        if name == "eid":
            pad = np.full(pad_shape, np.int32(2**31 - 2), a.dtype)
        else:
            pad = np.zeros(pad_shape, a.dtype)
        out[name] = np.concatenate([a, pad]).reshape((D, nbd) + a.shape[1:])
    # pad eid rows target one-past-last (dropped); but the U-step routes
    # by OFFSET, not eid — pad blocks write zero rows into real slots of
    # the local table, which the assembly never reads (their inv entries
    # don't exist). eid stays for bookkeeping/debug only on the u-view.
    return g._replace(**out)


def _pad_to(a: np.ndarray, shape, fill=0) -> np.ndarray:
    out = np.full(shape, fill, a.dtype)
    out[tuple(slice(0, s) for s in a.shape)] = a
    return out


def build_sharded_wire(tu, ti, tr, n_users: int, n_items: int, D: int,
                       rank_hint: int = 64, max_groups: int = 8,
                       target_bytes: int = 48 * 2**20,
                       mesh: Optional[Mesh] = None, dtype=jnp.float32):
    """Partition ratings by user across D shards, in wire format.

    Returns (ShardedWire, ShardedMeta, ShardedState-init kwargs are the
    caller's job via parallel.shard.scatter_state). The user-view wire is
    built ONCE globally and sliced per shard (same groups, same decode
    programs on every shard); the item views are built per shard from the
    shard's ratings with LOCAL user rows and shape-padded to a common
    [D, ...] stack (a group's R becomes the max over shards — padding
    slots decode to nothing, exactly like in-block padding)."""
    tu = np.asarray(tu)
    ti = np.asarray(ti)
    tr = np.asarray(tr, np.float32)

    # ---- user view: global wire, contiguous block slices per shard ----
    ug = build_packed(tu, ti, tr, n_users, n_items, rank_hint=rank_hint,
                      target_bytes=target_bytes, max_groups=max_groups)
    ugroups = tuple(_slice_group(g, D) for g in ug)

    # per-shard membership + local offsets (identical across shards)
    u_off, base = [], 0
    scratch = 1
    user_map_lists = [[] for _ in range(D)]
    inv_pos = [[] for _ in range(D)]
    for g, gs in zip(ug, ugroups):
        nbd, NE = gs.cnt.shape[1], gs.cnt.shape[2]
        u_off.append(base + np.arange(nbd, dtype=np.int32) * NE)
        scratch = max(scratch, NE)
        eid = np.asarray(gs.eid)  # [D, nbd, NE]
        for d in range(D):
            e = eid[d].ravel()
            m = e < n_users
            user_map_lists[d].append(e[m])
            inv_pos[d].append(base + np.nonzero(m)[0].astype(np.int64))
        base += nbd * NE
    u_rows = base

    # cold (zero-rating) users appear in no wire block; deal them to the
    # smallest member lists so they still own a local row — their factor
    # assembles to the sentinel 0 and held-out rows against them are
    # counted by sharded_rmse exactly as on one chip (pred = 0), the same
    # contract as the resident LPT partition (parallel/shard.py)
    seen = np.zeros(n_users, bool)
    for lst in user_map_lists:
        for x in lst:
            seen[x] = True
    cold = np.nonzero(~seen)[0]
    counts = [sum(len(x) for x in lst) for lst in user_map_lists]
    by_count = sorted(range(D), key=lambda d: counts[d])
    for j, cu in enumerate(cold):
        user_map_lists[by_count[j % D]].append(np.asarray([cu], np.int32))
    counts = [sum(len(x) for x in lst) for lst in user_map_lists]
    upd = int(-(-max(max(counts), 1) // 8) * 8)
    user_map = np.full((D, upd), n_users, np.int32)
    user_local = np.full(n_users, 0, np.int64)
    inv_local = np.full((D, upd + 1), u_rows, np.int32)
    for d in range(D):
        ids = (np.concatenate(user_map_lists[d]) if user_map_lists[d]
               else np.zeros(0, np.int32))
        pos = (np.concatenate(inv_pos[d]) if inv_pos[d]
               else np.zeros(0, np.int64))
        user_map[d, : len(ids)] = ids
        user_local[ids] = d * upd + np.arange(len(ids))
        inv_local[d, : len(pos)] = pos  # wire members lead; cold follow

    # ---- item view: per-shard local wires, shape-padded + stacked ----
    shard_of = np.full(n_users, -1, np.int32)
    for d in range(D):
        m = user_map[d] < n_users
        shard_of[user_map[d][m]] = d
    loc_row = (user_local % upd).astype(np.int32)
    per_shard = []
    n_groups_i = 0
    for d in range(D):
        m = shard_of[tu] == d
        gi = build_packed(ti[m], loc_row[tu[m]], tr[m], n_items, upd,
                          rank_hint=rank_hint, target_bytes=target_bytes,
                          max_groups=max_groups)
        per_shard.append(gi)
        n_groups_i = max(n_groups_i, len(gi))

    # a rating SUBSET can qualify for the int8 half-star wire while the
    # full set (or another shard) does not — stacking int8 next to f32
    # would silently promote the CODES (2x the rating). Force one kind.
    kinds = {g.rating_kind for s in per_shard for g in s}
    if len(kinds) > 1:
        def as_raw(g):
            if g.rating_kind != "half":
                return g
            return g._replace(rat=np.asarray(g.rat, np.float32) * 0.5,
                              rating_kind="raw")

        per_shard = [tuple(as_raw(g) for g in s) for s in per_shard]

    igroups = []
    for gidx in range(n_groups_i):
        gs = [s[gidx] if gidx < len(s) else None for s in per_shard]
        live = [g for g in gs if g is not None]
        R = max(g.R for g in live)
        kind = live[0].rating_kind
        dims = {}
        for name in _WIRE:
            dims[name] = tuple(
                max((np.asarray(getattr(g, name)).shape[i] for g in live))
                for i in range(np.asarray(getattr(live[0], name)).ndim))
        stacked = {}
        for name in _WIRE:
            mats = []
            for g in gs:
                if g is None:
                    fill = n_items if name == "eid" else 0
                    mats.append(np.full(dims[name],
                                        fill,
                                        np.asarray(getattr(live[0],
                                                           name)).dtype))
                else:
                    a = np.asarray(getattr(g, name))
                    fill = n_items if name == "eid" else 0
                    mats.append(_pad_to(a, dims[name], fill))
            stacked[name] = np.stack(mats)
        igroups.append(PackedGroup(R=R, n_other=upd, rating_kind=kind,
                                   **stacked))

    item_deg = np.bincount(ti, minlength=n_items).astype(np.float32)
    item_deg = np.concatenate([item_deg, np.zeros(1, np.float32)])

    sw = ShardedWire(ugroups=ugroups, igroups=tuple(igroups),
                     u_off=tuple(u_off),
                     inv_local=jnp.asarray(inv_local),
                     item_deg=jnp.asarray(item_deg),
                     u_rows=int(u_rows), u_scratch=int(scratch))
    meta = ShardedMeta(n_users=n_users, n_items=n_items, n_shards=D,
                       upd=upd, user_map=user_map, user_local=user_local,
                       test_n=0, sgd_n=0)
    if mesh is not None:
        sw = put_sharded_wire(sw, mesh)
    return sw, meta


def put_sharded_wire(sw: ShardedWire, mesh: Mesh) -> ShardedWire:
    """Place the [D, ...] wire leaves over the mesh axis (each shard's
    slice lands in its device's HBM — the sharded analog of
    models/ooc.wire_to_device's pinning)."""
    def put_groups(groups):
        out = []
        for g in groups:
            arrs = {n: jax.device_put(
                np.ascontiguousarray(np.asarray(getattr(g, n))),
                NamedSharding(mesh, P(AXIS)))
                for n in _WIRE}
            out.append(g._replace(**arrs))
        return tuple(out)

    return sw._replace(
        ugroups=put_groups(sw.ugroups), igroups=put_groups(sw.igroups),
        inv_local=jax.device_put(np.asarray(sw.inv_local),
                                 NamedSharding(mesh, P(AXIS))),
        item_deg=jax.device_put(np.asarray(sw.item_deg),
                                NamedSharding(mesh, P())))


def _feed_local(a: np.ndarray, sharding: NamedSharding) -> jax.Array:
    """Assemble a global array from per-device uploads, touching ONLY the
    rows this process's devices own (addressable-shard indices). On a
    multi-host topology every host therefore streams just its own slice
    over its own local link — no host reads another host's rows."""
    a = np.asarray(a)
    idx_map = sharding.addressable_devices_indices_map(a.shape)
    shards = [jax.device_put(np.ascontiguousarray(a[idx]), d)
              for d, idx in idx_map.items()]
    return jax.make_array_from_single_device_arrays(a.shape, sharding,
                                                    shards)


def feed_sharded_wire(sw: ShardedWire, mesh: Mesh) -> ShardedWire:
    """Per-process wire feeding (the streamed OOC x mesh tier's transport):
    like put_sharded_wire, but each process contributes only the [D]-axis
    rows its local devices own. Pair with
    ``make_sharded_ooc_epoch(..., wire_as_args=True)`` — the epoch donates
    the wire buffers, so HBM holds the shard's wire only while its epoch
    runs; the caller re-feeds per epoch from per-host storage
    (tests/dcn_worker.py proves locality by corrupting non-local rows)."""
    shard = NamedSharding(mesh, P(AXIS))
    repl = NamedSharding(mesh, P())

    def feed_groups(groups):
        return tuple(
            g._replace(**{n: _feed_local(getattr(g, n), shard)
                          for n in _WIRE})
            for g in groups)

    return sw._replace(
        ugroups=feed_groups(sw.ugroups), igroups=feed_groups(sw.igroups),
        inv_local=_feed_local(sw.inv_local, shard),
        item_deg=_feed_local(sw.item_deg, repl))


def _u_phase_local(V, base_gram, inv_local, *wire, u_off, u_rows,
                   u_scratch, Rs, n_items, lam, alpha, gather_bf16,
                   dtype):
    """Per-device U-step: decode local wire blocks -> solve -> local
    wire-ordered table -> gather-assemble the local factor (scatter-free;
    sentinel rows — cold users + the trash row — come out exactly 0,
    matching the resident sharded path's padded solves)."""
    from ycnr_tpu.models.ooc import _gather_solve

    inv_l = inv_local[0]
    F_g = V.astype(jnp.bfloat16) if gather_bf16 else V
    # zeros are "unvarying" under shard_map's VMA tracking; the scan body
    # makes the carry device-varying, so cast the init accordingly
    Ep = lax.pcast(jnp.zeros((u_rows + u_scratch, V.shape[1]), dtype),
                   (AXIS,), to="varying")
    for gi, R in enumerate(Rs):
        lo, hp, hv, rat, cnt, _eid = (w[0] for w in wire[gi * 6:
                                                         gi * 6 + 6])
        off = jnp.asarray(u_off[gi])

        def body(Ec, blk, R=R):
            blo, bhp, bhv, brat, bcnt, boff = blk
            dec = decode_block_rect if blo.ndim == 2 else decode_block
            oi, rr = dec(blo, bhp, bhv, brat, bcnt, R, n_items, dtype)
            rows = _gather_solve(F_g, oi, rr, bcnt.astype(dtype),
                                 base_gram, lam, alpha, dtype,
                                 gather_bf16)
            return lax.dynamic_update_slice(
                Ec, rows.astype(dtype), (boff, jnp.int32(0))), None

        Ep, _ = lax.scan(body, Ep, (lo, hp, hv, rat, cnt, off))
    sent = jnp.int32(u_rows)
    Ul = jnp.where((inv_l == sent)[:, None], jnp.zeros((), dtype),
                   Ep[inv_l])
    return Ul[None]


def _v_phase_local(U_local, item_deg, base_gram, *wire, Rs, n_items,
                   upd, lam, alpha, gather_bf16, dtype):
    """Per-device V-step: decode local ITEM-view blocks (others = local
    user rows), accumulate partial per-item normal equations, psum over
    NVLink [BASELINE.json:5], one replicated guarded solve."""
    Ul = U_local[0]
    k = Ul.shape[-1]
    F_g = Ul.astype(jnp.bfloat16) if gather_bf16 else Ul
    A0 = lax.pcast(jnp.zeros((n_items + 1, k, k), dtype), (AXIS,),
                   to="varying")
    b0 = lax.pcast(jnp.zeros((n_items + 1, k), dtype), (AXIS,),
                   to="varying")
    carry = (A0, b0)
    for gi, R in enumerate(Rs):
        lo, hp, hv, rat, cnt, eid = (w[0] for w in wire[gi * 6:
                                                        gi * 6 + 6])

        def body(c, blk, R=R):
            A, b = c
            blo, bhp, bhv, brat, bcnt, beid = blk
            dec = decode_block_rect if blo.ndim == 2 else decode_block
            oi, rr = dec(blo, bhp, bhv, brat, bcnt, R, upd, dtype)
            dA, db = bucket_normal_eq(F_g[oi], rr, alpha, dtype,
                                      gather_bf16)
            return (A.at[beid].add(dA), b.at[beid].add(db)), None

        carry, _ = lax.scan(body, carry, (lo, hp, hv, rat, cnt, eid))
    A, b = carry
    A = lax.psum(A, AXIS)  # item-Gram all-reduce over NVLink [BASELINE.json:5]
    b = lax.psum(b, AXIS)
    item_deg = item_deg.astype(dtype)
    if alpha is None:
        reg = lam * item_deg + (item_deg == 0)
    else:
        A = A + base_gram[None]
        reg = jnp.full_like(item_deg, lam)
    return guarded_batched_solve(A, b, reg)


def make_sharded_ooc_epoch(mesh: Mesh, sw: ShardedWire, lam: float,
                           alpha: Optional[float] = None,
                           gather_bf16: bool = False,
                           dtype=jnp.float32, wire_as_args: bool = False):
    """Compile one ALS-WR (alpha=None) or iALS sharded OOC epoch.

    Returns epoch(st: ShardedState) -> ShardedState (donates st). The
    wire is closed over (it is epoch-invariant device data, like the
    resident ShardedData).

    wire_as_args=True: the streamed tier. ``sw`` supplies only geometry
    (host numpy leaves are fine — nothing is placed); the returned
    ``epoch(st, sw_dev)`` takes a device wire from feed_sharded_wire and
    DONATES its buffers, so the shard's wire occupies HBM only for the
    epoch that consumes it and each epoch is re-fed from per-host
    storage (inv_local/item_deg ride along un-donated — they are tiny).

    Multi-process (DCN) jobs must use wire_as_args even for a resident
    wire: JAX forbids closing over arrays that span non-addressable
    devices, so the closed-over default is a single-controller
    convenience only (tests/dcn_worker.py run_ooc)."""
    u_Rs = tuple(g.R for g in sw.ugroups)
    i_Rs = tuple(g.R for g in sw.igroups)
    n_items = int(sw.item_deg.shape[0]) - 1
    upd = int(sw.inv_local.shape[1]) - 1
    uw = tuple(getattr(g, n) for g in sw.ugroups for n in _WIRE)
    iw = tuple(getattr(g, n) for g in sw.igroups for n in _WIRE)
    uspecs = tuple(P(AXIS) for _ in uw)
    ispecs = tuple(P(AXIS) for _ in iw)

    u_phase = jax.shard_map(
        partial(_u_phase_local, u_off=sw.u_off, u_rows=sw.u_rows,
                u_scratch=sw.u_scratch, Rs=u_Rs, n_items=n_items,
                lam=lam, alpha=alpha, gather_bf16=gather_bf16,
                dtype=dtype),
        mesh=mesh, in_specs=(P(), P(), P(AXIS)) + uspecs,
        out_specs=P(AXIS))
    v_phase = jax.shard_map(
        partial(_v_phase_local, Rs=i_Rs, n_items=n_items, upd=upd,
                lam=lam, alpha=alpha, gather_bf16=gather_bf16,
                dtype=dtype),
        mesh=mesh, in_specs=(P(AXIS), P(), P()) + ispecs, out_specs=P())

    def gu_local(Ulocal):
        Ul = Ulocal[0]
        return lax.psum(jnp.einsum("nk,nm->km", Ul, Ul,
                                   preferred_element_type=dtype), AXIS)

    gu_psum = jax.shard_map(gu_local, mesh=mesh, in_specs=P(AXIS),
                            out_specs=P())
    zero_g = jnp.zeros((0, 0), dtype)  # ALS: no base Gram (static branch)

    if wire_as_args:
        def epoch_args(st, inv_local, item_deg, uw_a, iw_a):
            GV = (jnp.einsum("nk,nm->km", st.V, st.V,
                             preferred_element_type=dtype)
                  if alpha is not None else zero_g)
            U = u_phase(st.V, GV, inv_local, *uw_a)
            GU = gu_psum(U) if alpha is not None else zero_g
            V = v_phase(U, item_deg, GU, *iw_a)
            return st._replace(U=U, V=V.astype(dtype))

        jitted = jax.jit(epoch_args, donate_argnums=(0, 3, 4))

        def run(st: ShardedState, sw_dev: ShardedWire) -> ShardedState:
            uw_a = tuple(getattr(g, n) for g in sw_dev.ugroups
                         for n in _WIRE)
            iw_a = tuple(getattr(g, n) for g in sw_dev.igroups
                         for n in _WIRE)
            return jitted(st, sw_dev.inv_local, sw_dev.item_deg,
                          uw_a, iw_a)

        return run

    def epoch(st: ShardedState) -> ShardedState:
        GV = (jnp.einsum("nk,nm->km", st.V, st.V,
                         preferred_element_type=dtype)
              if alpha is not None else zero_g)
        U = u_phase(st.V, GV, sw.inv_local, *uw)
        GU = gu_psum(U) if alpha is not None else zero_g
        V = v_phase(U, sw.item_deg, GU, *iw)
        return st._replace(U=U, V=V.astype(dtype))

    return jax.jit(epoch, donate_argnums=(0,))
