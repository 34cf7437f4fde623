"""Out-of-core (host-streamed) ALS-WR / iALS epochs.

The resident paths (models/bucketed_phase.py) keep the whole rating layout
in device memory (~8 bytes/slot x 2 views / ~0.62 fill). This module
removes that bound: the factors stay device-resident, and the rating
blocks stream host->device through every epoch in the packed wire format
of ops/packed.py — in multi-block CHUNKS (one put per wire array per
~48 MB, lax.scan over the chunk on device), double-buffered so the next
chunk's transfer overlaps the current chunk's compute. Trainable nnz is
then limited by host RAM/disk — the device equivalent of the reference's
"stream ratings from PostgreSQL in portions" (SURVEY.md §1 L1->L5, §5
long-context, C7 [B:5]).

Parity: a decoded wire block is bitwise the resident BucketedCSR block
(ops/packed.py), and the per-block solve is the SAME function
(bucketed_phase.bucket_solve_rows), so an OOC epoch equals a resident
epoch exactly in float64 (pinned in tests/test_ooc.py).

Performance model: a streamed epoch moves its wire over the host link
every epoch, so BYTES are the lever where the link binds:

* The packed wire (~6.6 B/rating both views) is the streaming default;
  RECT (~9.75 B/rating) decodes without gathers, for hosts where the
  decode rather than the link binds.
* The real win is not to ship at all: `wire_to_device` pins whole wire
  groups in device memory (2.6-3x smaller than the decoded resident
  layout) and the epoch decodes them on device, block by block — same
  program, zero transfer. Only nnz beyond the pin streams.
* Chunking (multi-block puts) is transport hygiene only.

Neither the link rate nor the decode cost has been measured on the GPU
yet; the defaults were chosen on the accelerator this code was first
written for.

Scatter-free phases: wire blocks hold CONSECUTIVE entities (ops/packed.py
builds eid from the group's degree-sorted entity list), so each block's
solved rows land in a wire-ordered table Ep via
`lax.dynamic_update_slice` (in-place on the donated carry), and the
entity-ordered factor is assembled once per phase by a chunked GATHER
through the inverse permutation (PhasePlan.inv) that recycles the old
factor's donated buffer. The per-program temp footprint stays at the
decode+solve working set.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ycnr_tpu.models.base import MFState
from ycnr_tpu.models.bucketed_phase import (
    bucket_finish_solve,
    bucket_normal_eq,
    bucket_solve_rows,
)
from ycnr_tpu.ops.packed import PackedCSR


def decode_block(lo, hi_pos, hi_val, rat, cnt, R: int, n_other: int,
                 dtype):
    """Wire block -> the resident layout's (oi [NE,R], rr [NE,R]).

    Reconstruction: scatter the sparse high bits into the u16 delta
    stream, unpack packed rows to the padded rectangle (gather by
    row-start + column), then a row-wise cumsum rebuilds absolute ids
    (the first element of each row is stored absolute). Padding columns
    read delta 0 (hold the last id) and are masked to n_other / rating 0
    — the zero-row trick's contract (ops/layout.py).
    """
    delta = lo.astype(jnp.int32).at[hi_pos].add(hi_val * (1 << 16))
    NE = cnt.shape[0]
    starts = jnp.cumsum(cnt) - cnt
    col = lax.broadcasted_iota(jnp.int32, (NE, R), 1)
    valid = col < cnt[:, None]
    src = jnp.where(valid, starts[:, None] + col, 0)
    d2 = jnp.where(valid, delta[src], 0)
    oi = jnp.where(valid, jnp.cumsum(d2, axis=1), n_other)
    rv = rat[src]
    if rat.dtype == jnp.int8:
        rr = rv.astype(dtype) * jnp.asarray(0.5, dtype)
    else:
        rr = rv.astype(dtype)
    rr = jnp.where(valid, rr, 0)
    return oi, rr


def decode_block_rect(lo, hi_pos, hi_val, rat, cnt, R: int, n_other: int,
                      dtype):
    """RECT wire block -> (oi [NE,R], rr [NE,R]) with NO per-slot gathers.

    The rectangle arrives already padded (ops/packed.RectGroup), so the
    decode is: one sparse scatter-add of the 16-bit overflow corrections,
    a row-wise cumsum to rebuild absolute ids, and the padding masks.
    Padding slots carry delta 0 (cumsum holds the row's last id) and are
    masked to n_other / rating 0 — bitwise the packed decode_block and
    the resident layout (tests/test_ooc.py)."""
    NE = cnt.shape[0]
    delta = (lo.astype(jnp.int32).reshape(-1).at[hi_pos]
             .add(hi_val * (1 << 16)).reshape(NE, R))
    col = lax.broadcasted_iota(jnp.int32, (NE, R), 1)
    valid = col < cnt[:, None]
    oi = jnp.where(valid, jnp.cumsum(delta, axis=1), n_other)
    if rat.dtype == jnp.int8:
        rr = rat.astype(dtype) * jnp.asarray(0.5, dtype)
    else:
        rr = rat.astype(dtype)
    rr = jnp.where(valid, rr, 0)
    return oi, rr


# Cap on the per-step gathered-rows tensor (F_g[oi]: [rows, R, k]) — the
# block's dominant temp at 32x the decoded slot bytes (k=64 bf16). Blocks
# whose gather would exceed this solve in row sub-chunks via an inner scan
# instead: at b1 scale the 192 MB decoded-block target means 24M slots =
# a 3.1 GB gather on top of the factors and the pinned wire. NE is a
# multiple of 8 by
# layout alignment, so power-of-two splits divide evenly; each sub-chunk
# keeps >=3M slots of matmul work.
_GATHER_CHUNK_BYTES = 256 * 2**20


def _row_split(NE: int, R: int, k: int, itemsize: int) -> int:
    """Static sub-chunk count for one block's gather+solve (1 = whole)."""
    s = 1
    while (NE % (2 * s) == 0 and s < 64
           and (NE // s) * R * k * itemsize > _GATHER_CHUNK_BYTES):
        s *= 2
    return s


def _split_plan(NE: int, R: int, k: int, itemsize: int):
    """(s_ne, s_r) static sub-chunk counts bounding one block's gathered
    tensor near _GATHER_CHUNK_BYTES.

    Row (NE) splits come first — they keep every per-entity reduction
    whole, so they are bitwise-neutral — but their depth is limited by
    NE's power-of-two divisibility, which skinny-tall mega-entity blocks
    exhaust (the b1 item view has R up to 2.2M with NE=8: s_ne caps at 8
    leaving a 570 MB f32 gather -> measured OOM). The R axis then splits
    too and the Gram/RHS accumulate over R-chunks (bucket_normal_eq) —
    SURVEY.md §5's split-accumulate for mega-entities; this reassociates
    the per-entity sum (f64 agreement ~1e-15, pinned in tests, not
    bitwise)."""
    s_ne = _row_split(NE, R, k, itemsize)
    s_r = 1
    while (R % (2 * s_r) == 0 and s_r < 4096
           and (NE // s_ne) * (R // s_r) * k * itemsize
           > _GATHER_CHUNK_BYTES):
        s_r *= 2
    return s_ne, s_r


def _gather_solve(F_g, oi, rr, cntf, base_gram, lam, alpha, acc_t,
                  gather_bf16):
    """F_g[oi] -> normal equations -> solved rows, sub-chunked over rows
    (and, for mega-entity blocks, split-accumulated over the rating
    axis) when the gathered tensor would exceed _GATHER_CHUNK_BYTES."""
    NE, R = oi.shape
    k = F_g.shape[1]
    s, sr = _split_plan(NE, R, k, F_g.dtype.itemsize)
    if s == 1 and sr == 1:
        return bucket_solve_rows(F_g[oi], rr, cntf, lam, alpha,
                                 base_gram, acc_t, gather_bf16)
    q, qr = NE // s, R // sr

    def sub(_, t):
        soi, srr, scnt = t  # [q, R]
        if sr == 1:
            return None, bucket_solve_rows(F_g[soi], srr, scnt, lam,
                                           alpha, base_gram, acc_t,
                                           gather_bf16)

        def acc_step(carry, tt):
            A, b = carry
            coi, crr = tt  # [q, qr] one R-chunk of every entity
            dA, db = bucket_normal_eq(F_g[coi], crr, alpha, acc_t,
                                      gather_bf16)
            return (A + dA, b + db), None

        (A, b), _ = lax.scan(
            acc_step,
            (jnp.zeros((q, k, k), acc_t), jnp.zeros((q, k), acc_t)),
            (soi.reshape(q, sr, qr).swapaxes(0, 1),
             srr.reshape(q, sr, qr).swapaxes(0, 1)))
        return None, bucket_finish_solve(A, b, scnt, lam, alpha,
                                         base_gram)

    _, rows = lax.scan(sub, None, (oi.reshape(s, q, R),
                                   rr.reshape(s, q, R),
                                   cntf.reshape(s, q)))
    return rows.reshape(NE, k)


@partial(jax.jit,
         static_argnames=("R", "n_other", "lam", "alpha", "gather_bf16"),
         donate_argnums=(0,))
def _ooc_chunk_step(Ep, F_g, lo, hi_pos, hi_val, rat, cnt, off,
                    base_gram, R: int, n_other: int, lam: float,
                    alpha: Optional[float], gather_bf16: bool):
    """Solve a CHUNK of same-shape blocks ([C, ...] leading axis) into the
    wire-ordered table Ep via lax.scan — one program body regardless of C,
    so the compiled program does not grow with the chunk size.

    Chunking exists for the transport, not the math: shipping C blocks
    per put cuts per-put dispatch overhead C-fold and keeps full chunks
    as zero-copy memmap views (measured round 3: steady time is decode-
    bound either way — 12.25 s chunked vs 11.93 s at 6 puts/block on
    Netflix — so this is hygiene, not the lever; see the module
    docstring). The scan body is the block pipeline
    (decode -> gather -> Gram -> guarded solve) ending in a
    dynamic_update_slice at the block's wire-order row offset ``off`` —
    NOT a scatter; see the module docstring on why (the scatter layout
    flip carries two factor-table copies, the round-4 b1 OOM). Ep is
    donated (updated in place); the wire buffers die with their last
    Python reference when the step retires, so the HBM watermark stays
    bounded by factors + Ep + the in-flight chunks + one sub-chunk's
    gathered tensor (_gather_solve caps it at _GATHER_CHUNK_BYTES)."""
    def body(Ep, blk):
        blo, bhp, bhv, brat, bcnt, boff = blk
        # inside the scan the chunk axis is stripped: rect lo is [NE, R]
        # (2-D), packed lo is the [S] stream (1-D)
        dec = decode_block_rect if blo.ndim == 2 else decode_block
        oi, rr = dec(blo, bhp, bhv, brat, bcnt, R, n_other, Ep.dtype)
        rows = _gather_solve(F_g, oi, rr, bcnt.astype(Ep.dtype),
                             base_gram, lam, alpha, Ep.dtype, gather_bf16)
        return lax.dynamic_update_slice(
            Ep, rows.astype(Ep.dtype), (boff, jnp.int32(0))), None

    Ep, _ = lax.scan(body, Ep, (lo, hi_pos, hi_val, rat, cnt, off))
    return Ep


# wire bytes per chunk targeted by the auto chunk size: large enough to
# amortize per-put dispatch overhead to noise against the ~405 MB/s
# stream rate, small enough that prefetch+1 in-flight chunks stay a
# rounding error against HBM (~150 MB in flight at the default
# prefetch=2).
_CHUNK_TARGET_BYTES = 48 * 2**20


def _group_chunks(g, chunk_blocks):
    """Yield (c0, n_real, [C, ...]-leading chunk tuple) of g's wire arrays.

    ``c0`` is the chunk's first block index within the group and
    ``n_real`` how many of its C blocks are real. Full chunks are
    contiguous zero-copy views (memmap-friendly); the final partial chunk
    is padded with zero blocks (cnt=0 rows decode to all-padding; the pad
    eid is an out-of-bounds sentinel and the train path routes pad blocks
    to the Ep scratch region — see phase_packed)."""
    nb = g.n_blocks
    if chunk_blocks is None:
        per_block = max(1, (g.lo.nbytes + g.hi_pos.nbytes +
                            g.hi_val.nbytes + g.rat.nbytes + g.cnt.nbytes +
                            g.eid.nbytes) // nb)
        chunk_blocks = int(_CHUNK_TARGET_BYTES // per_block)
    C = max(1, min(nb, chunk_blocks))
    names = ("lo", "hi_pos", "hi_val", "rat", "cnt", "eid")
    for c0 in range(0, nb - nb % C, C):
        yield c0, C, tuple(getattr(g, n)[c0:c0 + C] for n in names)
    rem = nb % C
    if rem:
        out = []
        for n in names:
            a = np.asarray(getattr(g, n)[nb - rem:])
            pad = np.zeros((C - rem,) + a.shape[1:], a.dtype)
            if n == "eid":
                # one past the factor table's last row in every caller
                # (E has n_entities rows; real eids are < n_entities)
                pad += np.int32(2**31 - 2)
            out.append(np.concatenate([a, pad], axis=0))
        yield nb - rem, rem, tuple(out)


class PhasePlan:
    """Wire-order writeback plan for one view's phase (scatter-free OOC).

    Blocks hold consecutive entities of the group's degree-sorted list
    (ops/packed.py: eid = ents reshaped, padding only at the group tail),
    so block b of group g owns rows [offs[g][b], offs[g][b]+NE) of a
    wire-ordered table Ep with ``rows`` real rows plus ``scratch`` spare
    rows (the dump target for chunk-pad blocks; every row written there
    is a cnt=0 padding solve = exactly 0). ``inv`` maps entity id ->
    wire-order row; entities in no block (cold) and the spare zero row
    map to the sentinel ``rows`` and keep their previous factor values
    through _assemble — bitwise the old scatter semantics."""

    __slots__ = ("offs", "rows", "scratch", "inv")

    def __init__(self, groups, n_entities: int, device: bool = True):
        offs, base = [], 0
        scratch = 1
        inv = np.full(n_entities + 1, 0, np.int32)  # filled below
        pos_of = np.full(n_entities + 1, -1, np.int64)
        for g in groups:
            nb, NE = g.cnt.shape
            offs.append(base + np.arange(nb, dtype=np.int32) * NE)
            eids = np.asarray(g.eid).ravel()
            valid = eids < n_entities
            pos_of[eids[valid]] = base + np.nonzero(valid)[0]
            base += nb * NE
            scratch = max(scratch, NE)
        self.rows = int(base)
        self.scratch = int(scratch)
        inv = np.where(pos_of >= 0, pos_of, base).astype(np.int32)
        if device:
            self.inv = jax.device_put(inv)
            self.offs = tuple(jax.device_put(o) for o in offs)
        else:
            self.inv = inv
            self.offs = tuple(offs)


# rows per assemble-gather chunk: bounds the gather+old+new temp triple
# near 3 x 256 MB at k=64 f32 while keeping the program count at one
# (lax.scan over chunk starts inside a single jit).
_ASSEMBLE_CHUNK_ROWS = 2**20


def _assemble_impl(E, Ep, inv, sent):
    """Entity-ordered factor from the wire-ordered solve table.

    E (donated, recycled in place) supplies the previous values for rows
    whose inv == sent (cold entities + the spare zero row — the old
    scatter semantics: untouched); every other row gathers Ep[inv].
    Chunked dynamic slice/update so the temp working set stays ~3 chunk
    buffers regardless of the table size (10M+ rows at the 1e9 scale)."""
    n1, k = E.shape
    ch = min(n1, _ASSEMBLE_CHUNK_ROWS)
    starts = list(range(0, n1 - ch + 1, ch))
    if n1 % ch and n1 > ch:
        starts.append(n1 - ch)  # overlap tail: overlapped rows recompute

    def body(E, a):
        invc = lax.dynamic_slice_in_dim(inv, a, ch, 0)
        old = lax.dynamic_slice_in_dim(E, a, ch, 0)
        new = jnp.where((invc == sent)[:, None], old, Ep[invc])
        return lax.dynamic_update_slice_in_dim(E, new, a, 0), None

    E, _ = lax.scan(body, E, jnp.asarray(starts, jnp.int32))
    return E


# gather-assemble of the entity-ordered factor; E is donated so the new
# factor recycles the old one's buffer
_assemble = jax.jit(_assemble_impl, donate_argnums=(0,))


@partial(jax.jit, static_argnames=("bf16",))
def _cast_gather(F, bf16: bool):
    return F.astype(jnp.bfloat16) if bf16 else F


def device_memory_limit(device=None) -> int:
    """Bytes the device can allocate: its reported ``bytes_limit``; for
    the CPU backend (tests), host RAM. An accelerator that reports no
    limit is an error — there is no safe size to assume."""
    import os

    dev = device or jax.local_devices()[0]
    limit = (dev.memory_stats() or {}).get("bytes_limit")
    if limit is not None:
        return int(limit)
    if dev.platform == "cpu":
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    raise RuntimeError(
        f"{dev} reports no bytes_limit; pass the device budget explicitly "
        "or use OOC residency 'host' or 'device'")


def bf16_copy_max_bytes(limit_bytes: int) -> int:
    """Largest phase-wide bf16 gather copy of a factor to keep: 1/32 of
    the device's memory. The copy is a SECOND resident factor for the
    whole phase, on top of the pinned wire and the f32 factors; beyond
    the cap the phase gathers in the factor dtype instead. Inherited
    sizing (it was 512 MB of a 16 GB device), not yet measured on the
    GPU."""
    return int(limit_bytes) // 32


def _phase_bf16(F, gather_bf16: bool) -> bool:
    return bool(gather_bf16) and F.nbytes * 2 // F.dtype.itemsize \
        <= bf16_copy_max_bytes(device_memory_limit())


@jax.jit
def _global_gram(F):
    return jnp.einsum("nk,nm->km", F, F, preferred_element_type=F.dtype)


_WIRE_NAMES = ("lo", "hi_pos", "hi_val", "rat", "cnt", "eid")


def wire_nbytes(*group_tuples) -> int:
    """Total wire bytes across any number of PackedCSR/RectCSR tuples."""
    return sum(getattr(g, n).nbytes
               for gs in group_tuples for g in gs for n in _WIRE_NAMES)


def group_resident(g) -> bool:
    """True when g's wire arrays live in device memory (HBM)."""
    return isinstance(g.lo, jax.Array)


def auto_wire_budget(n_users: int, n_items: int, rank: int,
                     hbm_bytes: Optional[int] = None,
                     groups=(), storage: str = "entity",
                     table_rows: Optional[Tuple[int, int]] = None) -> int:
    """Device bytes available for pinning wire groups on one device.

    Starts from the device's memory limit (``device_memory_limit``; an
    accelerator that reports none is an error) and reserves: f32
    factors+biases,
    the phase's bf16 gather copy, the larger view's wire-ordered solve
    table Ep (factor-sized — the scatter-free phase's one standing cost),
    the LARGEST block's in-flight tensors (computed exactly from
    ``groups`` when given: decode temps are ~20 B/decoded slot, the
    gathered factor rows are capped at _GATHER_CHUNK_BYTES by
    _gather_solve's sub-chunking, and the normal-equations chain holds
    ~3 copies of the [q, k, k] accumulator through regularize/symmetrize;
    else a 1.5 GB allowance), the assemble-gather chunk triple, streamed
    chunk buffers, and a 1 GB runtime margin (XLA scratch, donation
    slack).

    ``storage="wire"`` (phase_packed_wire mode) drops the Ep and
    assemble reserves entirely — the wire-order storage phase has
    neither — and sizes the factors from ``table_rows`` (the two
    WireStoragePlan.table_rows values; falls back to n_users/n_items +
    2% block-padding slack when not given)."""
    if hbm_bytes is None:
        hbm_bytes = device_memory_limit()
    k = rank
    copy_cap = bf16_copy_max_bytes(hbm_bytes)
    if storage == "wire":
        if table_rows is None:
            table_rows = (int(n_users * 1.02) + 2, int(n_items * 1.02) + 2)
        n_users, n_items = table_rows
    # a phase's bf16 gather copy only exists while it fits the cap
    # (_phase_bf16); per view, the gathered dtype follows the same rule
    bf16 = {n: (n * k * 2 if n * k * 2 <= copy_cap else 0)
            for n in (n_users, n_items)}
    if groups:
        inflight = 0
        # view 0 (user rows) gathers the item factor and vice versa
        for gr, n_f in zip(groups, (n_items, n_users)):
            isz = 2 if bf16[n_f] else 4
            for g in gr:
                NE, R = int(g.cnt.shape[1]), int(g.R)
                s, sr = _split_plan(NE, R, k, isz)
                inflight = max(
                    inflight,
                    NE * R * 20 + (NE // s) * (R // sr) * k * isz
                    + 3 * (NE // s) * k * k * 4)
    else:
        inflight = 1_500_000_000
    if storage == "wire":
        # no Ep, no assemble: the storage tables ARE the factors. An
        # EVAL gather over the larger table (held-out rmse_padded,
        # serving) may materialize a copy of the whole table; reserve
        # it (inherited sizing, not yet measured on the GPU)
        ep_reserve = max(n_users, n_items) * k * 4
    else:
        # Ep (+ pad slack) TWICE: the wire-ordered solve table plus a
        # copy XLA may make of it at the assemble boundary, whose peak
        # coexists with Ep, the factors and the pinned wire (inherited
        # sizing, not yet measured on the GPU)
        ep_reserve = (2 * (max(n_users, n_items) + 2**20) * k * 4
                      + 3 * _ASSEMBLE_CHUNK_ROWS * k * 4)
    reserve = (
        (n_users + n_items + 2) * (k * 4 + 8)          # f32 factors+biases
        + bf16[n_users] + bf16[n_items]                # phase gather copies
        + ep_reserve
        + inflight
        + 3 * 48 * 2**20                               # streamed chunks
        + 1_000_000_000)
    return max(0, hbm_bytes - reserve)


def _rect_bytes_estimate(g) -> int:
    """Upper bound on g's wire bytes after rect_from_packed (exact for
    lo/rat/cnt/eid; hi uses the packed H, which conversion can only
    shrink — it drops padding entries)."""
    if g.lo.ndim == 3:  # already rect
        return sum(getattr(g, n).nbytes for n in _WIRE_NAMES)
    nb, ne = g.cnt.shape
    slot = 2 + np.dtype(g.rat.dtype).itemsize  # u16 delta + rating
    return (nb * ne * g.R * slot + g.hi_pos.nbytes + g.hi_val.nbytes
            + g.cnt.nbytes + g.eid.nbytes)


def wire_to_device(user_groups, item_groups,
                   budget_bytes: Optional[int] = None,
                   pin_format: str = "auto"):
    """Pin wire groups in HBM so epochs skip the host wire entirely.

    The wire is 2.6-3x smaller than the decoded resident layout
    (~3 B/slot vs 8), so pinning it raises the single-device trainable
    bound ~2.6x while the epoch stays the SAME
    program (the decode runs on device either way). Greedy largest-
    first whole-group placement under ``budget_bytes`` (None = pin
    everything); groups that don't fit keep their host arrays and
    stream as before — phase_packed dispatches per group.

    ``pin_format`` encodes the cost ladder measured on the accelerator
    this code was first written for (rect-pinned ran at resident speed;
    packed-pinned ~3x slower, since the per-slot gather decode costs real
    time once the wire is free; streamed slower still) — not yet
    re-measured on the GPU:

      "auto"  pin as RECT (gather-free decode, 1/fill more bytes) when
              the budget allows, fall back to pinning the group PACKED
              when only that fits, stream otherwise
      "keep"  pin groups in the format they arrived in

    Returns (user_groups, item_groups, resident_bytes)."""
    from ycnr_tpu.ops.packed import rect_from_packed

    tagged = ([("u", i, g) for i, g in enumerate(user_groups)]
              + [("i", i, g) for i, g in enumerate(item_groups)])
    sizes = {(s, i): sum(getattr(g, n).nbytes for n in _WIRE_NAMES)
             for s, i, g in tagged}
    out = {"u": list(user_groups), "i": list(item_groups)}
    spent = 0

    def pin(g):
        return g._replace(
            **{n: jax.device_put(np.ascontiguousarray(getattr(g, n)))
               for n in _WIRE_NAMES})

    for s, i, g in sorted(tagged, key=lambda t: -sizes[(t[0], t[1])]):
        b = sizes[(s, i)]
        if group_resident(g):
            spent += b
            continue
        rb = _rect_bytes_estimate(g) if pin_format == "auto" else None
        if (pin_format == "auto" and g.lo.ndim != 3
                and (budget_bytes is None or spent + rb <= budget_bytes)):
            rg = rect_from_packed(g)
            out[s][i] = pin(rg)
            spent += sum(getattr(rg, n).nbytes for n in _WIRE_NAMES)
            continue
        if budget_bytes is not None and spent + b > budget_bytes:
            continue
        out[s][i] = pin(g)
        spent += b
    return tuple(out["u"]), tuple(out["i"]), spent


def phase_packed(E: jnp.ndarray, F: jnp.ndarray, groups: PackedCSR,
                 lam: float, alpha: Optional[float] = None,
                 base_gram=None, gather_bf16: bool = False,
                 prefetch: int = 2,
                 chunk_blocks: Optional[int] = None,
                 plan: Optional[PhasePlan] = None) -> jnp.ndarray:
    """Re-solve all entity rows of E against F from the wire format.

    Per-group dispatch: a group pinned in HBM (wire_to_device) runs as
    ONE scan over its blocks — zero host traffic; a host-resident group
    streams in chunks with ``prefetch`` puts in flight (jax.device_put
    is async, so chunk c+1 moves while chunk c's program runs).
    ``chunk_blocks`` is the number of same-shape blocks shipped per put
    (default: auto-sized to ~48 MB of wire per chunk — see
    _ooc_chunk_step on why granularity is a transport lever). E is
    consumed (donated into the final assembly); use the returned array.

    Blocks write into a wire-ordered table Ep at their PhasePlan offsets
    (dynamic_update_slice, never scatter — module docstring), and the
    entity-ordered factor is gathered out once at the end. ``plan`` is
    rebuilt from the group eids when None; epoch drivers should build it
    once (device=True) so the inverse permutation is not re-uploaded
    every epoch.

    ``gather_bf16`` is honored only while F's bf16 copy stays under
    bf16_copy_max_bytes; beyond that the phase gathers in the factor
    dtype (slightly slower per row, no second factor-sized buffer).
    """
    if plan is None:
        plan = PhasePlan(groups, E.shape[0] - 1)
    gather_bf16 = _phase_bf16(F, gather_bf16)
    F_g = _cast_gather(F, gather_bf16)
    sent = jnp.int32(plan.rows)
    Ep = jnp.zeros((plan.rows + plan.scratch, E.shape[1]), E.dtype)
    for g, goff in zip(groups, plan.offs):
        if group_resident(g):
            Ep = _ooc_chunk_step(Ep, F_g, g.lo, g.hi_pos, g.hi_val, g.rat,
                                 g.cnt, goff, base_gram, g.R, g.n_other,
                                 lam, alpha, gather_bf16)
            continue
        goff_h = np.asarray(goff)
        q = []
        for c0, n_real, ch in _group_chunks(g, chunk_blocks):
            C = ch[4].shape[0]
            off = np.full(C, plan.rows, np.int32)  # pad -> scratch
            off[:n_real] = goff_h[c0:c0 + n_real]
            dv = tuple(jax.device_put(a) for a in ch[:5])
            q.append(dv + (jax.device_put(off),))
            if len(q) <= prefetch:
                continue
            Ep = _ooc_chunk_step(Ep, F_g, *q.pop(0), base_gram, g.R,
                                 g.n_other, lam, alpha, gather_bf16)
        for ch in q:
            Ep = _ooc_chunk_step(Ep, F_g, *ch, base_gram, g.R, g.n_other,
                                 lam, alpha, gather_bf16)
    return _assemble(E, Ep, plan.inv, sent)


def als_epoch_ooc(state: MFState, user_groups: PackedCSR,
                  item_groups: PackedCSR, lam: float,
                  gather_bf16: bool = False, prefetch: int = 2,
                  chunk_blocks: Optional[int] = None,
                  u_plan: Optional[PhasePlan] = None,
                  i_plan: Optional[PhasePlan] = None) -> MFState:
    """One ALS-WR sweep with both rating views streamed from host.

    Same math as models/bucketed_phase.als_epoch_bucketed (shared block
    body); state is consumed (donated factor buffers). Pass the two
    PhasePlans when running many epochs so the inverse permutations stay
    device-resident."""
    U = phase_packed(state.U, state.V, user_groups, lam,
                     gather_bf16=gather_bf16, prefetch=prefetch,
                     chunk_blocks=chunk_blocks, plan=u_plan)
    V = phase_packed(state.V, U, item_groups, lam,
                     gather_bf16=gather_bf16, prefetch=prefetch,
                     chunk_blocks=chunk_blocks, plan=i_plan)
    return state._replace(U=U, V=V)


class DeviceWirePlan:
    """Device-resident half of a packed.WireStoragePlan: the per-group
    block offsets (uploaded once) plus the scratch/zero geometry the
    phase needs. The host-side ``perm`` stays on host — it is only used
    to map eval COOs / checkpoints, never inside the epoch."""

    __slots__ = ("offs", "rows", "scratch_start", "zero_row")

    def __init__(self, plan):
        self.offs = tuple(jax.device_put(np.asarray(o, np.int32))
                          for o in plan.offs)
        self.rows = int(plan.rows)
        self.scratch_start = int(plan.rows + plan.n_cold)
        self.zero_row = int(plan.zero_row)


def phase_packed_wire(E: jnp.ndarray, F: jnp.ndarray, groups: PackedCSR,
                      lam: float, plan: DeviceWirePlan,
                      alpha: Optional[float] = None, base_gram=None,
                      gather_bf16: bool = False, prefetch: int = 2,
                      chunk_blocks: Optional[int] = None) -> jnp.ndarray:
    """Wire-order storage phase: E IS the wire-ordered factor table.

    Identical block pipeline to phase_packed (the chunk step is the same
    jitted program — decode -> gather -> Gram -> guarded solve -> DUS),
    but blocks write straight into the donated E at their storage
    offsets, so there is NO separate solve table and NO per-phase
    assemble. This removes the assemble's factor-sized tables from the
    footprint; the price was paid at BUILD time (ops/packed.py
    ``other_plan``: the twin view's indices are storage rows, so F here
    is likewise a storage-ordered table and F's zero row is the decode
    sentinel carried in ``g.n_other``).

    Cold entities and the scratch/zero tail are never referenced by any
    block, so their rows persist — same semantics as the classic
    assemble's sentinel path. Chunk-pad blocks dump all-padding solves
    (exact zeros) into the scratch region."""
    gather_bf16 = _phase_bf16(F, gather_bf16)
    F_g = _cast_gather(F, gather_bf16)
    for g, goff in zip(groups, plan.offs):
        if group_resident(g):
            E = _ooc_chunk_step(E, F_g, g.lo, g.hi_pos, g.hi_val, g.rat,
                                g.cnt, goff, base_gram, g.R, g.n_other,
                                lam, alpha, gather_bf16)
            continue
        goff_h = np.asarray(goff)
        q = []
        for c0, n_real, ch in _group_chunks(g, chunk_blocks):
            C = ch[4].shape[0]
            off = np.full(C, plan.scratch_start, np.int32)
            off[:n_real] = goff_h[c0:c0 + n_real]
            dv = tuple(jax.device_put(a) for a in ch[:5])
            q.append(dv + (jax.device_put(off),))
            if len(q) <= prefetch:
                continue
            E = _ooc_chunk_step(E, F_g, *q.pop(0), base_gram, g.R,
                                g.n_other, lam, alpha, gather_bf16)
        for ch in q:
            E = _ooc_chunk_step(E, F_g, *ch, base_gram, g.R, g.n_other,
                                lam, alpha, gather_bf16)
    return E


def als_epoch_wire(U: jnp.ndarray, V: jnp.ndarray, user_groups: PackedCSR,
                   item_groups: PackedCSR, lam: float,
                   u_plan: DeviceWirePlan, i_plan: DeviceWirePlan,
                   gather_bf16: bool = False, prefetch: int = 2,
                   chunk_blocks: Optional[int] = None):
    """One ALS-WR sweep over wire-order storage tables (both donated)."""
    U = phase_packed_wire(U, V, user_groups, lam, u_plan,
                          gather_bf16=gather_bf16, prefetch=prefetch,
                          chunk_blocks=chunk_blocks)
    V = phase_packed_wire(V, U, item_groups, lam, i_plan,
                          gather_bf16=gather_bf16, prefetch=prefetch,
                          chunk_blocks=chunk_blocks)
    return U, V


def ials_epoch_wire(U: jnp.ndarray, V: jnp.ndarray,
                    user_groups: PackedCSR, item_groups: PackedCSR,
                    lam: float, alpha: float, u_plan: DeviceWirePlan,
                    i_plan: DeviceWirePlan, gather_bf16: bool = False,
                    prefetch: int = 2,
                    chunk_blocks: Optional[int] = None):
    """iALS sweep over wire-order storage tables. The global base Grams
    must exclude the non-entity tail rows; wire/cold rows are real
    entities and padding/scratch/zero rows are all-zero (cnt-0 solves
    write exact zeros), so the plain full-table Gram is already exact."""
    GV = _global_gram(V)
    U = phase_packed_wire(U, V, user_groups, lam, u_plan, alpha, GV,
                          gather_bf16=gather_bf16, prefetch=prefetch,
                          chunk_blocks=chunk_blocks)
    GU = _global_gram(U)
    V = phase_packed_wire(V, U, item_groups, lam, i_plan, alpha, GU,
                          gather_bf16=gather_bf16, prefetch=prefetch,
                          chunk_blocks=chunk_blocks)
    return U, V


def wire_storage_init(plan, rank: int, seed: int, entity_offset: int = 0,
                      scale: float = 0.1, dtype=jnp.float32):
    """Storage-ordered init table equal to init_state's rows permuted.

    Row perm[e] gets EXACTLY the value init_state gives entity e (the
    same per-entity RNG draws), so a wire-storage run and a classic run
    from the same seed are comparable row for row (tests pin f64
    agreement). Tail rows (group padding / scratch / zero) start zero.
    ``entity_offset`` skips RNG rows so the item view can share one
    stream with the user view like init_state's single rng does."""
    rng = np.random.default_rng(seed)
    n_entities = len(plan.perm)
    # burn in bounded chunks: Generator.normal draws are stream-
    # sequential, so chunked draws consume the identical bitstream as
    # one (entity_offset, rank) call without materializing a ~5 GB f64
    # throwaway at the 1e9 scale's 10M-user offset
    burn_chunk = 1 << 20
    for a in range(0, entity_offset, burn_chunk):
        rng.normal(0.0, scale, (min(burn_chunk, entity_offset - a), rank))
    vals = rng.normal(0.0, scale, (n_entities, rank))
    tab = np.zeros((plan.table_rows, rank), np.float64)
    tab[plan.perm] = vals
    return jnp.asarray(tab, dtype)


def ials_epoch_ooc(state: MFState, user_groups: PackedCSR,
                   item_groups: PackedCSR, lam: float, alpha: float,
                   gather_bf16: bool = False, prefetch: int = 2,
                   chunk_blocks: Optional[int] = None,
                   u_plan: Optional[PhasePlan] = None,
                   i_plan: Optional[PhasePlan] = None) -> MFState:
    """One iALS sweep, streamed; the global base Grams are computed on
    device per phase (resident factors), exactly as the resident path."""
    GV = _global_gram(state.V)
    U = phase_packed(state.U, state.V, user_groups, lam, alpha, GV,
                     gather_bf16=gather_bf16, prefetch=prefetch,
                     chunk_blocks=chunk_blocks, plan=u_plan)
    GU = _global_gram(U)
    V = phase_packed(state.V, U, item_groups, lam, alpha, GU,
                     gather_bf16=gather_bf16, prefetch=prefetch,
                     chunk_blocks=chunk_blocks, plan=i_plan)
    return state._replace(U=U, V=V)


@partial(jax.jit, static_argnames=("R", "n_other", "gather_bf16"))
def _wire_sq_err_chunk(E, F_g, lo, hi_pos, hi_val, rat, cnt, eid,
                       R: int, n_other: int, gather_bf16: bool = True):
    """Sum of squared prediction errors over a chunk of wire blocks.

    Same decode as the training step; predictions are the row-wise dots
    E[eid] . F[oi] (padding slots gather the zero factor row at n_other
    and carry rating 0, but are masked explicitly so they contribute
    exactly nothing even if E[eid] is nonzero)."""
    def body(acc, blk):
        blo, bhp, bhv, brat, bcnt, beid = blk
        dec = decode_block_rect if blo.ndim == 2 else decode_block
        oi, rr = dec(blo, bhp, bhv, brat, bcnt, R, n_other, jnp.float32)
        # the gathered tensor is the block's biggest buffer — gather in
        # bf16 by default like the train step (accumulate f32), and cap
        # it by the same row sub-chunking as _gather_solve
        gdt = jnp.bfloat16 if gather_bf16 else E.dtype
        NE = bcnt.shape[0]
        s, sr = _split_plan(NE, R, int(F_g.shape[1]),
                            jnp.dtype(gdt).itemsize)
        q, qr = NE // s, R // sr

        def sq_err(soi, srr, scnt, seid, pos0):
            # slot validity is by GLOBAL position within the entity row,
            # so R-chunks carry their offset
            valid = (pos0 + lax.broadcasted_iota(jnp.int32, soi.shape, 1)
                     < scnt[:, None])
            pred = jnp.einsum("urk,uk->ur", F_g[soi].astype(gdt),
                              E[seid].astype(gdt),
                              preferred_element_type=jnp.float32)
            err = jnp.where(valid, srr - pred, 0.0)
            # per-chunk jnp.sum is tree-reduced (accurate in f32); the
            # f64 accumulation across chunks happens on host in rmse_wire
            return jnp.sum(err * err)

        if s == 1 and sr == 1:
            return acc + sq_err(oi, rr, bcnt, beid, 0), None

        def sub(a, t):
            soi, srr, scnt, seid = t  # [q, R]
            if sr == 1:
                return a + sq_err(soi, srr, scnt, seid, 0), None

            def rsub(a2, tt):
                coi, crr, pos0 = tt
                return a2 + sq_err(coi, crr, scnt, seid, pos0), None

            a3, _ = lax.scan(rsub, a,
                             (soi.reshape(q, sr, qr).swapaxes(0, 1),
                              srr.reshape(q, sr, qr).swapaxes(0, 1),
                              jnp.arange(sr, dtype=jnp.int32) * qr))
            return a3, None

        a2, _ = lax.scan(sub, acc, (oi.reshape(s, q, R),
                                    rr.reshape(s, q, R),
                                    bcnt.reshape(s, q),
                                    beid.reshape(s, q)))
        return a2, None

    acc, _ = lax.scan(body, jnp.float32(0),
                      (lo, hi_pos, hi_val, rat, cnt, eid))
    return acc


def rmse_wire(state: MFState, user_groups: PackedCSR, nnz: int,
              chunk_blocks: Optional[int] = None,
              gather_bf16: bool = True) -> float:
    """Train RMSE straight from the wire format (one view covers every
    rating exactly once). Used by the beyond-HBM bench/CLI paths where
    no COO copy of the training set exists on host or device.
    ``gather_bf16=False`` predicts in the factor dtype (exact vs the
    padded-COO evaluator, ~2x the in-flight bytes)."""
    acc = 0.0  # f64 host accumulation of per-chunk f32 tree-sums
    for g in user_groups:
        if group_resident(g):
            acc += float(jax.device_get(_wire_sq_err_chunk(
                state.U, state.V, g.lo, g.hi_pos, g.hi_val, g.rat,
                g.cnt, g.eid, g.R, g.n_other, gather_bf16)))
            continue
        for _, _, ch in _group_chunks(g, chunk_blocks):
            dv = tuple(jax.device_put(a) for a in ch)
            acc += float(jax.device_get(_wire_sq_err_chunk(
                state.U, state.V, *dv, g.R, g.n_other, gather_bf16)))
    return (acc / max(nnz, 1)) ** 0.5


def device_hbm_stats() -> dict:
    """Best-effort device-memory usage snapshot (bytes) of this process's
    first local device. Used by the OOC bench to document the bounded-
    watermark claim; CPU test devices report {}."""
    try:
        stats = jax.local_devices()[0].memory_stats() or {}
    except Exception:
        return {}
    keep = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")
    return {k: int(v) for k, v in stats.items() if k in keep}
