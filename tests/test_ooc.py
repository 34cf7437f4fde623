"""Out-of-core streamed training: wire-format + epoch parity.

The OOC path (ops/packed.py + models/ooc.py) must be the SAME math as the
resident bucketed path — decoded wire blocks bitwise equal the resident
BucketedCSR blocks, and a streamed epoch bitwise equals a resident epoch
in float64 (they share bucket_solve_rows). SURVEY.md §5 long-context:
this is the device analog of the reference's portioned DB streaming.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ycnr_tpu.data.synthetic import synthetic_ratings
from ycnr_tpu.models.base import init_state
from ycnr_tpu.models.bucketed_phase import (als_epoch_bucketed,
                                            device_bucketed,
                                            ials_epoch_bucketed)
from ycnr_tpu.models.ooc import (als_epoch_ooc, decode_block,
                                 decode_block_rect, ials_epoch_ooc)
from ycnr_tpu.ops.bucketed import build_bucketed
from ycnr_tpu.ops.packed import (build_packed, build_packed_stream,
                                 build_rect, packed_stats,
                                 rating_wire_kind, rect_from_packed)

NU, NI = 700, 300
BUILD = dict(rank_hint=16, target_bytes=1 << 20, max_groups=4)


@pytest.fixture(scope="module")
def coo():
    u, i, r = synthetic_ratings(NU, NI, 30_000, seed=3)[:3]
    return np.asarray(u), np.asarray(i), np.asarray(r)


@pytest.fixture(scope="module")
def layouts(coo):
    u, i, r = coo
    return (build_bucketed(u, i, r, NU, NI, **BUILD),
            build_bucketed(i, u, r, NI, NU, **BUILD),
            build_packed(u, i, r, NU, NI, **BUILD),
            build_packed(i, u, r, NI, NU, **BUILD))


@pytest.fixture(scope="module")
def rect_layouts(layouts):
    return (tuple(rect_from_packed(g) for g in layouts[2]),
            tuple(rect_from_packed(g) for g in layouts[3]))


def test_decode_blocks_bitwise(layouts):
    """Every decoded wire block equals its resident twin exactly."""
    for res, pk in ((layouts[0], layouts[2]), (layouts[1], layouts[3])):
        assert len(res) == len(pk)
        for g_r, g_p in zip(res, pk):
            assert g_r.rows == g_p.R
            assert g_r.other_idx.shape[0] == g_p.n_blocks
            for b in range(g_p.n_blocks):
                oi, rr = decode_block(
                    jnp.asarray(g_p.lo[b]), jnp.asarray(g_p.hi_pos[b]),
                    jnp.asarray(g_p.hi_val[b]), jnp.asarray(g_p.rat[b]),
                    jnp.asarray(g_p.cnt[b]), g_p.R, g_p.n_other,
                    jnp.float32)
                assert np.array_equal(np.asarray(oi), g_r.other_idx[b])
                assert np.array_equal(np.asarray(rr), g_r.rating[b])
                assert np.array_equal(g_p.eid[b], g_r.entity_ids[b])
                assert np.array_equal(g_p.cnt[b].astype(np.float32),
                                      g_r.entity_cnt[b])


def test_decode_rect_blocks_bitwise(layouts, rect_layouts):
    """RECT wire decode (gather-free) equals the resident blocks exactly
    — same contract as the packed decode, different transport."""
    for res, rc in ((layouts[0], rect_layouts[0]),
                    (layouts[1], rect_layouts[1])):
        for g_r, g_p in zip(res, rc):
            assert g_p.lo.ndim == 3 and g_p.lo.shape[2] == g_p.R
            for b in range(g_p.n_blocks):
                oi, rr = decode_block_rect(
                    jnp.asarray(g_p.lo[b]), jnp.asarray(g_p.hi_pos[b]),
                    jnp.asarray(g_p.hi_val[b]), jnp.asarray(g_p.rat[b]),
                    jnp.asarray(g_p.cnt[b]), g_p.R, g_p.n_other,
                    jnp.float32)
                assert np.array_equal(np.asarray(oi), g_r.other_idx[b])
                assert np.array_equal(np.asarray(rr), g_r.rating[b])


def test_rect_hi_overflow_exact():
    """Rect wire reconstructs ids exactly past 2^16-wide catalogs (the
    sparse overflow positions are remapped into the flattened rect)."""
    rng = np.random.default_rng(0)
    n_other = 500_000
    e = np.repeat(np.arange(40), 25)
    o = rng.integers(0, n_other, len(e)).astype(np.int64)
    r = np.full(len(e), 3.0, np.float32)
    res = build_bucketed(e, o, r, 40, n_other, **BUILD)
    rc = build_rect(e, o, r, 40, n_other, **BUILD)
    assert any(g.hi_val.any() for g in rc), "test must exercise overflow"
    for g_r, g_p in zip(res, rc):
        for b in range(g_p.n_blocks):
            oi, _ = decode_block_rect(
                jnp.asarray(g_p.lo[b]), jnp.asarray(g_p.hi_pos[b]),
                jnp.asarray(g_p.hi_val[b]), jnp.asarray(g_p.rat[b]),
                jnp.asarray(g_p.cnt[b]), g_p.R, g_p.n_other, jnp.float32)
            assert np.array_equal(np.asarray(oi), g_r.other_idx[b])


def test_als_epoch_parity_f64_rect(layouts, rect_layouts):
    """Streamed ALS epoch over RECT wire == resident epoch, bitwise f64
    — including the chunked remainder path (cb=2 forces a zero-padded
    pad block through the scan)."""
    ures, ires = layouts[:2]
    urc, irc = rect_layouts
    st = init_state(NU, NI, 16, seed=5, dtype=jnp.float64)
    ref = als_epoch_bucketed(st, device_bucketed(ures, jnp.float64),
                             device_bucketed(ires, jnp.float64), 0.05)
    for cb in (None, 2):
        st = init_state(NU, NI, 16, seed=5, dtype=jnp.float64)
        got = als_epoch_ooc(st, urc, irc, 0.05, chunk_blocks=cb)
        assert np.array_equal(np.asarray(ref.U), np.asarray(got.U))
        assert np.array_equal(np.asarray(ref.V), np.asarray(got.V))


def test_ials_epoch_parity_f64_rect(layouts, rect_layouts):
    ures, ires = layouts[:2]
    urc, irc = rect_layouts
    st = init_state(NU, NI, 16, seed=5, dtype=jnp.float64)
    ref = ials_epoch_bucketed(st, device_bucketed(ures, jnp.float64),
                              device_bucketed(ires, jnp.float64),
                              0.05, 20.0)
    st = init_state(NU, NI, 16, seed=5, dtype=jnp.float64)
    got = ials_epoch_ooc(st, urc, irc, 0.05, 20.0)
    assert np.array_equal(np.asarray(ref.U), np.asarray(got.U))
    assert np.array_equal(np.asarray(ref.V), np.asarray(got.V))


def test_rect_memmap_roundtrip(layouts, tmp_path):
    """rect_from_packed(out_dir=...) memmaps lo/rat to disk; the memmap
    arrays decode identically to the in-RAM expansion."""
    g = layouts[2][0]
    a = rect_from_packed(g)
    b = rect_from_packed(g, out_dir=str(tmp_path), gi=0)
    assert isinstance(b.lo, np.memmap) and isinstance(b.rat, np.memmap)
    for name, x, y in zip(a._fields, a, b):
        if isinstance(x, np.ndarray):
            assert np.array_equal(x, np.asarray(y)), name
        else:
            assert x == y, name


def test_stream_builder_bitwise(coo, layouts, tmp_path):
    """Portioned two-pass builder == in-RAM builder, RAM and memmap."""
    u, i, r = coo

    def portions():
        for s in range(0, len(u), 7_777):
            yield u[s:s + 7_777], i[s:s + 7_777], r[s:s + 7_777]

    for out_dir in (None, str(tmp_path / "wire")):
        pk2 = build_packed_stream(portions(), NU, NI, portions2=portions(),
                                  out_dir=out_dir, **BUILD)
        for g_p, g_q in zip(layouts[2], pk2):
            for name, a, b in zip(g_p._fields, g_p, g_q):
                if isinstance(a, np.ndarray):
                    assert np.array_equal(a, np.asarray(b)), name
                else:
                    assert a == b, name


def test_stream_builder_other_view(coo, layouts):
    """view='other' builds the transposed (item-major) wire layout from
    the same (u, i, r) portions."""
    u, i, r = coo

    def portions():
        yield u, i, r

    pk2 = build_packed_stream(portions(), NI, NU, portions2=portions(),
                              view="other", **BUILD)
    for g_p, g_q in zip(layouts[3], pk2):
        for name, a, b in zip(g_p._fields, g_p, g_q):
            if isinstance(a, np.ndarray):
                assert np.array_equal(a, np.asarray(b)), name


def test_hi_overflow_exact():
    """Catalogs past 2^16 force 16-bit delta overflows; the sparse
    (position, high-bits) stream must reconstruct ids exactly."""
    rng = np.random.default_rng(0)
    n_other = 500_000
    e = np.repeat(np.arange(40), 25)
    o = rng.integers(0, n_other, len(e)).astype(np.int64)
    r = np.full(len(e), 3.0, np.float32)
    res = build_bucketed(e, o, r, 40, n_other, **BUILD)
    pk = build_packed(e, o, r, 40, n_other, **BUILD)
    assert any(g.hi_val.any() for g in pk), "test must exercise overflow"
    for g_r, g_p in zip(res, pk):
        for b in range(g_p.n_blocks):
            oi, rr = decode_block(
                jnp.asarray(g_p.lo[b]), jnp.asarray(g_p.hi_pos[b]),
                jnp.asarray(g_p.hi_val[b]), jnp.asarray(g_p.rat[b]),
                jnp.asarray(g_p.cnt[b]), g_p.R, g_p.n_other, jnp.float32)
            assert np.array_equal(np.asarray(oi), g_r.other_idx[b])


def test_rating_wire_kinds():
    assert rating_wire_kind(np.asarray([0.5, 3.0, 5.0], np.float32)) == \
        "half"
    assert rating_wire_kind(np.asarray([0.3], np.float32)) == "raw"
    assert rating_wire_kind(np.asarray([100.0], np.float32)) == "raw"
    # raw kind round-trips arbitrary float ratings bitwise
    rng = np.random.default_rng(1)
    e = np.repeat(np.arange(20), 10)
    o = np.tile(np.arange(10), 20)
    r = rng.standard_normal(200).astype(np.float32)
    res = build_bucketed(e, o, r, 20, 10, **BUILD)
    pk = build_packed(e, o, r, 20, 10, **BUILD)
    assert pk[0].rating_kind == "raw"
    for g_r, g_p in zip(res, pk):
        for b in range(g_p.n_blocks):
            _, rr = decode_block(
                jnp.asarray(g_p.lo[b]), jnp.asarray(g_p.hi_pos[b]),
                jnp.asarray(g_p.hi_val[b]), jnp.asarray(g_p.rat[b]),
                jnp.asarray(g_p.cnt[b]), g_p.R, g_p.n_other, jnp.float32)
            assert np.array_equal(np.asarray(rr), g_r.rating[b])


def test_als_epoch_parity_f64(layouts):
    """Streamed ALS epoch == resident ALS epoch, bitwise in float64."""
    ures, ires, upk, ipk = layouts
    st = init_state(NU, NI, 16, seed=5, dtype=jnp.float64)
    ref = als_epoch_bucketed(st, device_bucketed(ures, jnp.float64),
                             device_bucketed(ires, jnp.float64), 0.05)
    st = init_state(NU, NI, 16, seed=5, dtype=jnp.float64)
    got = als_epoch_ooc(st, upk, ipk, 0.05)
    assert np.array_equal(np.asarray(ref.U), np.asarray(got.U))
    assert np.array_equal(np.asarray(ref.V), np.asarray(got.V))


def test_als_epoch_parity_row_subchunked(layouts, monkeypatch):
    """The gather-size cap (models/ooc._gather_solve row sub-chunking,
    added after a 1e9-rating run OOMed on the 3.1 GB per-block gather)
    is a memory knob, never a math knob: forcing every block to split
    over ROWS must reproduce the unsplit epoch bitwise in float64 (row
    splits keep each entity's reduction whole)."""
    import ycnr_tpu.models.ooc as ooc

    ures, ires, upk, ipk = layouts
    st = init_state(NU, NI, 16, seed=5, dtype=jnp.float64)
    ref = als_epoch_ooc(st, upk, ipk, 0.05)
    monkeypatch.setattr(ooc, "_GATHER_CHUNK_BYTES", 1)
    # rows only: pin s_r=1 so this stays the bitwise-neutral split
    real_plan = ooc._split_plan
    monkeypatch.setattr(ooc, "_split_plan",
                        lambda NE, R, k, isz: (real_plan(NE, R, k, isz)[0],
                                               1))
    assert all(ooc._row_split(int(g.cnt.shape[1]), int(g.R), 16, 8) > 1
               for g in upk)  # the cap actually engages at this size
    st = init_state(NU, NI, 16, seed=5, dtype=jnp.float64)
    got = als_epoch_ooc(st, upk, ipk, 0.05)
    assert np.array_equal(np.asarray(ref.U), np.asarray(got.U))
    assert np.array_equal(np.asarray(ref.V), np.asarray(got.V))


def test_als_epoch_parity_rating_split_accumulate(layouts, monkeypatch):
    """Mega-entity blocks exhaust NE's divisibility, so _gather_solve
    also split-accumulates the Gram/RHS over R-chunks (SURVEY.md §5's
    blockwise analog). That reassociates each entity's sum — forcing it
    everywhere must agree with the unsplit f64 epoch to reduction-order
    tightness, and the split must actually engage."""
    import ycnr_tpu.models.ooc as ooc

    ures, ires, upk, ipk = layouts
    st = init_state(NU, NI, 16, seed=5, dtype=jnp.float64)
    ref = als_epoch_ooc(st, upk, ipk, 0.05)
    monkeypatch.setattr(ooc, "_GATHER_CHUNK_BYTES", 1)
    assert any(ooc._split_plan(int(g.cnt.shape[1]), int(g.R), 16, 8)[1]
               > 1 for g in upk)
    st = init_state(NU, NI, 16, seed=5, dtype=jnp.float64)
    got = als_epoch_ooc(st, upk, ipk, 0.05)
    np.testing.assert_allclose(np.asarray(got.U), np.asarray(ref.U),
                               rtol=1e-11, atol=1e-12)
    np.testing.assert_allclose(np.asarray(got.V), np.asarray(ref.V),
                               rtol=1e-11, atol=1e-12)
    # the RMSE evaluator shares the split plan — its value must not move
    from ycnr_tpu.models.ooc import rmse_wire

    nnz = int(sum(np.asarray(g.cnt).sum() for g in upk))
    split_rm = rmse_wire(got, upk, nnz, gather_bf16=False)
    monkeypatch.setattr(ooc, "_GATHER_CHUNK_BYTES", 512 * 2**20)
    assert abs(rmse_wire(got, upk, nnz, gather_bf16=False)
               - split_rm) < 1e-9


def test_ials_epoch_parity_f64(layouts):
    ures, ires, upk, ipk = layouts
    st = init_state(NU, NI, 16, seed=5, dtype=jnp.float64)
    ref = ials_epoch_bucketed(st, device_bucketed(ures, jnp.float64),
                              device_bucketed(ires, jnp.float64),
                              0.05, 20.0)
    st = init_state(NU, NI, 16, seed=5, dtype=jnp.float64)
    got = ials_epoch_ooc(st, upk, ipk, 0.05, 20.0)
    assert np.array_equal(np.asarray(ref.U), np.asarray(got.U))
    assert np.array_equal(np.asarray(ref.V), np.asarray(got.V))


def test_chunked_stream_parity_f64(coo, layouts):
    """Chunk granularity is a transport knob, never a math knob: any
    chunk_blocks (including ones forcing a zero-padded remainder chunk)
    must reproduce the resident epoch bitwise in float64. Uses a re-pack
    with a tiny per-block byte target so groups span many blocks (block
    sizing never changes the per-entity solves)."""
    u, i, r = coo
    ures, ires = layouts[:2]
    small = dict(BUILD, target_bytes=1 << 17)
    upk = build_packed(u, i, r, NU, NI, **small)
    ipk = build_packed(i, u, r, NI, NU, **small)
    assert any(g.n_blocks > 2 for g in upk)  # remainder path is reachable
    st = init_state(NU, NI, 16, seed=5, dtype=jnp.float64)
    ref = als_epoch_bucketed(st, device_bucketed(ures, jnp.float64),
                             device_bucketed(ires, jnp.float64), 0.05)
    for cb in (1, 2, 3):
        st = init_state(NU, NI, 16, seed=5, dtype=jnp.float64)
        got = als_epoch_ooc(st, upk, ipk, 0.05, chunk_blocks=cb)
        assert np.array_equal(np.asarray(ref.U), np.asarray(got.U))
        assert np.array_equal(np.asarray(ref.V), np.asarray(got.V))


def test_multi_epoch_rmse_trajectory(coo, layouts):
    """3 OOC epochs in f32 track the resident trajectory and reduce
    RMSE (the end-to-end sanity the train loop relies on)."""
    from ycnr_tpu.models.base import rmse_padded
    from ycnr_tpu.ops.layout import pad_coo

    u, i, r = coo
    ures, ires, upk, ipk = layouts
    test = pad_coo(u[:2000], i[:2000], r[:2000], NU, NI)
    st_r = init_state(NU, NI, 16, seed=5)
    st_o = init_state(NU, NI, 16, seed=5)
    hist_r, hist_o = [], []
    ug, ig = device_bucketed(ures), device_bucketed(ires)
    for _ in range(3):
        st_r = als_epoch_bucketed(st_r, ug, ig, 0.05)
        hist_r.append(float(rmse_padded(st_r, *test)))
        st_o = als_epoch_ooc(st_o, upk, ipk, 0.05)
        hist_o.append(float(rmse_padded(st_o, *test)))
    np.testing.assert_allclose(hist_o, hist_r, rtol=1e-5)
    assert hist_o[-1] < hist_o[0]


def test_hbm_resident_wire_parity_f64(layouts):
    """A wire pinned on device (wire_to_device) must run the SAME epoch
    as the streamed wire, bitwise in f64 — zero host traffic is a
    transport change, never a math change."""
    from ycnr_tpu.models.ooc import group_resident, wire_to_device

    ures, ires, upk, ipk = layouts
    st = init_state(NU, NI, 16, seed=5, dtype=jnp.float64)
    ref = als_epoch_bucketed(st, device_bucketed(ures, jnp.float64),
                             device_bucketed(ires, jnp.float64), 0.05)
    du, di, pinned = wire_to_device(upk, ipk, pin_format="keep")
    assert all(group_resident(g) for g in (*du, *di))
    from ycnr_tpu.models.ooc import wire_nbytes

    assert pinned == wire_nbytes(upk, ipk)
    st = init_state(NU, NI, 16, seed=5, dtype=jnp.float64)
    got = als_epoch_ooc(st, du, di, 0.05)
    assert np.array_equal(np.asarray(ref.U), np.asarray(got.U))
    assert np.array_equal(np.asarray(ref.V), np.asarray(got.V))
    # pin_format="auto" upgrades packed groups to RECT on the way in —
    # a transport/format change only, still bitwise
    da, dia, pinned_a = wire_to_device(upk, ipk)
    assert all(group_resident(g) and g.lo.ndim == 3 for g in (*da, *dia))
    assert pinned_a >= pinned  # rect ships the padding slots
    st = init_state(NU, NI, 16, seed=5, dtype=jnp.float64)
    got = als_epoch_ooc(st, da, dia, 0.05)
    assert np.array_equal(np.asarray(ref.U), np.asarray(got.U))
    assert np.array_equal(np.asarray(ref.V), np.asarray(got.V))


def test_partial_residency_budget_split(layouts):
    """A budget that fits only some groups pins the largest ones, leaves
    the rest on host, and the MIXED epoch still matches bitwise."""
    from ycnr_tpu.models.ooc import group_resident, wire_to_device

    ures, ires, upk, ipk = layouts
    sizes = sorted((sum(getattr(g, n).nbytes for n in
                        ("lo", "hi_pos", "hi_val", "rat", "cnt", "eid"))
                    for g in (*upk, *ipk)), reverse=True)
    budget = sizes[0] + sizes[1] + sizes[2] // 2  # exactly 2 groups fit
    du, di, pinned = wire_to_device(upk, ipk, budget)
    n_res = sum(group_resident(g) for g in (*du, *di))
    assert 0 < n_res < len(du) + len(di)
    assert pinned <= budget
    st = init_state(NU, NI, 16, seed=5, dtype=jnp.float64)
    ref = als_epoch_ooc(st, upk, ipk, 0.05)
    st = init_state(NU, NI, 16, seed=5, dtype=jnp.float64)
    got = als_epoch_ooc(st, du, di, 0.05)
    assert np.array_equal(np.asarray(ref.U), np.asarray(got.U))
    assert np.array_equal(np.asarray(ref.V), np.asarray(got.V))


def test_rmse_wire_matches_padded_coo(coo, layouts):
    """rmse_wire (train RMSE straight off the wire, for beyond-HBM runs
    where no COO copy exists) agrees with the padded-COO evaluator."""
    from ycnr_tpu.models.base import rmse_padded
    from ycnr_tpu.models.ooc import rmse_wire, wire_to_device
    from ycnr_tpu.ops.layout import pad_coo

    u, i, r = coo
    upk, ipk = layouts[2], layouts[3]
    st = init_state(NU, NI, 16, seed=5)
    st = als_epoch_ooc(st, upk, ipk, 0.05)
    want = float(rmse_padded(st, *pad_coo(u, i, r, NU, NI)))
    got = rmse_wire(st, upk, len(r), gather_bf16=False)
    assert abs(got - want) < 1e-5
    # default bf16 prediction: display-grade agreement
    assert abs(rmse_wire(st, upk, len(r)) - want) < 3e-3
    # resident wire: same value
    du, di, _ = wire_to_device(upk, ipk)
    got_dev = rmse_wire(st, du, len(r), gather_bf16=False)
    assert abs(got_dev - want) < 1e-5


def test_train_loop_ooc_residency(coo, tmp_path):
    """The CLI-level train path with ooc_residency='auto' pins the wire
    (tiny dataset -> everything fits), logs the residency event, and
    produces a descending RMSE."""
    import dataclasses

    from ycnr_tpu.config import get_preset
    from ycnr_tpu.train.loop import train

    cfg = get_preset("ml100k-als")
    cfg = cfg.replace(
        ooc=True, ooc_wire="packed", ooc_residency="auto",
        data=dataclasses.replace(cfg.data, source="synthetic"),
        als=dataclasses.replace(cfg.als, epochs=2),
        out_dir=str(tmp_path), log_train_rmse=False)
    res = train(cfg)
    assert res.rmse_history[-1] < res.rmse_history[0]
    import json as _json

    recs = [_json.loads(x) for x in
            open(tmp_path / cfg.name / "metrics.jsonl")]
    ev = [x for x in recs if x.get("event") == "ooc_residency"]
    assert ev and ev[0]["hbm_pinned_bytes"] > 0
    assert ev[0]["streamed_bytes"] == 0


def test_wire_stats(coo, layouts):
    u, _, _ = coo
    stats = packed_stats(layouts[2], len(u))
    assert stats["rating_kind"] == "half"
    # u16 delta + i8 rating + block metadata: must stay under 4 B/rating
    assert stats["wire_bytes_per_rating"] < 4.0
    assert 0 < stats["fill"] <= 1.0
