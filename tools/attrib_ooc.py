"""OOC epoch-time attribution: where do the seconds go?

Splits a streamed epoch into disjoint, separately-timed passes over the
SAME cached wire (tools/bench_ooc.py builds it):

  puts     device_put every chunk, consume with a trivial jitted sum —
           the true host->device transfer cost in epoch context (the
           single-array probe can overstate the rate: per-put latency
           and memmap paging don't show up there)
  decode   puts + decode_block(_rect) per block, reduced to a scalar —
           adds the wire-format unpack cost
  full     the production epoch (decode + gather + Gram + solve +
           scatter)

Prints one JSON line; run AFTER tools/bench_ooc.py cached the wire:
    python tools/attrib_ooc.py --scale netflix [--wire rect]
"""
import argparse
import json
import os
import sys
import time
from functools import partial

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))
sys.path.insert(0, _HERE)

from bench import log
from bench_ooc import SCALES, load_packed, _packed_dir


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", choices=list(SCALES), default="netflix")
    ap.add_argument("--wire", choices=["rect", "packed"], default="rect")
    ap.add_argument("--groups", type=int, default=8)
    ap.add_argument("--target-mb", type=int, default=192)
    ap.add_argument("--rank", type=int, default=64)
    ap.add_argument("--prefetch", type=int, default=2)
    ap.add_argument("--chunk-blocks", type=int, default=None)
    ap.add_argument("--ram", action="store_true",
                    help="load the wire fully into RAM first (vs memmap)")
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()

    import jax

    from ycnr_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from ycnr_tpu.models.base import init_state
    from ycnr_tpu.models.ooc import (_group_chunks, als_epoch_ooc,
                                     decode_block, decode_block_rect)

    nu, ni, nr = SCALES[args.scale]
    wtag = "" if args.wire == "packed" else "_rect"
    # nnz differs from nr (dedup); find the cache dir by glob
    base = os.path.dirname(_packed_dir("x"))
    import glob
    pat = os.path.join(base, f"packed_{args.scale}_*_g{args.groups}"
                             f"_t{args.target_mb}{wtag}_*_u")
    hits = sorted(glob.glob(pat))
    if args.wire == "packed":
        # the packed glob's trailing wildcard also matches rect dirs
        # (..._t{T}_rect_{hash}_u) — drop them or we'd silently time the
        # RECT wire and label it packed
        hits = [h for h in hits if "_rect_" not in os.path.basename(h)]
    if not hits:
        raise SystemExit(f"no cached wire matches {pat}; run "
                         f"tools/bench_ooc.py first")
    d_u = hits[-1]
    d_i = d_u[:-2] + "_i"
    ug, nnz = load_packed(d_u)
    ig, _ = load_packed(d_i)
    want_ndim = 3 if args.wire == "rect" else 2  # group-level lo shape
    for g in (*ug, *ig):
        assert g.lo.ndim == want_ndim, (
            f"cache {d_u} holds a {'rect' if g.lo.ndim == 3 else 'packed'}"
            f" wire but --wire {args.wire} was requested")
    log(f"wire: {d_u}")
    if args.ram:
        t0 = time.time()
        ug = tuple(g._replace(**{n: np.ascontiguousarray(getattr(g, n))
                                 for n in ("lo", "hi_pos", "hi_val", "rat",
                                           "cnt", "eid")}) for g in ug)
        ig = tuple(g._replace(**{n: np.ascontiguousarray(getattr(g, n))
                                 for n in ("lo", "hi_pos", "hi_val", "rat",
                                           "cnt", "eid")}) for g in ig)
        log(f"RAM copy: {time.time() - t0:.1f}s")

    @jax.jit
    def consume(*arrs):
        return sum(jnp.sum(a.astype(jnp.int32) if a.dtype == jnp.uint16
                           else a.astype(jnp.float32)) for a in arrs)

    def pass_puts():
        acc = None
        for g in (*ug, *ig):
            for _, _, ch in _group_chunks(g, args.chunk_blocks):
                dv = tuple(jax.device_put(a) for a in ch)
                s = consume(*dv)
                acc = s if acc is None else acc + s
        return jax.block_until_ready(acc)

    @partial(jax.jit, static_argnames=("R", "n_other"))
    def decode_chunk(lo, hi_pos, hi_val, rat, cnt, eid, R, n_other):
        from jax import lax

        def body(acc, blk):
            blo, bhp, bhv, brat, bcnt, _ = blk
            dec = decode_block_rect if blo.ndim == 2 else decode_block
            oi, rr = dec(blo, bhp, bhv, brat, bcnt, R, n_other,
                         jnp.float32)
            return acc + jnp.sum(oi) + jnp.sum(rr).astype(jnp.int64), None

        acc, _ = lax.scan(body, jnp.int64(0),
                          (lo, hi_pos, hi_val, rat, cnt, eid))
        return acc

    def pass_decode():
        acc = None
        for g in (*ug, *ig):
            for _, _, ch in _group_chunks(g, args.chunk_blocks):
                dv = tuple(jax.device_put(a) for a in ch)
                s = decode_chunk(*dv, g.R, g.n_other)
                acc = s if acc is None else acc + s
        return jax.block_until_ready(acc)

    def pass_full(state):
        return als_epoch_ooc(state, ug, ig, 0.05, gather_bf16=True,
                             prefetch=args.prefetch,
                             chunk_blocks=args.chunk_blocks)

    res = {"scale": args.scale, "wire": args.wire, "ram": args.ram,
           "groups": args.groups}
    wire_mb = sum(g.lo.nbytes + g.hi_pos.nbytes + g.hi_val.nbytes
                  + g.rat.nbytes + g.cnt.nbytes + g.eid.nbytes
                  for g in (*ug, *ig)) / 2**20
    res["wire_mb"] = round(wire_mb, 1)

    for name, fn in (("puts", pass_puts), ("decode", pass_decode)):
        times = []
        for rep in range(args.reps + 1):
            t0 = time.time()
            fn()
            times.append(time.time() - t0)
            log(f"{name} rep {rep}: {times[-1]:.3f}s")
        res[name + "_s"] = round(min(times[1:]), 3)  # rep 0 compiles

    state = init_state(nu, ni, args.rank, seed=0, dtype=jnp.float32)
    jax.block_until_ready(state.U)
    times = []
    for rep in range(args.reps + 1):
        t0 = time.time()
        state = jax.block_until_ready(pass_full(state))
        times.append(time.time() - t0)
        log(f"full rep {rep}: {times[-1]:.3f}s")
    res["full_s"] = round(min(times[1:]), 3)
    res["puts_MBps"] = round(wire_mb / res["puts_s"], 1)
    res["decode_minus_puts_s"] = round(res["decode_s"] - res["puts_s"], 3)
    res["compute_minus_decode_s"] = round(res["full_s"] - res["decode_s"], 3)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
