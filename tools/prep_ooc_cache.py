"""Host-side cache pre-build for tools/bench_ooc.py (CPU-only process).

bench_ooc's data generation + wire packing are pure host work that can
take tens of minutes. Running them in a JAX_PLATFORMS=cpu process keeps
the device free for other measurements; bench_ooc then starts against
warm caches and holds the device only for the epochs it actually times.

The wire build is bench_ooc.build_or_load_wire itself — shared code, so
the cache tags (including the wire-format tag and the b1 portion spool)
can never drift from what bench_ooc will look up.

Usage:
    JAX_PLATFORMS=cpu python tools/prep_ooc_cache.py --scale netflix --compare
    JAX_PLATFORMS=cpu python tools/prep_ooc_cache.py --scale b1 [--wire rect]
"""
import argparse
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench
from bench import _cache_path, _code_hash, _load_npz, _save_npz, log
from tools.bench_ooc import SCALES, build_or_load_wire, get_coo


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", choices=list(SCALES), default="netflix")
    ap.add_argument("--wire", choices=["rect", "packed"], default="packed",
                    help="wire format — must match the bench_ooc run "
                    "this pre-build is for (packed is both defaults)")
    ap.add_argument("--rank", type=int, default=64)
    ap.add_argument("--groups", type=int, default=8)
    ap.add_argument("--target-mb", type=int, default=192)
    ap.add_argument("--storage", choices=["entity", "wire"],
                    default="entity",
                    help="wire = pre-build the wire-order storage (_ws) "
                    "variant (relabeled ids + storage plans)")
    ap.add_argument("--compare", action="store_true",
                    help="also pre-build the resident bucketed layouts")
    args = ap.parse_args()

    from ycnr_tpu.ops.packed import packed_stats

    ug, ig, nnz, _ = build_or_load_wire(args.scale, args.wire,
                                        args.groups, args.target_mb,
                                        rank=args.rank,
                                        storage=args.storage)
    log(f"user wire: {packed_stats(ug, nnz)}")
    log(f"item wire: {packed_stats(ig, nnz)}")

    if args.compare:
        from ycnr_tpu.ops.bucketed import build_bucketed
        import ycnr_tpu.data.split as _split_mod
        import ycnr_tpu.data.synthetic as _synth_mod
        import ycnr_tpu.ops.bucketed as _bucketed_mod

        tu, ti, tr, nu, ni = get_coo(args.scale)
        lp = _cache_path(
            f"lay_{nu}x{ni}x{SCALES[args.scale][2]}_s0"
            f"_{_code_hash(_synth_mod, _split_mod)}"
            f"_c32_r{args.rank}_bucketed_g{args.groups}"
            f"_{_code_hash(_bucketed_mod)}")
        if _load_npz(lp) is None:
            t0 = time.time()
            ul = build_bucketed(tu, ti, tr, nu, ni, 32, args.rank,
                                max_groups=args.groups)
            il = build_bucketed(ti, tu, tr, ni, nu, 32, args.rank,
                                max_groups=args.groups)
            log(f"resident layouts: {time.time() - t0:.0f}s")
            blob = {}
            bench._flatten_layout("ul", ul, blob)
            bench._flatten_layout("il", il, blob)
            _save_npz(lp, blob)
        else:
            log(f"resident layout cache hit {lp}")


if __name__ == "__main__":
    main()
