"""Host-side cache pre-build for bench.py (CPU-only process).

Same motivation as tools/prep_ooc_cache.py: bench.py's synthetic-data
generation + layout packing are minutes of pure host work. Building the
COO and bucketed-layout blobs here (identical cache tags) lets a later
bench.py run start straight into device work.

    JAX_PLATFORMS=cpu python tools/prep_bench_cache.py --scale ml20m --rank 64 --rank 128
"""
import argparse
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench import (_cache_path, _code_hash, _flatten_layout, _load_npz,
                   _save_npz, log)

# shapes mirror bench.py main(): ml20m comes from the preset, netflix is
# the BASELINE config-5 constant
def _scale_shapes(scale: str):
    if scale == "netflix":
        return (480_189, 17_770, 100_480_507)
    from ycnr_tpu.config import get_preset

    p = get_preset("ml20m-als")
    return (p.data.n_users, p.data.n_items, p.data.n_ratings)


SCALE_SHAPES = {"ml20m": None, "netflix": None}  # names only (argparse)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", choices=list(SCALE_SHAPES), default="ml20m")
    ap.add_argument("--rank", type=int, action="append", default=None,
                    help="layout rank hints to build (repeatable)")
    ap.add_argument("--chunk-len", type=int, default=32)
    ap.add_argument("--groups", type=int, action="append", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    ranks = args.rank or [64]
    groups_list = args.groups or [8]

    import ycnr_tpu.data.split as _split_mod
    import ycnr_tpu.data.synthetic as _synth_mod
    import ycnr_tpu.ops.bucketed as _bucketed_mod
    from ycnr_tpu.data.split import train_test_split
    from ycnr_tpu.data.synthetic import synthetic_ratings
    from ycnr_tpu.ops.bucketed import build_bucketed

    n_users, n_items, n_ratings = _scale_shapes(args.scale)
    data_tag = (f"coo_{n_users}x{n_items}x{n_ratings}_s{args.seed}"
                f"_{_code_hash(_synth_mod, _split_mod)}")
    dpath = _cache_path(data_tag)
    z = _load_npz(dpath)
    if z is not None:
        tu, ti, tr = z["tu"], z["ti"], z["tr"]
        log(f"data cache hit {dpath}")
    else:
        t0 = time.time()
        u, i, r = synthetic_ratings(n_users, n_items, n_ratings,
                                    true_rank=16, noise=0.3, seed=args.seed)
        (tu, ti, tr), (su, si, sr) = train_test_split(u, i, r, 0.05,
                                                      args.seed)
        log(f"data gen: {len(r):,} ratings in {time.time() - t0:.0f}s")
        _save_npz(dpath, {"tu": tu, "ti": ti, "tr": tr,
                          "su": su, "si": si, "sr": sr})

    for rank in ranks:
        for groups in groups_list:
            lpath = _cache_path(
                f"lay_{data_tag[4:]}_c{args.chunk_len}_r{rank}_bucketed"
                f"_g{groups}_{_code_hash(_bucketed_mod)}")
            if _load_npz(lpath) is not None:
                log(f"layout cache hit {lpath}")
                continue
            t0 = time.time()
            ul = build_bucketed(tu, ti, tr, n_users, n_items,
                                args.chunk_len, rank, max_groups=groups)
            il = build_bucketed(ti, tu, tr, n_items, n_users,
                                args.chunk_len, rank, max_groups=groups)
            blob = {}
            _flatten_layout("ul", ul, blob)
            _flatten_layout("il", il, blob)
            _save_npz(lpath, blob)
            log(f"layouts r{rank} g{groups}: {time.time() - t0:.0f}s")


if __name__ == "__main__":
    main()
