"""Ingest-path benchmark: MovieLens-format CSV -> raw COO arrays at scale.

The reference's prepare stage streams MovieLens rows through PostgreSQL
(SURVEY.md C7, call stack 3.1); this framework's ingestion boundary is a
flat file through the C++ parser (native/ingest.cc, ycnr_parse_ratings)
with a tolerant Python fallback (data/movielens._parse_python). This
script generates an ML-20M-format ratings.csv and measures:

  * the native parser (rows/s, MB/s),
  * the Python fallback on a bounded slice (its rows/s extrapolate),
  * load_movielens end-to-end (parse + densify id maps) — what `prepare`
    actually runs.

Run:  python tools/bench_ingest.py [--rows 20000000] [--path FILE.csv]
The file is reused if it already exists (generation on this host is
page-fault-bound).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
from ycnr_tpu.data.movielens import _parse_python, load_movielens  # noqa: E402
from ycnr_tpu.native import parse_ratings_native  # noqa: E402

LEVELS = np.arange(1, 11) * 0.5  # ML-20M rating grid 0.5..5.0


def generate(path: str, rows: int, n_users=138_493, n_items=131_262,
             seed=0, chunk=1_000_000):
    rng = np.random.default_rng(seed)
    t0 = time.time()
    with open(path, "w") as f:
        f.write("userId,movieId,rating,timestamp\n")
        for lo in range(0, rows, chunk):
            n = min(chunk, rows - lo)
            u = rng.integers(1, n_users + 1, n)
            i = rng.integers(1, n_items + 1, n)
            r = LEVELS[rng.integers(0, len(LEVELS), n)]
            ts = rng.integers(789_652_009, 1_427_784_002, n)
            f.write("\n".join(
                f"{a},{b},{c:g},{d}" for a, b, c, d in zip(u, i, r, ts)))
            f.write("\n")
    return time.time() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=20_000_000)
    ap.add_argument("--path", default=None)
    ap.add_argument("--py-rows", type=int, default=1_000_000,
                    help="rows for the Python-fallback slice")
    args = ap.parse_args()
    path = args.path or os.path.join(bench.BENCH_CACHE_DIR,
                                     f"ingest_bench_{args.rows}.csv")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    if not os.path.exists(path):
        dt = generate(path, args.rows)
        print(json.dumps({"stage": "generate", "rows": args.rows,
                          "s": round(dt, 1)}), flush=True)
    mb = os.path.getsize(path) / 1e6

    # warm the page cache so the parser numbers measure parsing, not disk
    with open(path, "rb") as f:
        while f.read(1 << 24):
            pass

    # cold = first call in this process (on ballooned-VM hosts this is
    # dominated by first-touch page faults on the fresh output arrays, not
    # parsing); warm = third call (the allocator reuses the freed pages, so
    # this measures the parser itself)
    for label in ("native_parse_cold", "native_parse", "native_parse_warm"):
        t0 = time.time()
        parsed = parse_ratings_native(path, ",")
        dt = time.time() - t0
        assert parsed is not None and len(parsed[0]) == args.rows
        if label != "native_parse":
            print(json.dumps({"stage": label, "rows": args.rows,
                              "mb": round(mb, 1), "s": round(dt, 2),
                              "mrows_per_s": round(args.rows / dt / 1e6, 1),
                              "mb_per_s": round(mb / dt, 0)}), flush=True)
        del parsed

    spath = path + f".head{args.py_rows}"
    if not os.path.exists(spath):
        with open(path) as src, open(spath, "w") as dst:
            for k, line in enumerate(src):
                if k > args.py_rows:  # header + py_rows lines
                    break
                dst.write(line)
    t0 = time.time()
    pu, _, _ = _parse_python(spath, ",")
    dt = time.time() - t0
    assert len(pu) == args.py_rows
    print(json.dumps({"stage": "python_parse", "rows": args.py_rows,
                      "s": round(dt, 2),
                      "mrows_per_s": round(args.py_rows / dt / 1e6, 2)}),
          flush=True)

    t0 = time.time()
    u, i, r, n_users, n_items = load_movielens(path)
    dt = time.time() - t0
    print(json.dumps({"stage": "load_movielens", "rows": int(len(u)),
                      "n_users": n_users, "n_items": n_items,
                      "s": round(dt, 2),
                      "mrows_per_s": round(len(u) / dt / 1e6, 1)}),
          flush=True)


if __name__ == "__main__":
    main()
