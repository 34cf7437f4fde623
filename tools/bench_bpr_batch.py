"""BPR batch-size lever A/B.

Batch size trades per-row cost against sequential steps per epoch. This
tool measures what a larger batch buys on the REAL epoch and what it
costs in quality:
epoch wall time AND the hit@10 trajectory at each batch size, same data,
same seed, emean + batches defaults (the production path).

    python tools/bench_bpr_batch.py --batches 65536 262144 --epochs 6

One JSON line per batch size. Uses bench.py's ML-20M COO cache.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench import log
from tools.bench_ooc import get_coo


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, nargs="+",
                    default=[65536, 262144])
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--rank", type=int, default=32)
    ap.add_argument("--scale", default="ml20m")
    ap.add_argument("--eval-users", type=int, default=2048)
    args = ap.parse_args()

    import jax

    from ycnr_tpu.eval.ranking import hit_rate_at_n
    from ycnr_tpu.models.base import init_state
    from ycnr_tpu.models.bpr import BPRTrainer, prepare_bpr_data

    # test split: get_coo caches train AND test under the same tag
    import bench as _bench
    from bench import _cache_path, _code_hash, _load_npz
    import ycnr_tpu.data.split as _split_mod
    import ycnr_tpu.data.synthetic as _synth_mod

    tu, ti, tr, nu, ni = get_coo(args.scale)
    from tools.bench_ooc import SCALES

    nu0, ni0, nr0 = SCALES[args.scale]
    z = _load_npz(_cache_path(
        f"coo_{nu0}x{ni0}x{nr0}_s0_{_code_hash(_synth_mod, _split_mod)}"))
    su, si = z["su"], z["si"]
    log(f"devices: {jax.devices()}")

    for B in args.batches:
        t0 = time.time()
        data = prepare_bpr_data(tu, ti, B, nu, ni, shuffle_rows_seed=0)
        log(f"B={B}: prep {time.time() - t0:.1f}s "
            f"({data.u.shape[0] // B} batches)")
        trainer = BPRTrainer(lam=0.01, lr=0.05, lr_decay=0.98,
                             batch_size=B, seed=0, grad_mode="emean",
                             shuffle="batches")
        state = init_state(nu, ni, args.rank, seed=0)
        times, hits = [], []
        for ep in range(args.epochs):
            t0 = time.time()
            state = trainer.epoch(state, data, ep)
            jax.block_until_ready(state)
            times.append(time.time() - t0)
            h = hit_rate_at_n(state, tu, ti, su, si, 10,
                              max_users=args.eval_users, seed=0)
            hits.append(round(float(h), 4))
            log(f"B={B} epoch {ep}: {times[-1]:.3f}s hit@10={hits[-1]}")
        steady = float(np.median(times[1:])) if len(times) > 1 else times[0]
        print(json.dumps({"batch": B, "epochs": args.epochs,
                          "first_s": round(times[0], 3),
                          "steady_s": round(steady, 3),
                          "hit10": hits}), flush=True)


if __name__ == "__main__":
    main()
