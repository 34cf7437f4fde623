"""Headline benchmark: ALS-WR epoch time at MovieLens-20M scale, rank 64.

Runs on one GPU; outside --smoke it refuses any other backend rather than
measure the CPU. Every epoch is timed to jax.block_until_ready.

Prints exactly one JSON line on stdout:
  {"metric": ..., "value": ..., "unit": ..., "platform": ...,
   "device_kind": ..., "device_count": ...}
Diagnostics go to stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# Host-side artifact cache: generating 20M synthetic ratings and packing two
# layouts is host work that can take longer than the device work measured.
# Cached artifacts are determined by the shape parameters + seed + the
# SOURCE of the generating code (hashed into the key, so editing the
# generator or a layout builder invalidates its entries without a manual
# version bump).
CACHE_VERSION = 1


def _code_hash(*modules) -> str:
    import hashlib

    h = hashlib.sha256()
    for m in modules:
        with open(m.__file__, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:10]


BENCH_CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               ".bench_cache")


def _cache_path(tag: str) -> str:
    # inside the checkout (git-ignored); YCNR_BENCH_CACHE overrides
    d = os.environ.get("YCNR_BENCH_CACHE", BENCH_CACHE_DIR)
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"v{CACHE_VERSION}_{tag}.npz")


def _save_npz(path: str, blob: dict):
    import numpy as np

    tmp = f"{path}.{os.getpid()}.tmp"  # per-pid: concurrent runs must not
    with open(tmp, "wb") as f:         # interleave writes to one scratch file
        np.savez(f, **blob)
    os.replace(tmp, path)


def _load_npz(path: str):
    """Eagerly load every member into a dict, or None on any failure.

    npz member reads are lazy, so corruption can surface at member access
    long after np.load succeeds; reading everything here keeps the
    'corrupt cache -> rebuild' contract honest."""
    import numpy as np

    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    except Exception as e:  # stale/corrupt cache -> rebuild
        log(f"cache load failed for {path} ({e}); rebuilding")
        return None


def _flatten_layout(prefix: str, lay, out: dict):
    """BucketedCSR (tuple of BucketGroup) or BlockedCSR -> npz-able dict."""
    from ycnr_tpu.ops.layout import BlockedCSR

    if not isinstance(lay, BlockedCSR):
        out[f"{prefix}_ngroups"] = len(lay)
        for g, grp in enumerate(lay):
            for name, arr in grp._asdict().items():
                out[f"{prefix}_g{g}_{name}"] = arr
    else:
        out[f"{prefix}_ngroups"] = -1
        for name, arr in lay._asdict().items():
            out[f"{prefix}_{name}"] = arr


def _unflatten_layout(prefix: str, z):
    from ycnr_tpu.ops.bucketed import BucketGroup
    from ycnr_tpu.ops.layout import BlockedCSR

    n = int(z[f"{prefix}_ngroups"])
    if n >= 0:
        return tuple(
            BucketGroup(**{f: z[f"{prefix}_g{g}_{f}"]
                           for f in BucketGroup._fields})
            for g in range(n))
    return BlockedCSR(**{f: z[f"{prefix}_{f}"] for f in BlockedCSR._fields})


def run_bench(n_users: int, n_items: int, n_ratings: int, rank: int,
              epochs: int, chunk_len: int, seed: int = 0,
              topn_users: int = 0, layout: str = "bucketed",
              algo: str = "als", bf16: bool = False, groups: int = 8,
              sgd_method: str = "batched", gather_split: bool = False,
              batch: int | None = None):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ycnr_tpu.data.split import train_test_split
    from ycnr_tpu.data.synthetic import synthetic_ratings
    from ycnr_tpu.models.base import init_state, rmse_padded
    from ycnr_tpu.ops.layout import build_blocked_csr, layout_stats, pad_coo


    import ycnr_tpu.data.split as _split_mod
    import ycnr_tpu.data.synthetic as _synth_mod
    import ycnr_tpu.ops.bucketed as _bucketed_mod
    import ycnr_tpu.ops.layout as _layout_mod

    log(f"devices: {jax.devices()}")
    # two-level cache: the COO blob is shared by every algo/layout over the
    # same shapes+seed; the layout blob is keyed only by what affects it
    data_tag = (f"coo_{n_users}x{n_items}x{n_ratings}_s{seed}"
                f"_{_code_hash(_synth_mod, _split_mod)}")
    dpath = _cache_path(data_tag)
    z = _load_npz(dpath)
    if z is not None:
        t0 = time.time()
        tu, ti, tr = z["tu"], z["ti"], z["tr"]
        su, si, sr = z["su"], z["si"], z["sr"]
        log(f"data cache hit {dpath}: {len(tr) + len(sr):,} ratings "
            f"in {time.time() - t0:.1f}s")
    else:
        t0 = time.time()
        u, i, r = synthetic_ratings(n_users, n_items, n_ratings,
                                    true_rank=16, noise=0.3, seed=seed)
        (tu, ti, tr), (su, si, sr) = train_test_split(u, i, r, 0.05, seed)
        log(f"data gen: {len(r):,} ratings in {time.time() - t0:.1f}s")
        _save_npz(dpath, {"tu": tu, "ti": ti, "tr": tr,
                          "su": su, "si": si, "sr": sr})

    lam = 0.05
    ul_serving = None
    lz = lpath = None
    # the blocked-layout blob doubles as the serving-layout cache (--topn
    # builds the identical BlockedCSR), so name it independent of algo
    blocked_lpath = _cache_path(
        f"lay_{data_tag[4:]}_c{chunk_len}_r{rank}_blocked"
        f"_{_code_hash(_layout_mod)}")
    if algo not in ("sgd", "bpr"):
        if layout == "bucketed":
            lpath = _cache_path(
                f"lay_{data_tag[4:]}_c{chunk_len}_r{rank}_bucketed"
                f"_g{groups}_{_code_hash(_bucketed_mod)}")
        else:
            lpath = blocked_lpath
        lz = _load_npz(lpath)
    if layout == "bucketed" and algo not in ("sgd", "bpr"):
        from ycnr_tpu.models.bucketed_phase import (
            als_epoch_bucketed,
            device_bucketed,
            ials_epoch_bucketed,
        )
        from ycnr_tpu.ops.bucketed import bucketed_stats, build_bucketed

        if lz is not None:
            ul = _unflatten_layout("ul", lz)
            il = _unflatten_layout("il", lz)
        else:
            t0 = time.time()
            ul = build_bucketed(tu, ti, tr, n_users, n_items, chunk_len,
                                rank, max_groups=groups)
            il = build_bucketed(ti, tu, tr, n_items, n_users, chunk_len,
                                rank, max_groups=groups)
            log(f"layouts: {time.time() - t0:.1f}s")
            blob = {}
            _flatten_layout("ul", ul, blob)
            _flatten_layout("il", il, blob)
            _save_npz(lpath, blob)
        log(f"user={bucketed_stats(ul, len(tr))} "
            f"item={bucketed_stats(il, len(tr))}")
        dul = device_bucketed(ul)
        dil = device_bucketed(il)
        if algo == "ials":
            def step(state, ep):
                return ials_epoch_bucketed(state, dul, dil, lam, 40.0,
                                           gather_bf16=bf16,
                                           gather_split=gather_split)
        else:
            def step(state, ep):
                return als_epoch_bucketed(state, dul, dil, lam,
                                          gather_bf16=bf16,
                                          gather_split=gather_split)
    elif algo not in ("sgd", "bpr"):
        from ycnr_tpu.models.als import als_epoch
        from ycnr_tpu.models.base import device_layout
        from ycnr_tpu.models.ials import ials_epoch

        ul = il = None
        if lz is not None:
            ul = _unflatten_layout("ul", lz)
            if "il_ngroups" in lz:  # srv-only blobs hold just the user side
                il = _unflatten_layout("il", lz)
        if ul is None or il is None:
            t0 = time.time()
            if ul is None:
                ul = build_blocked_csr(tu, ti, tr, n_users, n_items,
                                       chunk_len, rank_hint=rank)
            if il is None:
                il = build_blocked_csr(ti, tu, tr, n_items, n_users,
                                       chunk_len, rank_hint=rank)
            log(f"layouts: {time.time() - t0:.1f}s")
            blob = {}
            _flatten_layout("ul", ul, blob)
            _flatten_layout("il", il, blob)
            _save_npz(lpath, blob)
        log(f"user={layout_stats(ul, len(tr))} "
            f"item={layout_stats(il, len(tr))}")
        dul = device_layout(ul)
        dil = device_layout(il)

        if algo == "ials":
            def step(state, ep):
                return ials_epoch(state, dul, dil, lam, 40.0)
        else:
            def step(state, ep):
                return als_epoch(state, dul, dil, lam)
        ul_serving = ul
    elif algo == "sgd" and sgd_method == "stream":
        # scatter-free user-sorted stream epoch (models/sgd_stream.py);
        # the host-side prep (sorts + striping + weights) is cached like
        # the layouts — it is minutes at Netflix scale on this host
        import ycnr_tpu.models.sgd_stream as _stream_mod
        from ycnr_tpu.models.sgd_stream import (
            StreamSGD,
            StreamSGDData,
            prepare_stream_sgd,
        )

        sgd_batch = batch or (4096 if len(tr) < 10**6 else 65536)
        spath = _cache_path(
            f"stream_{data_tag[4:]}_b{sgd_batch}_capped"
            f"_{_code_hash(_stream_mod)}")
        sz = _load_npz(spath)
        if sz is not None:
            sgd_data = StreamSGDData(
                ul=jnp.asarray(sz["ul"]), ib=jnp.asarray(sz["ib"]),
                rb=jnp.asarray(sz["rb"]), wu=jnp.asarray(sz["wu"]),
                wi=jnp.asarray(sz["wi"]), u_lo=jnp.asarray(sz["u_lo"]),
                n_real=int(sz["n_real"]), tile=int(sz["tile"]),
                grad_mode="capped")
            log(f"stream cache hit {spath}")
        else:
            t0 = time.time()
            sgd_data, _ = prepare_stream_sgd(tu, ti, tr, sgd_batch,
                                             n_users, n_items, seed=seed,
                                             grad_mode="capped")
            log(f"stream prep: {time.time() - t0:.1f}s "
                f"({sgd_data.ul.shape[0]} batches of {sgd_batch}, "
                f"tile={sgd_data.tile})")
            _save_npz(spath, {
                "ul": np.asarray(sgd_data.ul), "ib": np.asarray(sgd_data.ib),
                "rb": np.asarray(sgd_data.rb), "wu": np.asarray(sgd_data.wu),
                "wi": np.asarray(sgd_data.wi),
                "u_lo": np.asarray(sgd_data.u_lo),
                "n_real": sgd_data.n_real, "tile": sgd_data.tile})
        trainer = StreamSGD(lam=0.02, lr=0.008, lr_decay=0.95, seed=seed,
                            grad_mode="capped")

        def step(state, ep):
            return trainer.epoch(state, sgd_data, ep)
    elif algo == "bpr":
        # pairwise ranking (models/bpr.py): padded positives + rated-bits
        # table; negatives re-drawn on device per epoch — no layouts
        from ycnr_tpu.models.bpr import BPRTrainer, prepare_bpr_data

        bpr_batch = batch or (4096 if len(tr) < 10**6 else 65536)
        t0 = time.time()
        sgd_data = prepare_bpr_data(tu, ti, bpr_batch, n_users, n_items,
                                    shuffle_rows_seed=0)
        log(f"bpr prep: {time.time() - t0:.1f}s "
            f"({sgd_data.u.shape[0] // bpr_batch} batches of {bpr_batch})")
        trainer = BPRTrainer(lam=0.01, lr=0.05, lr_decay=0.98,
                             batch_size=bpr_batch, seed=seed,
                             grad_mode="emean", shuffle="batches")

        def step(state, ep):
            return trainer.epoch(state, sgd_data, ep)
    else:
        # biased mini-batch SGD over the shuffled rating stream (call stack
        # 3.3 analog); only the padded COO batches are needed — no layouts
        from ycnr_tpu.models.sgd import BiasedSGD, prepare_sgd_data

        sgd_batch = batch or (4096 if len(tr) < 10**6 else 65536)
        trainer = BiasedSGD(lam=0.02, lr=0.008, lr_decay=0.95,
                            batch_size=sgd_batch, seed=seed,
                            grad_mode="mean")
        sgd_data = prepare_sgd_data(tu, ti, tr, sgd_batch, n_users, n_items)
        log(f"sgd: {sgd_data.u.shape[0] // sgd_batch} batches of {sgd_batch}")

        def step(state, ep):
            return trainer.epoch(state, sgd_data, ep)
    state = init_state(n_users, n_items, rank, seed=seed,
                       mu=float(tr.mean()) if algo == "sgd" else 0.0)
    pu, pi, pr, n = pad_coo(su, si, sr, n_users, n_items, 8192)
    dpu, dpi, dpr = jnp.asarray(pu), jnp.asarray(pi), jnp.asarray(pr)

    t0 = time.time()
    state = jax.block_until_ready(step(state, 0))
    # bpr emits ranking logits — RMSE vs ratings is meaningless there
    rmse_note = "" if algo == "bpr" else \
        f" rmse={float(rmse_padded(state, dpu, dpi, dpr, n)):.4f}"
    log(f"epoch 1 (compile+run): {time.time() - t0:.1f}s{rmse_note}")

    times = []
    for ep in range(epochs):
        t0 = time.time()
        state = jax.block_until_ready(step(state, ep + 1))
        times.append(time.time() - t0)
        note = "" if algo == "bpr" else \
            f" rmse={float(rmse_padded(state, dpu, dpi, dpr, n)):.4f}"
        log(f"epoch {ep + 2}: {times[-1]:.3f}s{note}")
    epoch_s = float(np.median(times))

    if topn_users:
        from ycnr_tpu.eval.recommend import _topn_blocks, build_rated_bits
        from ycnr_tpu.models.base import device_layout

        if ul_serving is None:
            sz = _load_npz(blocked_lpath)
            if sz is not None and "ul_ngroups" in sz:
                ul_serving = _unflatten_layout("ul", sz)
            else:
                ul_serving = build_blocked_csr(tu, ti, tr, n_users, n_items,
                                               chunk_len, rank_hint=rank)
                blob = dict(sz) if sz else {}
                _flatten_layout("ul", ul_serving, blob)
                _save_npz(blocked_lpath, blob)
        dlay = device_layout(ul_serving)
        bits = jnp.asarray(build_rated_bits(ul_serving, n_items))
        n_served = int((np.asarray(ul_serving.entity_ids) < n_users).sum())
        jax.block_until_ready(_topn_blocks(state, dlay, 10, bits))  # compile
        t0 = time.time()
        jax.block_until_ready(_topn_blocks(state, dlay, 10, bits))
        dt = time.time() - t0
        log(f"top-10 on device for {n_served:,} users in {dt:.2f}s "
            f"= {n_served / dt:,.0f} recs/s (device compute, exact)")
    return epoch_s


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes on the CPU (checks the code, "
                         "measures nothing)")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--chunk-len", type=int, default=32)
    ap.add_argument("--rank", type=int, default=None,
                    help="factor rank (default: ml20m scale uses the "
                         "preset's — 64 for als/ials/sgd, 32 for bpr; "
                         "netflix scale and --smoke default to 64/16)")
    ap.add_argument("--topn", action="store_true",
                    help="also measure top-10 serving throughput (stderr)")
    ap.add_argument("--layout", choices=["bucketed", "blocked"],
                    default="bucketed")
    ap.add_argument("--scale", choices=["ml20m", "netflix"], default="ml20m",
                    help="netflix = 480k users x 17.8k items, 100M ratings "
                         "(BASELINE config 5 shape, one device)")
    ap.add_argument("--algo", choices=["als", "ials", "sgd", "bpr"],
                    default="als")
    ap.add_argument("--gather-split", action="store_true",
                    help="rank>=128 probe: two half-width gathers + "
                         "block-wise Grams (bitwise-identical math)")
    ap.add_argument("--batch", type=int, default=None,
                    help="SGD/BPR batch size override (default 65536 at "
                         "scale)")
    ap.add_argument("--sgd-method", choices=["batched", "stream"],
                    default="batched",
                    help="SGD epoch structure (stream = scatter-free "
                         "user-sorted, models/sgd_stream.py)")
    ap.add_argument("--bf16", dest="bf16", action="store_true", default=True,
                    help="bfloat16 gathers with f32 accumulation (default; "
                         "RMSE trajectory matches f32 to 1e-4 at ML-20M)")
    ap.add_argument("--f32", dest="bf16", action="store_false",
                    help="force float32 gathers")
    ap.add_argument("--groups", type=int, default=16,
                    help="bucketed-layout group cap (16 = the library "
                         "default)")
    args = ap.parse_args(argv)

    import jax

    from ycnr_tpu.utils.device import describe_device, require_gpu

    if args.smoke:
        jax.config.update("jax_platforms", "cpu")
    else:
        require_gpu("bench.py (use --smoke for a CPU check)")
        from ycnr_tpu.utils.compile_cache import enable_compile_cache

        enable_compile_cache()

    if args.smoke:
        shapes = (500, 300, 20_000)
        rank, epochs, chunk = (args.rank or 16), 2, 8
        metric = f"smoke_{args.algo}_epoch_s"
    elif args.scale == "netflix":
        # Netflix-scale synthetic (BASELINE.json:11 shape) on one chip
        shapes = (480_189, 17_770, 100_480_507)
        rank = args.rank if args.rank is not None else 64
        epochs, chunk = args.epochs, args.chunk_len
        metric = f"netflix_{args.algo}_epoch_s_rank{rank}_1dev"
    else:
        # MovieLens-20M scale: shapes come FROM the ml20m preset, so bench
        # and `train --preset ml20m-als` cannot drift apart
        from ycnr_tpu.config import get_preset

        p = get_preset({"ials": "ml20m-ials", "bpr": "ml20m-bpr"}.get(
            args.algo, "ml20m-als"))
        shapes = (p.data.n_users, p.data.n_items, p.data.n_ratings)
        rank = args.rank if args.rank is not None else {
            "ials": p.ials.rank, "bpr": p.bpr.rank}.get(args.algo,
                                                        p.als.rank)
        epochs, chunk = args.epochs, p.data.chunk_len
        metric = f"ml20m_{args.algo}_epoch_s_rank{rank}_1dev"

    if args.algo == "sgd" and args.sgd_method == "stream":
        metric = metric.replace("sgd", "sgd-stream", 1)
    epoch_s = run_bench(*shapes, rank, epochs, chunk,
                        topn_users=1 if (args.smoke or args.topn) else 0,
                        layout=args.layout, algo=args.algo, bf16=args.bf16,
                        groups=args.groups, sgd_method=args.sgd_method,
                        gather_split=args.gather_split, batch=args.batch)
    dev = describe_device()
    print(json.dumps({"metric": metric, "value": epoch_s, "unit": "s/epoch",
                      "platform": dev["platform"],
                      "device_kind": dev["kind"],
                      "device_count": dev["count"]}), flush=True)


if __name__ == "__main__":
    main()
