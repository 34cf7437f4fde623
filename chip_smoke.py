#!/usr/bin/env python3
"""On-card smoke run: the recommender's main path on one H100.

    python chip_smoke.py              # phases 1-5 on one card
    python chip_smoke.py --cards 4    # phase 1, then only phase 6

Phases, in order; any failure exits non-zero before the result line:

1. device  JAX must be on the GPU. Prints the devices and, on a line of its
           own, nvidia-smi's name and power limit for the card.
2. kernel  The batched SPD solve (CUDA kernel up to its rank 64, and
           lax.linalg) on B = 138,493 ALS-shaped systems at k = 10, 64, 128,
           checked against float64 NumPy on a 4,096-system sample and timed.
3. main    prepare -> train -> validate -> recommend --all -> serve through
           ``ycnr_tpu.cli.main`` in this process, at the full ML-20M width of
           the ``ml20m-als`` preset (138,493 users x 26,744 items x
           20,000,263 synthetic ratings from --seed, rank 64), 3 epochs.
4. ref     The same 3 epochs under matmul precision "highest" with the XLA
           solve; per-epoch held-out RMSE must agree with phase 3.
5. ooc     One out-of-core epoch (``train --ooc --ooc-residency host``).
6. cards   (--cards 4 only) ``dryrun_multichip(4)``, then ``netflix-sharded``
           ALS at Netflix scale on 4 cards against the same run on 1 card.

Everything runs in one JAX process, so only one process ever holds a card.
The last line of stdout is {"ok": true, "device": {...}}, printed only when
every phase passed.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

ML20M = dict(users=138_493, items=26_744, ratings=20_000_263)
NETFLIX = dict(users=480_189, items=17_770, ratings=100_480_507)
RANKS = (10, 64, 128)
TOPN_CHECK_USERS = 1000

# Tolerances, each with its reason.
# Phase 4: the default run and the reference differ only in rounding — the
# CUDA kernel's LDL^T against XLA's Cholesky (1e-6 relative on the solves),
# and f32 matmuls that name no precision (TF32 on the card) against
# "highest". Both feed an RMSE over ~2M held-out ratings, which averages
# such errors down; a wrong solve moves RMSE by 1e-1. 1e-3 relative keeps
# a 100x margin on each side.
REF_RMSE_RTOL = 1e-3
# Phase 3 top-10: scores are float32 dot products of rank-64 factors at
# HIGHEST precision, |score| ~ 5, so each carries ~64 * 6e-8 * 5 = 2e-5 of
# rounding; two items whose float64 scores differ by less than 1e-4 may
# legitimately trade places.
TOPN_SCORE_TOL = 1e-4
# Phase 6: the 4-card run (user-sharded blocked layout, item-Gram psum)
# and the 1-card run (bucketed layout) sum the same normal equations in a
# different order (f32, bf16 gathers), and ALS amplifies nothing: per-epoch
# RMSE agrees to rounding, 1e-4 relative. Final factors are compared by
# relative Frobenius norm: 2e-3 is ten times the 1.5e-4 that 4 CPU devices
# show at 1/100 scale, where the bf16 gathers round the same way.
CARDS_RMSE_RTOL = 1e-4
CARDS_FACTOR_RTOL = 2e-3


def log(*a):
    print(*a, flush=True)


def phase(name):
    """Decorator: print the phase's start, end and wall time."""
    def wrap(fn):
        def run(*a, **kw):
            log(f"[phase {name}] start")
            t0 = time.time()
            out = fn(*a, **kw)
            log(f"[phase {name}] ok in {time.time() - t0:.1f}s")
            return out
        return run
    return wrap


class _EchoLines(io.TextIOBase):
    """stdout stand-in that keeps every line a command prints and echoes
    each one, prefixed, as soon as it is complete — so a command cut by a
    time limit still shows how far it got."""

    def __init__(self, echo):
        self.lines, self._part, self._echo = [], "", echo

    def write(self, s):
        *done, self._part = (self._part + s).split("\n")
        for ln in done:
            self.lines.append(ln)
            print(f"  | {ln[:300]}", file=self._echo, flush=True)
        return len(s)


def cli(argv, stdin_text=None):
    """Run ``ycnr_tpu.cli.main(argv)`` in this process; returns its stdout
    lines (echoed here, prefixed, as they come)."""
    from ycnr_tpu.cli import main

    out = _EchoLines(sys.stdout)
    old_stdin = sys.stdin
    if stdin_text is not None:
        sys.stdin = io.StringIO(stdin_text)
    try:
        with contextlib.redirect_stdout(out):
            main(argv)
    finally:
        sys.stdin = old_stdin
    if out._part:
        out.write("\n")
    return out.lines


def metrics_of(out_dir, name):
    with open(os.path.join(out_dir, name, "metrics.jsonl")) as f:
        return [json.loads(x) for x in f]


def epochs_of(records):
    return [r for r in records if "epoch" in r and "rmse_test" in r]


@phase("device")
def phase_device(cards: int):
    import jax

    from ycnr_tpu.utils.device import (describe_device,
                                       gpu_name_and_power_limit,
                                       require_gpu)

    require_gpu("chip_smoke.py")
    dev = describe_device()
    if dev["count"] < cards:
        raise SystemExit(f"--cards {cards} needs {cards} GPUs; JAX sees "
                         f"{dev['count']}")
    log(f"devices: {jax.devices()}")
    log(f"device_kind: {dev['kind']}  count: {dev['count']}")
    log(gpu_name_and_power_limit())
    from ycnr_tpu.utils.compile_cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    return dev


@phase("kernel")
def phase_kernel():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from bench_solve import bench_kernel

    from ycnr_tpu.ops.cuda_solve import MAX_RANK, build_library

    t0 = time.time()
    log(f"kernel library {build_library()} ({time.time() - t0:.1f}s)")
    log("tolerance: per system, |x - x64|_inf / |x64|_inf <= 4 k eps_f32 "
        "cond(A) (the forward-error bound of a backward-stable solve); "
        "identity-guard systems must solve to exactly 0")
    rows = bench_kernel(RANKS, reps=10)
    for k, r in rows.items():
        cuda = (f"cuda {r['cuda_ms']:.3f} ms" if k <= MAX_RANK else
                f"no cuda kernel above rank {MAX_RANK}")
        log(f"solve k={k} B={r['B']}: {cuda}, lax.linalg {r['xla_ms']:.3f} "
            f"ms (median of 10, block_until_ready); auto takes "
            f"{'cuda' if k <= MAX_RANK else 'xla'}")


def _train_args(store, out, seed, epochs, *extra):
    return ["train", "--preset", "ml20m-als", "--store", store, "--epochs",
            str(epochs), "--out", out, "--seed", str(seed), *extra]


@phase("main")
def phase_main(work: str, seed: int) -> dict:
    import numpy as np

    store = os.path.join(work, "store")
    out = os.path.join(work, "runs")
    cli(["prepare", "--source", "synthetic", "--store", store,
         "--users", str(ML20M["users"]), "--items", str(ML20M["items"]),
         "--ratings", str(ML20M["ratings"]), "--seed", str(seed),
         "--portion", "5000000"])

    t0 = time.time()
    cli(_train_args(store, out, seed, 3))
    train_wall = time.time() - t0
    recs = metrics_of(out, "ml20m-als")
    eps = epochs_of(recs)
    rmse = [r["rmse_test"] for r in eps]
    if len(rmse) != 3 or not np.all(np.isfinite(rmse)):
        raise AssertionError(f"train: expected 3 finite RMSEs, got {rmse}")
    if not all(b < a for a, b in zip(rmse, rmse[1:])):
        raise AssertionError(f"held-out RMSE does not descend: {rmse}")
    warm = [r for r in recs if r.get("event") == "warm_program_done"]
    log(f"train: held-out RMSE per epoch {rmse}")
    log(f"train: epoch seconds {[r['epoch_s'] for r in eps]} (first "
        f"includes any compile the background warm did not finish); "
        f"background compile {warm[0]['wall_s'] if warm else 'n/a'} s; "
        f"steady s/epoch {statistics.median(r['epoch_s'] for r in eps[1:])}; "
        f"train command wall {train_wall:.1f} s")
    ckpt = os.path.join(out, "ml20m-als", "ckpt")

    val = json.loads(cli(["validate", "--ckpt", ckpt, "--store", store,
                          "--seed", str(seed)])[-1])
    if abs(val["rmse_test"] - rmse[-1]) > 1e-4 * rmse[-1]:
        raise AssertionError(f"validate RMSE {val['rmse_test']} != train's "
                             f"final {rmse[-1]}")

    recs_path = os.path.join(work, "recs.jsonl")
    t0 = time.time()
    cli(["recommend", "--ckpt", ckpt, "--store", store, "--all", "--save",
         recs_path, "-n", "10"])
    log(f"recommend --all: command wall {time.time() - t0:.1f} s")
    check_recommend_all(store, ckpt, recs_path, seed)
    log(f"exact scorer: {scorer_recs_per_s(store, ckpt)}")

    reqs = "0\n17\ncold:1:5.0,2:4.5,3:3.0\nstats\n"
    lines = cli(["serve", "--ckpt", ckpt, "--store", store], reqs)
    got = [json.loads(x) for x in lines]
    if got[0].get("event") != "ready" or len(got) != 5:
        raise AssertionError(f"serve answered {len(got) - 1} of 4 requests")
    for g in got[1:4]:
        if len(g.get("items", [])) != 10:
            raise AssertionError(f"serve: bad top-10 answer {g}")
    if got[4].get("event") != "stats":
        raise AssertionError(f"serve: bad stats answer {got[4]}")
    return {"store": store, "rmse": rmse}


def check_recommend_all(store, ckpt, recs_path, seed):
    """No rated item in any list; 1,000 users' lists against float64."""
    import numpy as np

    from ycnr_tpu.data.store import RatingsStore
    from ycnr_tpu.models.base import unpad
    from ycnr_tpu.train.checkpoint import load_checkpoint

    u, i, _ = RatingsStore(store).read_all()
    state, _ = load_checkpoint(ckpt)
    n_items = state.n_items
    # the store's (user, item) pairs are distinct, so a sort gives the
    # sorted key set (np.unique's hash table is far slower at 2e7 keys)
    rated = np.sort(u.astype(np.int64) * n_items + i)
    n_rated_users = int(np.count_nonzero(np.bincount(u)))
    users, lists = [], []
    with open(recs_path) as f:
        for line in f:
            d = json.loads(line)
            users.append(d["user"])
            lists.append(d["items"])
    if len(users) != n_rated_users:
        raise AssertionError(f"recommend --all served {len(users)} users, "
                             f"store has {n_rated_users}")
    if any(len(x) != 10 for x in lists):
        raise AssertionError("recommend --all: a list is not 10 long")
    users = np.asarray(users, np.int64)
    items = np.asarray(lists, np.int64)
    keys = (users[:, None] * n_items + items).reshape(-1)
    if np.isin(keys, rated).any():
        raise AssertionError("recommend --all returned a rated item")
    U, V, bu, bi, mu = (np.asarray(x, np.float64) for x in unpad(state))
    sel = np.random.default_rng(seed).choice(len(users), TOPN_CHECK_USERS,
                                             replace=False)
    worst = 0.0
    for j in sel:
        uid = users[j]
        s = float(mu) + bu[uid] + bi + V @ U[uid]
        r0, r1 = np.searchsorted(rated, [uid * n_items,
                                         (uid + 1) * n_items])
        s[rated[r0:r1] - uid * n_items] = -np.inf
        ref = np.sort(s)[::-1][:10]
        got = s[items[j]]
        worst = max(worst, float(np.abs(got - ref).max()))
    if worst > TOPN_SCORE_TOL:
        raise AssertionError(f"top-10 differs from float64 by {worst:.3g} "
                             f"> {TOPN_SCORE_TOL} in score")
    log(f"recommend --all: {len(users)} users, no rated item returned; "
        f"{TOPN_CHECK_USERS} users match float64 top-10 (max score gap "
        f"{worst:.3g}, tolerance {TOPN_SCORE_TOL})")


def scorer_recs_per_s(store, ckpt) -> str:
    """Device time of the exact scorer over every rated user (after a
    warm-up call; ends at block_until_ready)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ycnr_tpu.data.store import RatingsStore
    from ycnr_tpu.eval.recommend import _topn_blocks, build_rated_bits
    from ycnr_tpu.models.base import device_layout
    from ycnr_tpu.ops.layout import build_blocked_csr
    from ycnr_tpu.train.checkpoint import load_checkpoint

    u, i, r = RatingsStore(store).read_all()
    state, _ = load_checkpoint(ckpt)
    lay = build_blocked_csr(u, i, r, state.n_users, state.n_items,
                            rank_hint=state.rank)
    bits = jnp.asarray(build_rated_bits(lay, state.n_items))
    dlay = device_layout(lay)
    n_served = int((np.asarray(lay.entity_ids) < state.n_users).sum())
    jax.block_until_ready(_topn_blocks(state, dlay, 10, bits))
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(_topn_blocks(state, dlay, 10, bits))
        ts.append(time.perf_counter() - t0)
    dt = statistics.median(ts)
    return (f"top-10 for {n_served:,} users in {dt * 1e3:.1f} ms = "
            f"{n_served / dt:,.0f} recs/s (median of 5, f32 HIGHEST)")


@phase("ref")
def phase_ref(work: str, seed: int, rmse_main):
    import jax

    from ycnr_tpu.ops.gram import solve_override

    out = os.path.join(work, "runs_ref")
    prev = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    try:
        with solve_override("xla"):
            cli(_train_args(os.path.join(work, "store"), out, seed, 3))
    finally:
        jax.config.update("jax_default_matmul_precision", prev)
    ref = [r["rmse_test"] for r in epochs_of(metrics_of(out, "ml20m-als"))]
    for e, (a, b) in enumerate(zip(rmse_main, ref)):
        if abs(a - b) > REF_RMSE_RTOL * b:
            raise AssertionError(f"epoch {e + 1}: RMSE {a} vs reference "
                                 f"{b} (rtol {REF_RMSE_RTOL})")
    log(f"reference (highest precision, XLA solve) RMSE {ref} vs {rmse_main}"
        f": agree within rtol {REF_RMSE_RTOL}")
    log("precision on the main path: Gram/RHS einsums (ops/gram.py "
        "chunk_gram_rhs, models/bucketed_phase.py bucket_normal_eq) take "
        "bf16 gathered rows (the preset's gather dtype) with f32 "
        "accumulation, so TF32 never applies; the solve is f32 (CUDA kernel "
        "for k <= 64); held-out RMSE and the top-N scorer are f32 at "
        "HIGHEST precision")


@phase("ooc")
def phase_ooc(work: str, seed: int):
    import numpy as np

    out = os.path.join(work, "runs_ooc")
    cli(_train_args(os.path.join(work, "store"), out, seed, 1, "--ooc",
                    "--ooc-residency", "host"))
    eps = epochs_of(metrics_of(out, "ml20m-als"))
    if len(eps) != 1 or not np.isfinite(eps[0]["rmse_test"]):
        raise AssertionError(f"OOC epoch did not finish: {eps}")
    log(f"ooc epoch: RMSE {eps[0]['rmse_test']}, {eps[0]['epoch_s']} s")


@phase("cards")
def phase_cards(work: str, seed: int, cards: int):
    import numpy as np

    import __graft_entry__
    from ycnr_tpu.models.base import unpad
    from ycnr_tpu.train.checkpoint import load_checkpoint

    t0 = time.time()
    __graft_entry__.dryrun_multichip(cards)
    log(f"dryrun_multichip({cards}) ok in {time.time() - t0:.1f}s")
    store = os.path.join(work, "store_netflix")
    t0 = time.time()
    cli(["prepare", "--source", "synthetic", "--store", store,
         "--users", str(NETFLIX["users"]), "--items", str(NETFLIX["items"]),
         "--ratings", str(NETFLIX["ratings"]), "--seed", str(seed),
         "--portion", "10000000"])
    log(f"prepare: {NETFLIX['ratings']:,} ratings, wall {time.time() - t0:.1f}s")
    runs = {}
    for shards in (cards, 1):
        out = os.path.join(work, f"runs_{shards}")
        t0 = time.time()
        cli(["train", "--preset", "netflix-sharded", "--store", store,
             "--shards", str(shards), "--epochs", "2", "--out", out,
             "--seed", str(seed)])
        eps = epochs_of(metrics_of(out, "netflix-sharded"))
        state, _ = load_checkpoint(os.path.join(out, "netflix-sharded",
                                                "ckpt"))
        runs[shards] = ([r["rmse_test"] for r in eps],
                        [np.asarray(x, np.float64) for x in unpad(state)])
        log(f"--shards {shards}: RMSE {runs[shards][0]}, epoch s "
            f"{[r['epoch_s'] for r in eps]}, wall {time.time() - t0:.1f}s")
    (r4, f4), (r1, f1) = runs[cards], runs[1]
    if len(r4) != 2 or len(r1) != 2:
        raise AssertionError(f"expected 2 epochs each: {r4} {r1}")
    for e, (a, b) in enumerate(zip(r4, r1)):
        if abs(a - b) > CARDS_RMSE_RTOL * b:
            raise AssertionError(f"epoch {e + 1}: --shards {cards} RMSE {a} "
                                 f"vs --shards 1 {b}")
    for name, a, b in zip(("U", "V"), f4, f1):
        rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        log(f"final {name}: relative Frobenius difference {rel:.3g}")
        if rel > CARDS_FACTOR_RTOL:
            raise AssertionError(f"final {name} differs by {rel:.3g} > "
                                 f"{CARDS_FACTOR_RTOL}")
    log(f"--shards {cards} matches --shards 1 (RMSE rtol {CARDS_RMSE_RTOL}, "
        f"factor rtol {CARDS_FACTOR_RTOL})")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4 runs only the four-card phase")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = phase_device(args.cards)
    work = tempfile.mkdtemp(prefix=".smoke-", dir=ROOT)
    try:
        if args.cards > 1:
            phase_cards(work, args.seed, args.cards)
        else:
            phase_kernel()
            res = phase_main(work, args.seed)
            phase_ref(work, args.seed, res["rmse"])
            phase_ooc(work, args.seed)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}),
        flush=True)


if __name__ == "__main__":
    main()
