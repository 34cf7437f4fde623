"""Batched SPD solve on the GPU: the CUDA kernel against the XLA path.

Builds ALS-shaped systems (the Gram of gathered factor rows plus the
lam * n_e ridge, with empty slots that solve the identity), checks both
solves against float64 NumPy on a sample, and times each one alone and
inside the ALS user phase and the full epoch at MovieLens-20M scale.

    python tools/bench_solve.py [--ranks 10,64,128] [--reps 10] [--no-epoch]

The kernel is built up to rank 64 (cuda_solve.MAX_RANK); at larger ranks
only the XLA solve is timed.

Needs the GPU backend. Every time is a median over --reps runs after a
warm-up, each ended by jax.block_until_ready.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_SYSTEMS = 138_493  # ML-20M users: one user phase of systems
SAMPLE = 4096  # systems checked against float64 NumPy


def log(*a):
    print(*a, flush=True)


def als_systems(k: int, n_sys: int = N_SYSTEMS, seed: int = 0,
                n_other: int = 26_744, slots: int = 32, lam: float = 0.05):
    """(A, b, reg) built the way an ALS phase builds them: each system
    gathers up to ``slots`` rows of a factor table whose rows have the
    squared norm of trained ML-20M factors (~3.5, so that u.v is a
    rating), A is their Gram, b the rating-weighted row sum, reg the
    lam * n_e ridge; every 64th system is an empty slot (n_e = 0, the
    identity guard)."""
    import jax
    import jax.numpy as jnp

    kf, ki, kc, kr = jax.random.split(jax.random.key(seed), 4)
    F = jax.random.normal(kf, (n_other + 1, k), jnp.float32) * (3.5 / k) ** .5
    F = F.at[n_other].set(0.0)  # the zero trash row padding gathers
    cnt = jax.random.randint(kc, (n_sys,), 1, slots + 1)
    cnt = jnp.where(jnp.arange(n_sys) % 64 == 0, 0, cnt)
    live = jnp.arange(slots)[None, :] < cnt[:, None]
    idx = jnp.where(live, jax.random.randint(ki, (n_sys, slots), 0, n_other),
                    n_other)
    r = jnp.where(live, jax.random.uniform(kr, (n_sys, slots), jnp.float32,
                                           1.0, 5.0), 0.0)
    Fg = F[idx]
    hi = jax.lax.Precision.HIGHEST
    A = jnp.einsum("brk,brm->bkm", Fg, Fg, precision=hi)
    b = jnp.einsum("brk,br->bk", Fg, r, precision=hi)
    reg = lam * cnt.astype(jnp.float32) + (cnt == 0)
    return jax.block_until_ready((A, b, reg))


def solve_f64(A, b, reg):
    """The float64 NumPy reference of guarded_batched_solve's contract."""
    import numpy as np

    A = np.asarray(A, np.float64)
    A = 0.5 * (A + np.swapaxes(A, -1, -2))
    A = A + np.asarray(reg, np.float64)[:, None, None] * np.eye(A.shape[-1])
    x = np.linalg.solve(A, np.asarray(b, np.float64)[..., None])[..., 0]
    return x, np.linalg.cond(A)


def check_solve(x, x64, cond):
    """Max of per-system error over its bound. A backward-stable Cholesky
    or LDL^T solve in float32 has relative forward error at most about
    k * eps_f32 * cond(A) (Higham, Accuracy and Stability, 10.1); the bound
    used is 4x that. Identity systems (b = 0) must solve to exactly 0."""
    import numpy as np

    x = np.asarray(x, np.float64)
    k = x.shape[-1]
    scale = np.abs(x64).max(axis=1)
    zero = scale == 0
    if np.abs(x[zero]).max(initial=0.0) != 0.0:
        raise AssertionError("an identity-guard system solved to nonzero")
    err = np.abs(x - x64).max(axis=1)[~zero] / scale[~zero]
    bound = 4 * k * np.finfo(np.float32).eps * cond[~zero]
    return float(err.max()), float((err / bound).max())


def median_time(fn, *args, reps: int = 10) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def compiled_solves(k: int):
    """{method: jitted (A, b, reg) -> x}: XLA, and the CUDA kernel where it
    takes rank k (k <= cuda_solve.MAX_RANK)."""
    import jax

    from ycnr_tpu.ops.cuda_solve import MAX_RANK
    from ycnr_tpu.ops.gram import guarded_batched_solve

    methods = ("xla", "cuda") if k <= MAX_RANK else ("xla",)
    return {m: jax.jit(lambda A, b, r, m=m: guarded_batched_solve(
        A, b, r, method=m)) for m in methods}


def bench_kernel(ranks, reps: int) -> dict:
    """Standalone solve: correctness against float64 and time, per rank."""
    import numpy as np

    out = {}
    for k in ranks:
        A, b, reg = als_systems(k)
        sel = np.random.default_rng(k).choice(N_SYSTEMS, SAMPLE,
                                              replace=False)
        sel[0] = 0  # an identity-guard system
        x64, cond = solve_f64(np.asarray(A)[sel], np.asarray(b)[sel],
                              np.asarray(reg)[sel])
        row = {"k": k, "B": N_SYSTEMS, "cond_max": float(cond.max())}
        for m, fn in compiled_solves(k).items():
            x = np.asarray(fn(A, b, reg))
            if not np.isfinite(x).all():
                raise AssertionError(f"{m} solve gave non-finite values")
            err, ratio = check_solve(x[sel], x64, cond)
            if ratio > 1.0:
                raise AssertionError(f"{m} solve at k={k}: error {err:.3g} "
                                     f"is {ratio:.3g}x its bound")
            row[f"{m}_err"] = err
            row[f"{m}_ms"] = 1e3 * median_time(fn, A, b, reg, reps=reps)
        if "cuda_ms" in row:
            row["speedup"] = row["xla_ms"] / row["cuda_ms"]
        log(json.dumps({"solve": row}))
        out[k] = row
        del A, b, reg
    return out


def bench_epoch(ranks, reps: int, seed: int = 0) -> dict:
    """ALS user phase and full epoch at ML-20M scale, XLA vs CUDA solve,
    each compiled once and then run in turns (xla, cuda, cuda, xla...)."""
    import jax
    import jax.numpy as jnp

    from ycnr_tpu.config import get_preset
    from ycnr_tpu.data.split import train_test_split
    from ycnr_tpu.data.synthetic import synthetic_ratings
    from ycnr_tpu.models.base import init_state
    from ycnr_tpu.models.bucketed_phase import (als_epoch_fn,
                                                device_bucketed,
                                                phase_bucketed)
    from ycnr_tpu.ops.bucketed import build_bucketed
    from ycnr_tpu.ops.cuda_solve import MAX_RANK
    from ycnr_tpu.ops.gram import solve_override

    p = get_preset("ml20m-als")
    nu, ni, nr = p.data.n_users, p.data.n_items, p.data.n_ratings
    lam, bf16 = p.als.lam, p.als.gather_dtype == "bfloat16"
    t0 = time.time()
    u, i, r = synthetic_ratings(nu, ni, nr, seed=seed)
    (tu, ti, tr), _ = train_test_split(u, i, r, p.data.test_fraction, seed)
    log(f"data: {len(r):,} ratings in {time.time() - t0:.1f}s")
    out = {}
    for k in [k for k in ranks if k <= MAX_RANK]:
        ug = device_bucketed(build_bucketed(tu, ti, tr, nu, ni,
                                            p.data.chunk_len, k,
                                            max_groups=p.data.max_groups))
        ig = device_bucketed(build_bucketed(ti, tu, tr, ni, nu,
                                            p.data.chunk_len, k,
                                            max_groups=p.data.max_groups))
        st = init_state(nu, ni, k, seed=seed)
        epoch = jax.jit(lambda s, a, b: als_epoch_fn(a, b, lam, bf16)(s))
        phase = jax.jit(lambda U, V, a: phase_bucketed(U, V, a, lam,
                                                       gather_bf16=bf16))
        fns = {}
        for m in ("xla", "cuda"):
            with solve_override(m):
                t0 = time.time()
                fns[m] = (epoch.lower(st, ug, ig).compile(),
                          phase.lower(st.U, st.V, ug).compile())
                log(f"k={k} {m}: compiled in {time.time() - t0:.1f}s")
        ts = {("epoch", m): [] for m in fns} | {("phase", m): [] for m in fns}
        states = {m: fns[m][0](st, ug, ig) for m in fns}  # warm-up epoch
        jax.block_until_ready(states)
        for rep in range(reps):
            for m in (("xla", "cuda") if rep % 2 == 0 else ("cuda", "xla")):
                t0 = time.perf_counter()
                states[m] = jax.block_until_ready(fns[m][0](states[m], ug,
                                                            ig))
                ts[("epoch", m)].append(time.perf_counter() - t0)
                s = states[m]
                t0 = time.perf_counter()
                jax.block_until_ready(fns[m][1](s.U, s.V, ug))
                ts[("phase", m)].append(time.perf_counter() - t0)
        diff = float(jnp.max(jnp.abs(states["xla"].U - states["cuda"].U)))
        row = {"k": k, "reps": reps, "max_abs_U_diff": diff}
        for (what, m), v in ts.items():
            row[f"{what}_{m}_s"] = statistics.median(v)
        row["epoch_speedup"] = row["epoch_xla_s"] / row["epoch_cuda_s"]
        log(json.dumps({"als": row}))
        out[k] = row
        del ug, ig, st, states, fns
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", default="10,64,128")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--no-epoch", action="store_true")
    args = ap.parse_args(argv)
    import jax

    from ycnr_tpu.utils.compile_cache import enable_compile_cache
    from ycnr_tpu.utils.device import (describe_device,
                                       gpu_name_and_power_limit,
                                       require_gpu)

    require_gpu()
    enable_compile_cache()
    log(json.dumps(describe_device()))
    log(gpu_name_and_power_limit())
    ranks = [int(x) for x in args.ranks.split(",")]
    from ycnr_tpu.ops.cuda_solve import build_library

    t0 = time.time()
    log(f"kernel library {build_library()} in {time.time() - t0:.1f}s")
    bench_kernel(ranks, args.reps)
    if not args.no_epoch:
        bench_epoch(ranks, args.reps)
    log(f"devices: {jax.devices()}")


if __name__ == "__main__":
    main()
