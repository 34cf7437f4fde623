"""ALS epoch attribution via full-epoch variants.

Measures where the ML-20M rank-64 epoch time goes by compiling FULL-epoch
programs with one stage neutralized at a time (gather-only / no-solve /
no-scatter / full) — same program structure as the real epoch. The
layouts are passed as jit ARGUMENTS; closing them over the function would
inline them as HLO constants. The no_solve variant still scatters, so
Grams = no_solve - gather_only - scatters; the four parts sum to full.

Run on the GPU host (uses bench.py's cached ML-20M COO):
    python tools/attrib_als.py
Not yet measured on the GPU.
"""
import os, sys, time
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax, jax.numpy as jnp
from functools import partial
from jax import lax
from ycnr_tpu.models.base import init_state
from ycnr_tpu.ops.bucketed import build_bucketed
from ycnr_tpu.models.bucketed_phase import device_bucketed
from ycnr_tpu.ops.gram import guarded_batched_solve
from ycnr_tpu.utils.compile_cache import enable_compile_cache
from ycnr_tpu.utils.device import require_gpu

require_gpu("tools/attrib_als.py")
enable_compile_cache()
import bench  # noqa: E402  (the repo root is on sys.path above)

cache_dir = os.environ.get("YCNR_BENCH_CACHE", bench.BENCH_CACHE_DIR)
import glob
hits = sorted(glob.glob(os.path.join(
    cache_dir, "v1_coo_138493x26744x20000263_s0_*.npz")))
if not hits:
    sys.exit("run `python bench.py` once first (needs its cached COO)")
z = np.load(hits[-1])
tu, ti, tr = z["tu"], z["ti"], z["tr"]
NU, NI = 138_493, 26_744
R = int(sys.argv[1]) if len(sys.argv) > 1 else 64  # rank (64 default; 128 probes the solve-bound regime)
sys.stderr.write("building layouts...\n")
ul = device_bucketed(build_bucketed(tu, ti, tr, NU, NI, 32, R, max_groups=8))
il = device_bucketed(build_bucketed(ti, tu, tr, NI, NU, 32, R, max_groups=8))

def phase_variant(E, F, groups, lam, mode):
    F_g = F.astype(jnp.bfloat16)
    for g in groups:
        def body(Ec, blk):
            oi, rr, eid, cnt = blk
            Fg = F_g[oi]
            rr = rr.astype(jnp.bfloat16)
            if mode == "gather_only":
                # consume the gather without Gram/solve/scatter
                s = jnp.sum(Fg.astype(jnp.float32), axis=(1, 2)) + jnp.sum(rr.astype(jnp.float32), axis=1)
                return Ec.at[eid, 0].add(s * 1e-30), None
            A = jnp.einsum("urk,urm->ukm", Fg, Fg, preferred_element_type=jnp.float32)
            b = jnp.einsum("urk,ur->uk", Fg, rr, preferred_element_type=jnp.float32)
            if mode == "no_solve":
                rows = b + jnp.sum(A, axis=2) * 1e-30  # consume A, skip cho
            else:
                reg = lam * cnt + (cnt == 0)
                rows = guarded_batched_solve(A, b, reg)
            if mode == "no_scatter":
                return Ec.at[0, 0].add(jnp.sum(rows) * 1e-30), None
            return Ec.at[eid].set(rows.astype(Ec.dtype)), None
        E, _ = lax.scan(body, E, tuple(g))
    return E

@partial(jax.jit, static_argnames=("mode",), donate_argnums=(0,))
def epoch(st, ulx, ilx, mode):
    U = phase_variant(st.U, st.V, ulx, 0.05, mode)
    V = phase_variant(st.V, U, ilx, 0.05, mode)
    return st._replace(U=U, V=V)

import json

steady = {}
for mode in ("full", "no_solve", "no_scatter", "gather_only"):
    st = init_state(NU, NI, R, seed=0)
    t0 = time.time(); st = jax.block_until_ready(epoch(st, ul, il, mode))
    first = time.time() - t0
    ts = []
    for _ in range(3):
        t0 = time.time(); st = jax.block_until_ready(epoch(st, ul, il, mode)); ts.append(time.time() - t0)
    steady[mode] = float(np.median(ts))
    sys.stderr.write(f"{mode:12s} first={first:6.1f}s steady={steady[mode]:.4f}s\n")

# disjoint split: the no_solve variant still scatters, so Grams = no_solve - gather_only - scatters
full = steady["full"]
scatters = full - steady["no_scatter"]
solves = full - steady["no_solve"]
grams = steady["no_solve"] - steady["gather_only"] - scatters
print(json.dumps({
    "scale": "ml20m", "rank": R, "groups": 8, "gather": "bf16",
    "steady_s": {k: round(v, 4) for k, v in steady.items()},
    "split_s": {"gathers": round(steady["gather_only"], 4),
                "grams": round(grams, 4), "solves": round(solves, 4),
                "scatters": round(scatters, 4), "full": round(full, 4)}}),
    flush=True)
