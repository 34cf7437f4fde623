"""Randomized cross-mode parity fuzz (SURVEY.md §4 items 1-2, widened).

The fixed-shape parity tests pin exact seeds; this fuzz sweeps random
shapes/densities/shard counts so packing edge cases (tiny rungs, uneven LPT
partitions, near-empty shards, cold entities) keep agreeing across the
single-chip bucketed, single-chip blocked, and sharded paths.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ycnr_tpu.data.split import train_test_split
from ycnr_tpu.data.synthetic import synthetic_ratings
from ycnr_tpu.models.als import als_epoch
from ycnr_tpu.models.base import (
    device_layout,
    rmse_padded,
    state_from_numpy,
    zero_cold_entities,
)
from ycnr_tpu.models.bucketed_phase import (
    als_epoch_bucketed,
    device_bucketed,
    ials_epoch_bucketed,
)
from ycnr_tpu.models.ials import ials_epoch
from ycnr_tpu.ops.bucketed import build_bucketed
from ycnr_tpu.ops.layout import build_blocked_csr, pad_coo
from ycnr_tpu.parallel import (
    build_sharded_data,
    gather_state,
    scatter_state,
    sharded_als_epoch,
    sharded_ials_epoch,
)
from ycnr_tpu.parallel.dual import (
    build_dual_sharded_data,
    dual_als_epoch,
    dual_gather_state,
    dual_ials_epoch,
    dual_scatter_state,
)
from ycnr_tpu.parallel.mesh import make_mesh

DT = jnp.float64

# 25 cases. Each case draws random shapes,
# density, rank, shard count, lambda AND a mode combination:
#   algo:  als / ials (alpha drawn too)
#   mesh:  gram_psum (user-sharded) / item_sharded (dual)


@pytest.mark.parametrize("case", range(25))
def test_fuzz_mode_parity(case):
    rng = np.random.default_rng(1000 + case)
    nu = int(rng.integers(20, 150))
    ni = int(rng.integers(10, 90))
    nnz = int(rng.integers(nu, max(nu + 1, nu * ni // 3)))
    k = int(rng.choice([2, 4, 7]))
    shards = int(rng.choice([2, 4, 8]))
    lam = float(rng.uniform(0.01, 0.3))
    algo = "ials" if case % 3 == 2 else "als"
    dual = case % 2 == 1
    alpha = float(rng.uniform(1.0, 20.0))
    u, i, r = synthetic_ratings(nu, ni, nnz, true_rank=3, seed=case)
    (tu, ti, tr), (su, si, sr) = train_test_split(u, i, r, 0.1, seed=case)
    U0 = rng.normal(0, 0.1, (nu, k))
    V0 = rng.normal(0, 0.1, (ni, k))

    # blocked single-chip
    sb = zero_cold_entities(state_from_numpy(U0, V0, dtype=DT), tu, ti)
    dul = device_layout(build_blocked_csr(tu, ti, tr, nu, ni, 8), DT)
    dil = device_layout(build_blocked_csr(ti, tu, tr, ni, nu, 8), DT)
    # bucketed single-chip
    sk = zero_cold_entities(state_from_numpy(U0, V0, dtype=DT), tu, ti)
    bul = device_bucketed(build_bucketed(tu, ti, tr, nu, ni, 8, k,
                                         max_groups=3), DT)
    bil = device_bucketed(build_bucketed(ti, tu, tr, ni, nu, 8, k,
                                         max_groups=3), DT)
    # sharded (either vstep mode); cold entities occupy no layout slot in
    # ANY mode, so parity is defined after zero_cold_entities (the train
    # loop's contract) — mirror it here
    mesh = make_mesh(shards)
    s0 = zero_cold_entities(state_from_numpy(U0, V0, dtype=DT), tu, ti)
    if dual:
        data, meta = build_dual_sharded_data(
            tu, ti, tr, nu, ni, shards, chunk_len=8, test_u=su, test_i=si,
            test_r=sr, dtype=DT, mesh=mesh)
        st = dual_scatter_state(s0, meta, mesh)
    else:
        data, meta = build_sharded_data(
            tu, ti, tr, nu, ni, shards, chunk_len=8, test_u=su, test_i=si,
            test_r=sr, dtype=DT, mesh=mesh)
        st = scatter_state(s0, meta, mesh)

    for _ in range(2):
        if algo == "als":
            sb = als_epoch(sb, dul, dil, lam)
            sk = als_epoch_bucketed(sk, bul, bil, lam)
            st = (dual_als_epoch(mesh, st, data, lam) if dual
                  else sharded_als_epoch(mesh, st, data, lam))
        else:
            sb = ials_epoch(sb, dul, dil, lam, alpha)
            sk = ials_epoch_bucketed(sk, bul, bil, lam, alpha)
            st = (dual_ials_epoch(mesh, st, data, lam, alpha) if dual
                  else sharded_ials_epoch(mesh, st, data, lam, alpha))
    np.testing.assert_allclose(np.asarray(sk.U), np.asarray(sb.U),
                               rtol=1e-8, atol=1e-8)
    g = dual_gather_state(st, meta) if dual else gather_state(st, meta)
    np.testing.assert_allclose(np.asarray(g.U), np.asarray(sb.U),
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(np.asarray(g.V), np.asarray(sb.V),
                               rtol=1e-8, atol=1e-8)
    if len(sr):
        pu, pi, pr, n = pad_coo(su, si, sr, nu, ni, 64)
        rm = float(rmse_padded(sb, jnp.asarray(pu), jnp.asarray(pi),
                               jnp.asarray(pr), n))
        assert np.isfinite(rm)
