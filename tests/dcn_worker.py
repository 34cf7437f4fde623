"""Worker process for the 2-process DCN (multi-host) smoke test.

Run by tests/test_dcn_2proc.py, once per simulated host: joins a real
`jax.distributed` rendezvous on localhost (the reference's hypothetical TCP
multi-machine mode, SURVEY.md C4 [K-low]; §5 "distributed communication
backend"), with N fake CPU devices per process, then trains over the GLOBAL
mesh via the unchanged sharded paths (parallel/shard.py, parallel/dual.py) —
the collectives really cross the process boundary (Gloo on CPU; DCN on real
pods). Results (per-epoch RMSE + a factor checksum) are written as JSON for
the parent to compare against a single-process run of the same config.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--local-devices", type=int, default=4)
    ap.add_argument("--out", required=True)
    ap.add_argument("--workdir", required=True)
    args = ap.parse_args()

    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = (
        f"{flags} --xla_force_host_platform_device_count="
        f"{args.local_devices}").strip()
    import jax

    # set through jax.config as well as the env, before any backend init
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from ycnr_tpu.parallel import init_distributed

    pid = init_distributed(args.coordinator, args.num_processes,
                           args.process_id)
    n_global = len(jax.devices())
    assert jax.process_count() == args.num_processes, jax.process_count()

    import numpy as np

    from ycnr_tpu.train.loop import train

    result = {"process_id": pid, "process_count": jax.process_count(),
              "n_global_devices": n_global}
    for mode, cfg in sorted(configs(n_global).items()):
        r = train(cfg, out_dir=os.path.join(args.workdir, f"p{pid}", mode))
        gs = r.state
        digest = hashlib.sha256()
        for a in (gs.U, gs.V, gs.bu, gs.bi):
            digest.update(np.ascontiguousarray(np.asarray(a)).tobytes())
        result[mode] = {"rmse": [round(float(x), 10) for x in r.rmse_history],
                        "state_sha": digest.hexdigest()}
    result["ooc"] = run_ooc()
    with open(args.out, "w") as f:
        json.dump(result, f)
    jax.distributed.shutdown()


OOC_SHAPE = (401, 157, 12_000)  # users, items, ratings — parent must match
OOC_LAM = 0.05
OOC_EPOCHS = 2


def _sha(state) -> str:
    import hashlib

    import numpy as np

    d = hashlib.sha256()
    for a in (state.U, state.V, state.bu, state.bi):
        d.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return d.hexdigest()


def host_rmse(state, u, i, r) -> float:
    """Train RMSE on host — shared scorer between workers and the parent's
    single-chip reference so the parity comparison cannot drift."""
    import numpy as np

    U = np.asarray(state.U)
    V = np.asarray(state.V)
    pred = ((U[u] * V[i]).sum(1) + np.asarray(state.bu)[u]
            + np.asarray(state.bi)[i] + float(state.mu))
    return float(np.sqrt(np.mean((pred - r) ** 2)))


def run_ooc() -> dict:
    """Streamed OOC x mesh over the DCN boundary (SURVEY.md §3.2: every
    worker streams its own portions). Each process feeds ONLY the [D]-axis
    wire rows its local devices own (parallel/ooc_mesh.feed_sharded_wire);
    every non-local row is poisoned first (NaN floats / saturated ints), so
    if any transport path read another host's rows the factors would differ
    from the pinned-tier epoch — the parent asserts they are BITWISE equal."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ycnr_tpu.data.synthetic import synthetic_ratings
    from ycnr_tpu.models.base import init_state, zero_cold_entities
    from ycnr_tpu.parallel.mesh import make_mesh
    from ycnr_tpu.parallel.ooc_mesh import (_WIRE, build_sharded_wire,
                                            feed_sharded_wire,
                                            make_sharded_ooc_epoch)
    from ycnr_tpu.parallel.shard import gather_state, scatter_state

    NU, NI, NR = OOC_SHAPE
    u, i, r = synthetic_ratings(NU, NI, NR, true_rank=4, noise=0.2, seed=3)
    D = len(jax.devices())
    mesh = make_mesh(D)
    sw, meta = build_sharded_wire(u, i, r, NU, NI, D, rank_hint=8,
                                  max_groups=4)

    st0 = init_state(NU, NI, 8, seed=0, dtype=jnp.float64)
    st0 = zero_cold_entities(st0, u, i)

    # Both tiers run through wire_as_args: JAX forbids CLOSING OVER arrays
    # that span non-addressable devices, so the closed-over pinned epoch is
    # a single-controller convenience only — on a multi-process job the
    # wire must ride as (donatable) arguments either way. The "reference"
    # run below feeds the INTACT wire; the locality run feeds the poisoned
    # one; bitwise-equal results prove no transport read non-local rows.
    epoch_s = make_sharded_ooc_epoch(mesh, sw, OOC_LAM, dtype=jnp.float64,
                                     wire_as_args=True)
    stp = scatter_state(st0, meta, mesh)
    rmse_p = []
    for _ in range(OOC_EPOCHS):
        stp = epoch_s(stp, feed_sharded_wire(sw, mesh))
        rmse_p.append(round(host_rmse(gather_state(stp, meta), u, i, r), 12))
    pinned = gather_state(stp, meta)

    # --- streamed tier: per-process feed of POISONED-non-local wire ------
    my = jax.process_index()
    nonlocal_d = np.asarray([dev.process_index != my
                             for dev in mesh.devices.flat])

    def poison(a):
        a = np.array(np.asarray(a), copy=True)
        if np.issubdtype(a.dtype, np.floating):
            a[nonlocal_d] = np.nan
        else:
            a[nonlocal_d] = np.iinfo(a.dtype).max
        return a

    def poison_groups(groups):
        return tuple(
            g._replace(**{n: poison(getattr(g, n)) for n in _WIRE})
            for g in groups)

    # item_deg stays intact: it is P()-replicated geometry, not wire rows
    sw_poisoned = sw._replace(ugroups=poison_groups(sw.ugroups),
                              igroups=poison_groups(sw.igroups),
                              inv_local=poison(sw.inv_local))
    # rebuild the init state: the reference tier's first epoch DONATED the
    # scattered buffers, and scatter_state aliases already-device leaves
    st0 = init_state(NU, NI, 8, seed=0, dtype=jnp.float64)
    st0 = zero_cold_entities(st0, u, i)
    sts = scatter_state(st0, meta, mesh)
    rmse_s = []
    for _ in range(OOC_EPOCHS):
        # re-feed per epoch: the epoch donates the wire buffers, exactly
        # the streamed tier's HBM contract (wire lives only while consumed)
        sts = epoch_s(sts, feed_sharded_wire(sw_poisoned, mesh))
        rmse_s.append(round(host_rmse(gather_state(sts, meta), u, i, r), 12))
    streamed = gather_state(sts, meta)

    return {"rmse": rmse_p, "rmse_streamed": rmse_s,
            "state_sha": _sha(pinned), "streamed_sha": _sha(streamed)}


def configs(n_shards: int):
    """Tiny-but-real configs, one per sharded code path. Must be identical
    in the workers and in the parent's single-process reference run."""
    from ycnr_tpu.config import (
        ALSConfig,
        BPRConfig,
        DataConfig,
        MeshConfig,
        RunConfig,
        SGDConfig,
    )

    data = DataConfig(n_users=400, n_items=120, n_ratings=6000, seed=3)
    return {
        # P1/P2: user-sharded U-step + item-Gram psum over the mesh
        "als": RunConfig(
            name="dcn-als", algorithm="als", data=data,
            als=ALSConfig(rank=8, lam=0.05, epochs=2),
            mesh=MeshConfig(n_shards=n_shards)),
        # M6 alternative: both factor axes sharded, all-gather V
        "als_dual": RunConfig(
            name="dcn-als-dual", algorithm="als", data=data,
            als=ALSConfig(rank=8, lam=0.05, epochs=2),
            mesh=MeshConfig(n_shards=n_shards, vstep_mode="item_sharded")),
        # P3: DP SGD with per-batch V-delta psum
        "sgd": RunConfig(
            name="dcn-sgd", algorithm="sgd", data=data,
            sgd=SGDConfig(rank=8, epochs=2, batch_size=512),
            mesh=MeshConfig(n_shards=n_shards)),
        # DP pairwise ranking: per-device negative draws, fused Vf psum
        "bpr": RunConfig(
            name="dcn-bpr", algorithm="bpr", data=data,
            bpr=BPRConfig(rank=8, epochs=2, batch_size=512),
            mesh=MeshConfig(n_shards=n_shards)),
    }


if __name__ == "__main__":
    sys.exit(main())
