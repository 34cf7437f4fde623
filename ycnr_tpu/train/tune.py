"""One-program hyperparameter sweep for ALS-WR / iALS.

The reference is a study engine: exploring rank/lambda/alpha means re-running
`node train` once per config (SURVEY.md §1 L6, C14 config module). A naive
port of that loop is punishing — `lam` is a static arg of the epoch
programs, so every config would recompile the epoch executable (tens of
seconds each at ML-20M scale).

The sweep instead makes the hyperparameters DATA: stack the S
models' states on a leading axis, pass lambda/alpha as traced [S] vectors,
and run `lax.map` over the model axis inside ONE jitted program (sequential
on device, so peak temp memory stays one model's worth; the rating layouts
are shared, traced once). Every config then trains at steady-state epoch
speed with zero per-config compiles, and the per-epoch held-out RMSE
trajectories come back as one [S, E] array.

SGD sweeps run the stream trainer (models/sgd_stream.py): its epoch core
takes lam/lr as plain arithmetic inputs, so (lambda, lr) become per-model
traced vectors exactly like the ALS path; the batched SGD trainer is not
swept (its batch schedule is baked per config). BPR sweeps ride
models/bpr.bpr_epoch_core the same way (lambda x lr x init-seed), scored
per epoch by held-out pairwise AUC and ranked by final hit-rate@topn.

With cfg.mesh.n_shards > 1 the MODEL axis shards over the 1-D device mesh
(`_sweep_sharded`): each chip trains its own slice of the config grid
against replicated data — embarrassingly parallel, zero collectives, a
D-fold sweep wall-time cut on D chips. Note the axis choice: sharded
TRAINING (parallel/shard.py) splits one model's users across chips; the
sweep splits MODELS across chips, which is the right mapping when the
single-chip epoch already fits — no collective traffic at all.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ycnr_tpu.config import RunConfig
from ycnr_tpu.data.dataset import Dataset, load_dataset
from ycnr_tpu.models.base import MFState, init_state, zero_cold_entities
from ycnr_tpu.models.bucketed_phase import (
    _epochs_fused,
    als_epoch_fn,
    device_bucketed,
    ials_epoch_fn,
)
from ycnr_tpu.ops.bucketed import build_bucketed
from ycnr_tpu.train.loop import _algo_params


@dataclass
class TuneResult:
    leaderboard: list  # dicts sorted best-first (see tune() for keys)
    best: dict
    best_state: MFState
    dataset: Dataset


def _als_runner(user_groups, item_groups, test_coo, n_epochs: int,
                implicit: bool, gather_bf16: bool):
    """(state, lam, alpha) -> (final state, rmse[n_epochs]) for one model —
    shared by the single-chip lax.map and the sharded shard_map sweep."""

    def one(args):
        st, lam, alpha = args
        # the SAME epoch bodies the single-model train paths run — lam and
        # alpha are traced scalars here, plain floats there
        epoch = (ials_epoch_fn(user_groups, item_groups, lam, alpha,
                               gather_bf16) if implicit
                 else als_epoch_fn(user_groups, item_groups, lam,
                                   gather_bf16))
        final, (rmse_t, _) = _epochs_fused(st, n_epochs, epoch, test_coo,
                                           None)
        return final, rmse_t

    return one


def _sgd_runner(data_arrays, decay, test_coo, n_epochs: int, tile: int,
                seed: int):
    """SGD analog of _als_runner. The per-epoch batch order reproduces
    StreamSGD.epoch's shuffle (same key formula) and is shared by every
    model, so a config's trajectory matches a standalone
    `--sgd-method stream` run (up to the in-program f32 lr-decay power vs
    the host's f64 — a last-ulp difference)."""
    from ycnr_tpu.models.base import rmse_padded
    from ycnr_tpu.models.sgd_stream import stream_epoch_core

    ul, ib, rb, wu, wi, u_lo = data_arrays
    nb = ul.shape[0]

    def one(args):
        st, lam, lr0 = args

        def body(s, ep):
            key = jax.random.key(seed + 7919 * ep)
            order = jax.random.permutation(key, nb)
            s = stream_epoch_core(s, ul, ib, rb, wu, wi, u_lo, order,
                                  lam, lr0 * decay**ep, tile)
            return s, rmse_padded(s, *test_coo)

        return lax.scan(body, st, jnp.arange(n_epochs))

    return one


@partial(jax.jit, static_argnames=("n_epochs", "implicit", "gather_bf16"),
         donate_argnums=(0,))
def _sweep_program(states: MFState, lams, alphas, user_groups, item_groups,
                   test_coo, n_epochs: int, implicit: bool,
                   gather_bf16: bool = False):
    """states: MFState pytree with a leading model axis [S, ...]; lams /
    alphas: [S]. Returns (final stacked states, rmse_test [S, n_epochs])."""
    one = _als_runner(user_groups, item_groups, test_coo, n_epochs,
                      implicit, gather_bf16)
    return lax.map(one, (states, lams, alphas))


@partial(jax.jit, static_argnames=("n_epochs", "tile", "seed"),
         donate_argnums=(0,))
def _sweep_sgd_program(states: MFState, lams, lrs, decay, data_arrays,
                       test_coo, n_epochs: int, tile: int, seed: int):
    one = _sgd_runner(data_arrays, decay, test_coo, n_epochs, tile, seed)
    return lax.map(one, (states, lams, lrs))


def _bpr_runner(data_arrays, decay, eval_triples, n_epochs: int,
                batch_size: int, grad_mode: str, shuffle: str = "rows"):
    """BPR analog of _sgd_runner: per-epoch draws reproduce
    BPRTrainer.epoch's key formula with each model's OWN seed (the seed
    axis is per-model traced data, like lam/lr — so every leaderboard
    entry, not just ones sharing cfg.seed, reproduces a standalone
    `--algorithm bpr` run of its saved config). The per-epoch metric is
    held-out pairwise AUC over fixed (test-positive, sampled-unrated)
    triples — ranking logits have no RMSE."""
    from ycnr_tpu.models.bpr import (
        bpr_epoch_batches_core,
        bpr_epoch_core,
        check_shuffle,
    )

    check_shuffle(shuffle)
    u, i, bits, wu, wi = data_arrays
    eu, ei, ej = eval_triples
    n_pad = u.shape[0]

    def one(args):
        st, lam, lr0, sd = args
        n_items = st.V.shape[0] - 1

        def body(s, ep):
            key = jax.random.key(sd + 7919 * ep)  # BPRTrainer's formula
            kp, kn = jax.random.split(key)
            negs = jax.random.randint(kn, (n_pad,), 0, n_items, jnp.int32)
            if shuffle == "batches":
                border = jax.random.permutation(kp, n_pad // batch_size)
                U, V, bi = bpr_epoch_batches_core(
                    s.U, s.V, s.bi, u.reshape(-1, batch_size),
                    i.reshape(-1, batch_size), border,
                    negs.reshape(-1, batch_size), bits, wu, wi, lam,
                    lr0 * decay**ep, grad_mode)
            else:
                perm = jax.random.permutation(kp, n_pad)
                U, V, bi = bpr_epoch_core(
                    s.U, s.V, s.bi, u[perm].reshape(-1, batch_size),
                    i[perm].reshape(-1, batch_size),
                    negs.reshape(-1, batch_size), bits, wu, wi, lam,
                    lr0 * decay**ep, grad_mode)
            s = s._replace(U=U, V=V, bi=bi)
            xi = jnp.einsum("nk,nk->n", s.U[eu], s.V[ei]) + s.bi[ei]
            xj = jnp.einsum("nk,nk->n", s.U[eu], s.V[ej]) + s.bi[ej]
            return s, jnp.mean((xi > xj).astype(s.U.dtype))

        return lax.scan(body, st, jnp.arange(n_epochs))

    return one


@partial(jax.jit, static_argnames=("n_epochs", "batch_size", "grad_mode",
                                   "shuffle"),
         donate_argnums=(0,))
def _sweep_bpr_program(states: MFState, lams, lrs, seeds, decay,
                       data_arrays, eval_triples, n_epochs: int,
                       batch_size: int, grad_mode: str,
                       shuffle: str = "rows"):
    one = _bpr_runner(data_arrays, decay, eval_triples, n_epochs,
                      batch_size, grad_mode, shuffle)
    return lax.map(one, (states, lams, lrs, seeds))


def _sweep_sharded(mesh, kind: str, states, v1, v2, shared, n_epochs,
                   v3=None, **kw):
    """Mesh-parallel sweep: the MODEL axis shards over the 1-D mesh — each
    device trains its own slice of the config grid against replicated data
    (embarrassingly parallel: zero collectives; D devices give a D-fold
    sweep wall-time cut). Same runner bodies as the single-chip programs,
    so per-config results are identical.

    v1/v2 = per-model hyperparam vectors (lam + alpha|lr); shared = the
    replicated operands tuple (layouts/test for ALS; data+decay+test for
    SGD). The model count must divide the mesh — tune() pads the grid."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ycnr_tpu.parallel.mesh import AXIS

    def local(states_l, v1_l, v2_l, *rest):
        if kind == "bpr":
            v3_l, shared_ops = rest[0], rest[1:]
            one = _bpr_runner(shared_ops[0], shared_ops[1], shared_ops[2],
                              n_epochs, kw["batch_size"], kw["grad_mode"],
                              kw.get("shuffle", "rows"))
            return lax.map(one, (states_l, v1_l, v2_l, v3_l))
        shared_ops = rest
        if kind == "sgd":
            one = _sgd_runner(shared_ops[0], shared_ops[1], shared_ops[2],
                              n_epochs, kw["tile"], kw["seed"])
        else:
            one = _als_runner(shared_ops[0], shared_ops[1], shared_ops[2],
                              n_epochs, kw["implicit"], kw["gather_bf16"])
        return lax.map(one, (states_l, v1_l, v2_l))

    shard = NamedSharding(mesh, P(AXIS))
    repl = NamedSharding(mesh, P())
    states = jax.tree.map(lambda x: jax.device_put(x, shard), states)
    v1, v2 = jax.device_put(v1, shard), jax.device_put(v2, shard)
    extra = ()
    if v3 is not None:
        extra = (jax.device_put(v3, shard),)
    shared = jax.tree.map(lambda x: jax.device_put(x, repl), shared)
    fn = jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS)) + (P(AXIS),) * len(extra)
        + (P(),) * len(shared),
        out_specs=(P(AXIS), P(AXIS))), donate_argnums=(0,))
    return fn(states, v1, v2, *extra, *shared)


def _bpr_eval_triples(ds: Dataset, seed: int):
    """Fixed held-out AUC triples: every test positive paired with one
    uniformly-drawn item unrated by that user (train OR test). Drawn once
    per sweep so each epoch's AUC is comparable; the rare user who rated
    the whole catalog is dropped."""
    from ycnr_tpu.models.bpr import pack_rated_bits

    bits = pack_rated_bits(
        np.concatenate([ds.train_u, ds.test_u]),
        np.concatenate([ds.train_i, ds.test_i]),
        ds.n_users, ds.n_items)
    rng = np.random.default_rng(seed)
    eu = np.asarray(ds.test_u, np.int32)
    ei = np.asarray(ds.test_i, np.int32)
    ej = rng.integers(0, ds.n_items, len(eu)).astype(np.int32)

    def _coll(j):
        return ((bits[eu, j // 32] >> (j % 32).astype(np.uint32)) & 1) == 1

    if len(eu) == 0:
        raise ValueError(
            "BPR sweep has no held-out positives to score AUC on — the "
            "split produced an empty test set (test_fraction=0, or a "
            "last-out split where every user has <= k ratings). Use a "
            "split that leaves test ratings, or sweep by RMSE instead.")
    for _ in range(64):  # vectorized rejection; a few rounds suffice
        bad = _coll(ej)
        if not bad.any():
            break
        ej[bad] = rng.integers(0, ds.n_items, int(bad.sum()))
    keep = ~_coll(ej)
    if not keep.any():
        raise ValueError(
            "BPR sweep AUC triples are empty after dropping users who "
            "rated the whole catalog — every epoch's AUC would be NaN. "
            "The catalog is too small relative to the rating density for "
            "a meaningful AUC; use an RMSE-based sweep.")
    return (jnp.asarray(eu[keep]), jnp.asarray(ei[keep]),
            jnp.asarray(ej[keep]))


def _stack_states(states: Sequence[MFState]) -> MFState:
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


def _pick_state(stacked: MFState, idx: int) -> MFState:
    return jax.tree.map(lambda x: x[idx], stacked)


def tune(cfg: RunConfig, lams: Sequence[float],
         alphas: Optional[Sequence[float]] = None,
         lrs: Optional[Sequence[float]] = None,
         seeds: Sequence[int] = (0,), epochs: Optional[int] = None,
         dataset: Optional[Dataset] = None) -> TuneResult:
    """Grid sweep in one device program. Axes: lambda, x alpha (iALS),
    x lr (SGD), x init seed. Leaderboard sorted by the selection metric:

    * als / sgd: final held-out RMSE, ascending;
    * ials: hit_rate@cfg.topn (host pass on up to 512 sampled test users,
      the same per-epoch metric train() logs), descending — RMSE against raw
      ratings is not meaningful for preference scores; rmse_test is still
      reported per config.

    SGD sweeps run the stream trainer (models/sgd_stream.py — the fast
    epoch; the batched path bakes its batch schedule per config). For
    ALS/iALS the seed axis varies factor INIT only (the data seed stays
    cfg.seed); for SGD a seed axis is refused — stream order is pinned to
    cfg.seed, so a winner at another init seed would save a config that
    cannot reproduce its sweep trajectory.

    Leaderboard entries: {lam, alpha?, lr?, seed, rmse: [E], rmse_final,
    best_epoch, hit_rate?}. The best config's trained state is returned
    (ready to checkpoint/serve). Memory: all S states stay in HBM —
    S * (n_users + n_items) * rank floats; at ML-20M rank 64 that is
    ~42 MB/model, so double-digit sweeps fit comfortably.
    """
    implicit = cfg.algorithm == "ials"
    is_sgd = cfg.algorithm == "sgd"
    is_bpr = cfg.algorithm == "bpr"
    params = _algo_params(cfg)
    if implicit and not alphas:
        alphas = [params.alpha]
    if alphas and not implicit:
        raise ValueError("alphas only applies to algorithm='ials'")
    if (is_sgd or is_bpr) and not lrs:
        lrs = [params.lr]
    if is_sgd and any(int(s) != cfg.seed for s in seeds):
        # the sweep shares cfg.seed for stream striping + epoch shuffles;
        # a differing init-seed axis would win with a trajectory that the
        # saved {seed: s} config could NOT reproduce (train() uses cfg.seed
        # for BOTH init and shuffles). Vary cfg.seed across tune() calls
        # instead.
        raise ValueError(
            "SGD sweeps do not take a seed axis: stream order is pinned "
            f"to cfg.seed ({cfg.seed}); vary cfg.seed per sweep instead")
    if lrs and not (is_sgd or is_bpr):
        raise ValueError("lrs only applies to algorithm='sgd'/'bpr'")
    if not lams:
        raise ValueError("tune() needs at least one lambda value")
    n_epochs = int(epochs if epochs is not None else params.epochs)
    if n_epochs <= 0:
        raise ValueError(f"epochs must be positive, got {n_epochs}")

    ds = dataset or load_dataset(cfg.data, rank_hint=params.rank)
    dtype = jnp.dtype(params.dtype)
    pu, pi, pr, n_test = ds.padded_test()
    test_coo = (jnp.asarray(pu), jnp.asarray(pi), jnp.asarray(pr),
                jnp.asarray(n_test))

    aux = ([float(a) for a in alphas] if implicit
           else [float(x) for x in lrs] if (is_sgd or is_bpr) else [0.0])
    grid = list(itertools.product(
        [float(x) for x in lams], aux, [int(s) for s in seeds]))
    mesh = None
    grid_run = grid
    if cfg.mesh.n_shards > 1:
        # mesh-parallel sweep: configs shard over devices (D-fold sweep
        # speedup, zero collectives); pad the grid to divide the mesh —
        # pad rows recompute the last config and are dropped below
        from ycnr_tpu.parallel.mesh import make_mesh

        mesh = make_mesh(cfg.mesh.n_shards)
        grid_run = grid + [grid[-1]] * ((-len(grid)) % cfg.mesh.n_shards)
    mu = ds.mu if is_sgd else 0.0
    states = _stack_states([
        zero_cold_entities(
            init_state(ds.n_users, ds.n_items, params.rank, seed=seed,
                       mu=mu, dtype=dtype),
            ds.train_u, ds.train_i)
        for _, _, seed in grid_run])
    lam_v = jnp.asarray([g[0] for g in grid_run], dtype)
    aux_v = jnp.asarray([g[1] for g in grid_run], dtype)

    if is_bpr:
        from ycnr_tpu.models.bpr import prepare_bpr_data

        bdata = prepare_bpr_data(
            ds.train_u, ds.train_i, params.batch_size, ds.n_users,
            ds.n_items,
            shuffle_rows_seed=(0 if params.shuffle == "batches"
                               else None))
        arrays = (bdata.u, bdata.i, bdata.bits, bdata.wu, bdata.wi)
        triples = _bpr_eval_triples(ds, cfg.seed)
        decay = jnp.asarray(params.lr_decay, dtype)
        seed_v = jnp.asarray([g[2] for g in grid_run], jnp.int32)
        if mesh is not None:
            finals, traj = _sweep_sharded(
                mesh, "bpr", states, lam_v, aux_v,
                (arrays, decay, triples), n_epochs, v3=seed_v,
                batch_size=params.batch_size, grad_mode=params.grad_mode,
                shuffle=params.shuffle)
        else:
            finals, traj = _sweep_bpr_program(
                states, lam_v, aux_v, seed_v, decay, arrays, triples,
                n_epochs, params.batch_size, params.grad_mode,
                shuffle=params.shuffle)
    elif is_sgd:
        from ycnr_tpu.models.sgd_stream import prepare_stream_sgd

        gm = "capped" if params.grad_mode == "sum" else params.grad_mode
        data, _ = prepare_stream_sgd(
            ds.train_u, ds.train_i, ds.train_r, params.batch_size,
            ds.n_users, ds.n_items, seed=cfg.seed, dtype=dtype,
            grad_mode=gm)
        arrays = (data.ul, data.ib, data.rb, data.wu, data.wi, data.u_lo)
        decay = jnp.asarray(params.lr_decay, dtype)
        if mesh is not None:
            finals, traj = _sweep_sharded(
                mesh, "sgd", states, lam_v, aux_v,
                (arrays, decay, test_coo), n_epochs,
                tile=data.tile, seed=cfg.seed)
        else:
            finals, traj = _sweep_sgd_program(
                states, lam_v, aux_v, decay, arrays, test_coo, n_epochs,
                data.tile, cfg.seed)
    else:
        dul = device_bucketed(build_bucketed(
            ds.train_u, ds.train_i, ds.train_r, ds.n_users, ds.n_items,
            cfg.data.chunk_len, params.rank,
            max_groups=cfg.data.max_groups), dtype)
        dil = device_bucketed(build_bucketed(
            ds.train_i, ds.train_u, ds.train_r, ds.n_items, ds.n_users,
            cfg.data.chunk_len, params.rank,
            max_groups=cfg.data.max_groups), dtype)
        bf16 = params.gather_dtype == "bfloat16"
        if mesh is not None:
            finals, traj = _sweep_sharded(
                mesh, "als", states, lam_v, aux_v, (dul, dil, test_coo),
                n_epochs, implicit=implicit, gather_bf16=bf16)
        else:
            finals, traj = _sweep_program(states, lam_v, aux_v, dul, dil,
                                          test_coo, n_epochs, implicit,
                                          bf16)
    traj = np.asarray(traj, np.float64)[:len(grid)]  # [S, E], pads dropped

    board = []
    for s, (lam, aux_val, seed) in enumerate(grid):
        if is_bpr:
            # the trajectory is held-out pairwise AUC (higher = better)
            entry = {"lam": lam, "lr": aux_val, "seed": seed,
                     "auc": [round(float(x), 6) for x in traj[s]],
                     "auc_final": round(float(traj[s, -1]), 6),
                     "best_epoch": int(np.argmax(traj[s])) + 1}
        else:
            entry = {"lam": lam, "seed": seed,
                     "rmse": [round(float(x), 6) for x in traj[s]],
                     "rmse_final": round(float(traj[s, -1]), 6),
                     "best_epoch": int(np.argmin(traj[s])) + 1}
        if is_sgd:
            entry["lr"] = aux_val
        if implicit or is_bpr:
            from ycnr_tpu.eval.ranking import hit_rate_at_n

            if implicit:
                entry["alpha"] = aux_val
            entry["hit_rate"] = round(hit_rate_at_n(
                _pick_state(finals, s), ds.train_u, ds.train_i,
                ds.test_u, ds.test_i, n=cfg.topn, max_users=512), 4)
        board.append(entry)
    board.sort(key=(lambda e: -e["hit_rate"]) if (implicit or is_bpr)
               else (lambda e: e["rmse_final"]))
    best = board[0]
    pos = next(s for s, (lam, aux_val, seed) in enumerate(grid)
               if lam == best["lam"] and seed == best["seed"]
               and aux_val == best.get("alpha", best.get("lr", 0.0)))
    return TuneResult(leaderboard=board, best=best,
                      best_state=_pick_state(finals, pos), dataset=ds)
