"""Unified training driver (the reference EmfMaster role, SURVEY.md C2).

Runs any of the three algorithm families from a RunConfig, single-chip or
over a mesh, with per-epoch held-out RMSE, JSONL metrics, and checkpointing
with resume — the reference's train loop (stream -> epochs -> RMSE log),
minus the worker fork/IPC machinery.
"""

from __future__ import annotations

import json
import os
import sys
import time
from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ycnr_tpu.config import RunConfig
from ycnr_tpu.data.dataset import Dataset, load_dataset
from ycnr_tpu.models.base import (
    MFState,
    grow_state,
    init_state,
    rmse_padded_jit,
    zero_cold_entities,
)
from ycnr_tpu.models.sgd import BiasedSGD, prepare_sgd_data
from ycnr_tpu.train.checkpoint import config_dict, load_checkpoint, save_checkpoint
from ycnr_tpu.train.metrics import MetricsLogger


# below this the layout packs in seconds and warming would only add a
# throwaway epoch execution; tests patch it to 0 (and ops can force it
# either way via the env var) to exercise the path
_WARM_MIN_NNZ = int(os.environ.get("YCNR_WARM_MIN_NNZ", 2_000_000))


@dataclass
class TrainResult:
    state: MFState
    dataset: Dataset
    rmse_history: list
    out_dir: Optional[str]


def _algo_params(cfg: RunConfig):
    return {"als": cfg.als, "sgd": cfg.sgd, "ials": cfg.ials,
            "bpr": cfg.bpr}[cfg.algorithm]


def _early_stop(cfg: RunConfig, history: list, metrics, epoch: int) -> bool:
    """True when the last `patience` epochs brought no improvement of at
    least min_delta over the best RMSE before them. Checkpoints carry the
    RMSE history (manifest extra), so a resumed run's window spans the
    WHOLE trajectory, not just post-resume epochs."""
    p = cfg.early_stop_patience
    if p <= 0 or len(history) <= p:
        return False
    if min(history[-p:]) > min(history[:-p]) - cfg.early_stop_min_delta:
        metrics.log(event="early_stop", epoch=epoch,
                    best_rmse=round(min(history), 6))
        return True
    return False


def _ckpt_extra(history: list) -> dict:
    """Manifest payload that lets a resumed run continue its early-stop
    window where it left off."""
    return {"rmse_history": [round(float(x), 6) for x in history]}


def _resumed_history(manifest) -> list:
    return list(manifest.get("extra", {}).get("rmse_history", []))


def _start_state(cfg: RunConfig, ds: Dataset, params, resume, warm_start,
                 metrics, mu: float, dtype):
    """(state, start_epoch, rmse_history) for all three train paths.

    resume = continue the SAME run (epoch counter + early-stop history carry
    over); warm_start = start a NEW run from a previous run's factors, grown
    to the current dataset's catalog (models/base.grow_state) — the
    retrain-after-new-ratings lifecycle the reference gets implicitly from
    re-streaming its database."""
    if resume and warm_start:
        raise ValueError("resume and warm_start are mutually exclusive: "
                         "resume continues a run, warm_start begins a new "
                         "one from its factors")
    if resume:
        state, manifest = load_checkpoint(resume)
        metrics.log(event="resume", epoch=manifest["epoch"])
        return state, manifest["epoch"], _resumed_history(manifest)
    if warm_start:
        state, manifest = load_checkpoint(warm_start)
        if manifest["rank"] != params.rank:
            raise ValueError(
                f"warm-start checkpoint rank {manifest['rank']} != config "
                f"rank {params.rank} (factor growth is catalog-only)")
        state = grow_state(state, ds.n_users, ds.n_items, seed=cfg.seed)
        metrics.log(event="warm_start", from_epoch=manifest["epoch"],
                    new_users=ds.n_users - manifest["n_users"],
                    new_items=ds.n_items - manifest["n_items"])
        return state, 0, []
    return init_state(ds.n_users, ds.n_items, params.rank, seed=cfg.seed,
                      mu=mu, dtype=dtype), 0, []


def _shm_writer(cfg: RunConfig, state: MFState):
    """Optional live-factor publisher (reference C6c shm serving pattern)."""
    if not cfg.publish_shm:
        return None
    from ycnr_tpu.serve.shm import FactorShmWriter

    return FactorShmWriter(cfg.publish_shm, state.n_users, state.n_items,
                           state.rank)


def train(cfg: RunConfig, dataset: Optional[Dataset] = None,
          resume: Optional[str] = None, warm_start: Optional[str] = None,
          out_dir: Optional[str] = None) -> TrainResult:
    """Train per config. If cfg.mesh.n_shards > 1, runs the sharded path."""
    params = _algo_params(cfg)
    ds = dataset or load_dataset(cfg.data, rank_hint=params.rank)
    out = out_dir if out_dir is not None else (
        os.path.join(cfg.out_dir, cfg.name) if cfg.out_dir else None)
    metrics = MetricsLogger(os.path.join(out, "metrics.jsonl") if out else None,
                            append=bool(resume))

    if cfg.ooc and cfg.ooc_wire not in ("rect", "packed"):
        raise ValueError(f"ooc_wire must be 'rect' or 'packed', got "
                         f"{cfg.ooc_wire!r}")
    if cfg.ooc and cfg.ooc_residency not in ("auto", "device", "host"):
        raise ValueError(f"ooc_residency must be 'auto', 'device' or "
                         f"'host', got {cfg.ooc_residency!r}")
    if cfg.mesh.n_shards > 1:
        if cfg.ooc and cfg.algorithm not in ("als", "ials"):
            raise ValueError(
                "ooc=True on a mesh supports als/ials (mode-A wire "
                "sharding, parallel/ooc_mesh.py); sgd/bpr stream-OOC "
                "is single-chip")
        if cfg.ooc and cfg.mesh.vstep_mode == "item_sharded":
            raise ValueError("ooc=True shards the wire mode-A "
                             "(gram_psum); item_sharded is resident-only")
        return _train_sharded(cfg, ds, metrics, out, resume, warm_start)

    dtype = jnp.dtype(params.dtype)
    mu = ds.mu if cfg.algorithm == "sgd" else 0.0
    state, start_epoch, history = _start_state(
        cfg, ds, params, resume, warm_start, metrics, mu, dtype)
    state = zero_cold_entities(state, ds.train_u, ds.train_i)

    pu, pi, pr, n_test = ds.padded_test()
    dpu, dpi, dpr = jnp.asarray(pu), jnp.asarray(pi), jnp.asarray(pr)
    if cfg.log_train_rmse and cfg.algorithm != "bpr":
        from ycnr_tpu.ops.layout import pad_coo

        qu, qi, qr, n_train = pad_coo(ds.train_u, ds.train_i, ds.train_r,
                                      ds.n_users, ds.n_items)
        dqu, dqi, dqr = jnp.asarray(qu), jnp.asarray(qi), jnp.asarray(qr)

    dul = dil = sgd_data = trainer = None
    warm = None
    if (cfg.algorithm in ("als", "ials") and not cfg.ooc
            and len(ds.train_r) >= _WARM_MIN_NNZ):
        # the epoch program's argument SHAPES follow from one bincount,
        # so its compile can run on zero-filled layouts in a background
        # thread WHILE the host packs the real layout below — the jit
        # cache key is shapes, so the warmed executable is the one the
        # real first epoch reuses
        warm = _warm_epoch_program(
            cfg, ds, params, dtype, start_epoch,
            test_coo=(dpu, dpi, dpr, jnp.asarray(n_test)),
            train_coo=((dqu, dqi, dqr, jnp.asarray(n_train))
                       if cfg.log_train_rmse else None),
            n_test_int=n_test)
    if cfg.algorithm in ("als", "ials"):
        if cfg.ooc:
            # out-of-core: rating layouts in compact wire form
            # (models/ooc.py). packed = minimal bytes (the default —
            # both the host wire and the HBM pin are byte-bound); rect
            # = gather-free device decode for fast local links. Under
            # "auto"/"device" residency, whole groups are pinned in HBM
            # (near-resident epochs, 2.6-3x less HBM than the decoded
            # layout); the remainder streams host->HBM each epoch
            from ycnr_tpu.models.ooc import (auto_wire_budget,
                                             wire_nbytes, wire_to_device)
            from ycnr_tpu.ops.packed import build_packed, build_rect

            build = build_rect if cfg.ooc_wire == "rect" else build_packed
            dul = build(ds.train_u, ds.train_i, ds.train_r,
                        ds.n_users, ds.n_items, params.rank,
                        max_groups=cfg.data.max_groups)
            dil = build(ds.train_i, ds.train_u, ds.train_r,
                        ds.n_items, ds.n_users, params.rank,
                        max_groups=cfg.data.max_groups)
            from ycnr_tpu.models.ooc import PhasePlan

            # writeback plans while the eids are host arrays (pre-pin)
            ooc_plans = (PhasePlan(dul, ds.n_users),
                         PhasePlan(dil, ds.n_items))
            if cfg.ooc_residency != "host":
                from ycnr_tpu.models.ooc import group_resident

                budget = (None if cfg.ooc_residency == "device"
                          else auto_wire_budget(ds.n_users, ds.n_items,
                                                params.rank,
                                                groups=(dul, dil)))
                dul, dil, pinned = wire_to_device(dul, dil, budget)
                streamed = wire_nbytes(
                    [g for g in (*dul, *dil) if not group_resident(g)])
                metrics.log(event="ooc_residency",
                            hbm_pinned_bytes=pinned,
                            streamed_bytes=streamed)
        else:
            # single-chip fast path: bucketed (segsum-free) layout
            from ycnr_tpu.models.bucketed_phase import device_bucketed
            from ycnr_tpu.ops.bucketed import build_bucketed

            from concurrent.futures import ThreadPoolExecutor

            # the two views are independent host builds whose sorts and
            # native packing release the GIL: build them side by side
            with ThreadPoolExecutor(max_workers=2) as pool:
                views = [pool.submit(
                    build_bucketed, e, o, ds.train_r, n_e, n_o,
                    cfg.data.chunk_len, params.rank,
                    max_groups=cfg.data.max_groups)
                    for e, o, n_e, n_o in (
                        (ds.train_u, ds.train_i, ds.n_users, ds.n_items),
                        (ds.train_i, ds.train_u, ds.n_items, ds.n_users))]
                dul, dil = (device_bucketed(v.result(), dtype)
                            for v in views)
    elif cfg.ooc and not (cfg.algorithm == "sgd"
                          and cfg.sgd.method == "stream"):
        raise ValueError("ooc=True supports als/ials and stream-SGD "
                         "(--sgd-method stream); the batched-SGD/BPR "
                         "layouts are per-batch device data")
    elif cfg.algorithm == "bpr":
        from ycnr_tpu.models.bpr import BPRTrainer, prepare_bpr_data

        trainer = BPRTrainer(cfg.bpr.lam, cfg.bpr.lr, cfg.bpr.lr_decay,
                             cfg.bpr.batch_size, seed=cfg.seed,
                             grad_mode=cfg.bpr.grad_mode,
                             shuffle=cfg.bpr.shuffle)
        sgd_data = prepare_bpr_data(
            ds.train_u, ds.train_i, cfg.bpr.batch_size, ds.n_users,
            ds.n_items,
            # composition seed is FIXED (0, matching the sharded
            # builder): any random partition works, and keeping it
            # config-independent lets tune's grid entries reproduce as
            # standalone runs at any {seed}
            shuffle_rows_seed=(0 if cfg.bpr.shuffle == "batches"
                               else None))
    elif cfg.sgd.method == "stream":
        from ycnr_tpu.models.sgd_stream import StreamSGD, prepare_stream_sgd

        # stream order concentrates a user's ratings, the case "sum"
        # diverges on (models/sgd.py docstring) — "capped" reproduces the
        # shuffled path's effective step sizes safely (sgd_stream.py)
        gm = "capped" if cfg.sgd.grad_mode == "sum" else cfg.sgd.grad_mode
        trainer = StreamSGD(cfg.sgd.lam, cfg.sgd.lr, cfg.sgd.lr_decay,
                            seed=cfg.seed, grad_mode=gm)
        # ooc: the stream stays on host (numpy); StreamSGD.epoch routes
        # it through the chunked-device_put OOC epoch (sgd_stream.py)
        sgd_data, _ = prepare_stream_sgd(
            ds.train_u, ds.train_i, ds.train_r, cfg.sgd.batch_size,
            ds.n_users, ds.n_items, seed=cfg.seed, dtype=dtype,
            grad_mode=gm, device=not cfg.ooc)
        if cfg.ooc:
            # compact wire (ops/sgd_wire.py): 5-9 B/rating vs the flat
            # stream's 20. Residency policy mirrors the ALS wire: pin
            # whole in HBM when it fits the budget (near-resident
            # epochs), stream permuted chunks from host otherwise.
            from ycnr_tpu.ops.sgd_wire import (compact_from_stream,
                                               compact_resident,
                                               put_compact,
                                               sgd_wire_budget)
            try:
                comp = compact_from_stream(sgd_data, ds.n_items)
            except ValueError as e:
                # layout can't encode compactly (batch beyond u16,
                # f64 ratings off the f32 wire) -> flat host stream
                metrics.log(event="sgd_wire_fallback", reason=str(e))
            else:
                # byte count from the HOST wire: CompactStreamSGD.nbytes
                # on a pinned wire copies every array device->host (a
                # multi-GB fetch) just to count
                wire_bytes = comp.nbytes
                if cfg.ooc_residency != "host":
                    budget = (None if cfg.ooc_residency == "device"
                              else sgd_wire_budget(ds.n_users, ds.n_items,
                                                   params.rank))
                    if budget is None or wire_bytes <= budget:
                        comp = put_compact(comp)
                metrics.log(event="sgd_wire", format="compact",
                            wire_bytes=wire_bytes,
                            hbm_pinned=compact_resident(comp))
                sgd_data = comp
    else:
        trainer = BiasedSGD(cfg.sgd.lam, cfg.sgd.lr, cfg.sgd.lr_decay,
                            cfg.sgd.batch_size, seed=cfg.seed,
                            grad_mode=cfg.sgd.grad_mode)
        sgd_data = prepare_sgd_data(ds.train_u, ds.train_i, ds.train_r,
                                    cfg.sgd.batch_size, ds.n_users,
                                    ds.n_items, dtype)

    from ycnr_tpu.models.bucketed_phase import (
        als_epoch_bucketed,
        ials_epoch_bucketed,
    )

    if warm is not None:
        _join_warm(warm, dul, dil, metrics)

    shm_writer = _shm_writer(cfg, state)
    if cfg.fused_epochs > 1 and cfg.algorithm in ("als", "ials") \
            and not cfg.ooc:
        test_coo = (dpu, dpi, dpr, jnp.asarray(n_test))
        train_coo = ((dqu, dqi, dqr, jnp.asarray(n_train))
                     if cfg.log_train_rmse else None)
        state = _fused_epoch_blocks(cfg, ds, params, state, start_epoch,
                                    history, dul, dil, test_coo, train_coo,
                                    metrics, shm_writer, out)
        epochs_done = params.epochs  # fused blocks ran everything
    else:
        epochs_done = start_epoch
    for epoch in range(epochs_done, params.epochs):
        if epoch == epochs_done:
            # the first step compiles the epoch program, which can take a
            # while at scale; say so instead of sitting silent
            print(json.dumps({"event": "first_epoch",
                              "note": "compiling epoch program; "
                                      "later epochs run at steady speed"}),
                  file=sys.stderr, flush=True)
        t0 = time.time()
        if cfg.algorithm == "als":
            if cfg.ooc:
                from ycnr_tpu.models.ooc import als_epoch_ooc

                state = als_epoch_ooc(
                    state, dul, dil, cfg.als.lam,
                    gather_bf16=cfg.als.gather_dtype == "bfloat16",
                    u_plan=ooc_plans[0], i_plan=ooc_plans[1])
            else:
                state = als_epoch_bucketed(
                    state, dul, dil, cfg.als.lam,
                    gather_bf16=cfg.als.gather_dtype == "bfloat16")
        elif cfg.algorithm == "ials":
            if cfg.ooc:
                from ycnr_tpu.models.ooc import ials_epoch_ooc

                state = ials_epoch_ooc(
                    state, dul, dil, cfg.ials.lam, cfg.ials.alpha,
                    gather_bf16=cfg.ials.gather_dtype == "bfloat16",
                    u_plan=ooc_plans[0], i_plan=ooc_plans[1])
            else:
                state = ials_epoch_bucketed(
                    state, dul, dil, cfg.ials.lam, cfg.ials.alpha,
                    gather_bf16=cfg.ials.gather_dtype == "bfloat16")
        else:
            state = trainer.epoch(state, sgd_data, epoch)
        jax.block_until_ready(state)
        epoch_s = time.time() - t0
        if cfg.algorithm == "bpr":
            # BPR scores are unscaled ranking logits — RMSE vs ratings is
            # meaningless; the per-epoch quality metric (and the early-stop
            # history) is 1 - hit-rate@N (lower = better, like RMSE)
            from ycnr_tpu.eval.ranking import hit_rate_at_n

            hr = hit_rate_at_n(state, ds.train_u, ds.train_i, ds.test_u,
                               ds.test_i, n=cfg.topn, max_users=512)
            history.append(1.0 - hr)
            record = dict(epoch=epoch + 1, hit_rate=round(hr, 4),
                          epoch_s=round(epoch_s, 4), algo="bpr")
        else:
            rmse = float(rmse_padded_jit(state, dpu, dpi, dpr, n_test))
            history.append(rmse)
            record = dict(epoch=epoch + 1, rmse_test=round(rmse, 6),
                          epoch_s=round(epoch_s, 4), algo=cfg.algorithm)
            if cfg.log_train_rmse:
                record["rmse_train"] = round(
                    float(rmse_padded_jit(state, dqu, dqi, dqr, n_train)), 6)
            if cfg.algorithm == "ials" or cfg.log_hit_rate:
                # RMSE vs raw ratings is not meaningful for preference
                # scores (and log_hit_rate asks for ranking quality from
                # the explicit trainers too); report the ranking metric
                from ycnr_tpu.eval.ranking import hit_rate_at_n

                record["hit_rate"] = round(hit_rate_at_n(
                    state, ds.train_u, ds.train_i, ds.test_u, ds.test_i,
                    n=cfg.topn, max_users=512), 4)
        metrics.log(**record)
        stop = _early_stop(cfg, history, metrics, epoch + 1)
        if out and cfg.checkpoint_every and (
                (epoch + 1) % cfg.checkpoint_every == 0
                or epoch + 1 == params.epochs or stop):
            save_checkpoint(os.path.join(out, "ckpt"), state, epoch + 1,
                            config=config_dict(cfg),
                            extra=_ckpt_extra(history),
                            backend=cfg.checkpoint_backend)
        if shm_writer is not None:
            shm_writer.publish(state, epoch + 1)
        if stop:
            break
    if shm_writer is not None:
        shm_writer.close()
    if (cfg.algorithm in ("ials", "bpr") or cfg.log_hit_rate) and history:
        # final full ranking suite for the implicit models (per-epoch
        # records carry only the cheap hit-rate)
        from ycnr_tpu.eval.ranking import ranking_metrics_at_n

        metrics.log(event="ranking", **ranking_metrics_at_n(
            state, ds.train_u, ds.train_i, ds.test_u, ds.test_i,
            n=cfg.topn, max_users=2048))
    if cfg.measure_serving:
        _log_serving_metric(cfg, ds, state, metrics)
    return TrainResult(state=state, dataset=ds, rmse_history=history,
                       out_dir=out)


class _WarmHandle:
    """Background compile of the epoch program.

    Holds the thread plus what the mismatch check needs: the geometry the
    dummy layouts were built from. err carries a failed warm's exception —
    warming is best-effort; the real first epoch then compiles as
    before, nothing is lost but the overlap."""

    def __init__(self, thread, geo_u, geo_i, t0):
        self.thread = thread
        self.geo_u = geo_u
        self.geo_i = geo_i
        self.t0 = t0
        self.err = None


def _warm_epoch_program(cfg, ds, params, dtype, start_epoch, test_coo,
                        train_coo, n_test_int):
    """Start compiling the ALS/iALS epoch program on zero-filled layouts
    of the REAL layout's shapes, in a thread, so the compile overlaps the
    host-side layout pack instead of following it."""
    import threading

    from ycnr_tpu.models.bucketed_phase import (
        als_epoch_bucketed,
        als_epochs_bucketed,
        ials_epoch_bucketed,
        ials_epochs_bucketed,
        zero_bucketed,
    )
    from ycnr_tpu.ops.bucketed import bucketed_geometry

    cu = np.bincount(np.asarray(ds.train_u), minlength=ds.n_users)
    ci = np.bincount(np.asarray(ds.train_i), minlength=ds.n_items)
    geo_u = bucketed_geometry(cu, params.rank,
                              max_groups=cfg.data.max_groups)
    geo_i = bucketed_geometry(ci, params.rank,
                              max_groups=cfg.data.max_groups)
    bf16 = params.gather_dtype == "bfloat16"
    fused_k = 0
    if cfg.fused_epochs > 1:
        fused_k = min(cfg.fused_epochs, params.epochs - start_epoch)
    handle = _WarmHandle(None, geo_u, geo_i, time.time())

    def run():
        try:
            zu = zero_bucketed(geo_u, ds.n_users, ds.n_items, dtype)
            zi = zero_bucketed(geo_i, ds.n_items, ds.n_users, dtype)
            st = init_state(ds.n_users, ds.n_items, params.rank,
                            seed=cfg.seed, dtype=dtype)
            if fused_k > 1:
                if cfg.algorithm == "als":
                    st, _ = als_epochs_bucketed(st, zu, zi, cfg.als.lam,
                                                fused_k, test_coo,
                                                train_coo, gather_bf16=bf16)
                else:
                    st, _ = ials_epochs_bucketed(
                        st, zu, zi, cfg.ials.lam, cfg.ials.alpha, fused_k,
                        test_coo, train_coo, gather_bf16=bf16)
            else:
                if cfg.algorithm == "als":
                    st = als_epoch_bucketed(st, zu, zi, cfg.als.lam,
                                            gather_bf16=bf16)
                else:
                    st = ials_epoch_bucketed(st, zu, zi, cfg.ials.lam,
                                             cfg.ials.alpha,
                                             gather_bf16=bf16)
                # the per-epoch RMSE program is a second (small) compile;
                # n_test passes as a plain int to hit the SAME jit key as
                # the epoch loop's call (weak-typed scalar)
                rmse_padded_jit(st, test_coo[0], test_coo[1], test_coo[2],
                                n_test_int)
            jax.block_until_ready(st)
        except Exception as e:  # pragma: no cover - depends on backend
            handle.err = e

    print(json.dumps({"event": "warm_program",
                      "note": "compiling epoch program in the "
                              "background while the layout packs"}),
          file=sys.stderr, flush=True)
    t = threading.Thread(target=run, name="ycnr-warm-program", daemon=True)
    handle.thread = t
    t.start()
    return handle


def _join_warm(warm, dul, dil, metrics):
    """Wait for the warm thread; verify the dummy shapes matched the real
    layout (else the warm compiled a DIFFERENT program and the first epoch
    recompiles — log it, it is a bug in geometry lockstep, not fatal)."""
    warm.thread.join()
    wall = round(time.time() - warm.t0, 1)
    if warm.err is not None:
        metrics.log(event="warm_program_failed", error=str(warm.err),
                    wall_s=wall)
        return
    real_u = [(g.other_idx.shape[2],) + tuple(g.entity_ids.shape)
              for g in dul]
    real_i = [(g.other_idx.shape[2],) + tuple(g.entity_ids.shape)
              for g in dil]
    want_u = [(R, nb, ne_b) for R, nb, ne_b in warm.geo_u]
    want_i = [(R, nb, ne_b) for R, nb, ne_b in warm.geo_i]
    ok = real_u == want_u and real_i == want_i
    metrics.log(event="warm_program_done", wall_s=wall, shapes_match=ok)
    if not ok:
        print(json.dumps({"event": "warm_shape_mismatch",
                          "note": "bucketed_geometry disagreed with "
                                  "build_bucketed; first epoch recompiles"}),
              file=sys.stderr, flush=True)


def _fused_epoch_blocks(cfg, ds, params, state, start_epoch, history,
                        dul, dil, test_coo, train_coo, metrics, shm_writer,
                        out):
    """Run epochs in fused blocks of cfg.fused_epochs (single-chip ALS/iALS).

    Each block is ONE device program (models/bucketed_phase.
    als_epochs_bucketed): k solve sweeps + k RMSE evals, one dispatch, one
    sync — the per-dispatch host roundtrip is paid once per block instead of
    twice per epoch. Per-epoch metrics records still come out (epoch_s =
    block wall / k); checkpoints, shm publishes, the iALS hit-rate, and the
    early-stop check land at block boundaries. Appends to `history` in
    place and returns the final state."""
    from ycnr_tpu.models.bucketed_phase import (
        als_epochs_bucketed,
        ials_epochs_bucketed,
    )

    p = cfg.als if cfg.algorithm == "als" else cfg.ials
    bf16 = p.gather_dtype == "bfloat16"
    print(json.dumps({"event": "first_epoch",
                      "note": f"compiling fused "
                              f"{cfg.fused_epochs}-epoch program; later "
                              f"blocks run at steady speed"}),
          file=sys.stderr, flush=True)
    epoch = start_epoch
    while epoch < params.epochs:
        k = min(cfg.fused_epochs, params.epochs - epoch)
        t0 = time.time()
        if cfg.algorithm == "als":
            state, (rt, rq) = als_epochs_bucketed(
                state, dul, dil, cfg.als.lam, k, test_coo, train_coo,
                gather_bf16=bf16)
        else:
            state, (rt, rq) = ials_epochs_bucketed(
                state, dul, dil, cfg.ials.lam, cfg.ials.alpha, k, test_coo,
                train_coo, gather_bf16=bf16)
        jax.block_until_ready(state)
        per_epoch_s = (time.time() - t0) / k
        rt = np.asarray(rt)
        rq = np.asarray(rq) if train_coo is not None else None
        for j in range(k):
            history.append(float(rt[j]))
            record = dict(epoch=epoch + j + 1,
                          rmse_test=round(float(rt[j]), 6),
                          epoch_s=round(per_epoch_s, 4), algo=cfg.algorithm,
                          fused=k)
            if rq is not None:
                record["rmse_train"] = round(float(rq[j]), 6)
            if cfg.algorithm == "ials" and j == k - 1:
                # only the block's final state exists on host; earlier
                # epochs' hit-rates are not recoverable from a fused block
                from ycnr_tpu.eval.ranking import hit_rate_at_n

                record["hit_rate"] = round(hit_rate_at_n(
                    state, ds.train_u, ds.train_i, ds.test_u, ds.test_i,
                    n=cfg.topn, max_users=512), 4)
            metrics.log(**record)
        epoch += k
        stop = _early_stop(cfg, history, metrics, epoch)
        if out and cfg.checkpoint_every and (
                epoch % cfg.checkpoint_every == 0
                or epoch == params.epochs or stop):
            save_checkpoint(os.path.join(out, "ckpt"), state, epoch,
                            config=config_dict(cfg),
                            extra=_ckpt_extra(history),
                            backend=cfg.checkpoint_backend)
        if shm_writer is not None:
            shm_writer.publish(state, epoch)
        if stop:
            break
    return state


def _time_serving(call):
    """Shared serving-timing protocol: one call to compile/warm, sync, then
    time a second call with a device sync. Inputs must already live on
    device — a host array in `call`'s closure would put its transfer inside
    the timed window."""
    jax.block_until_ready(call())
    t0 = time.time()
    jax.block_until_ready(call())
    return max(time.time() - t0, 1e-9)


def _log_serving_metric(cfg, ds, state, metrics, **extra):
    """Time top-N for all rated users on device (BASELINE.json:2's
    'top-10 recs/sec' metric), logged as the run's final record."""
    from ycnr_tpu.eval.recommend import _topn_blocks, build_rated_bits
    from ycnr_tpu.models.base import device_layout

    dlay = device_layout(ds.user_layout, state.U.dtype)
    bits = jnp.asarray(build_rated_bits(ds.user_layout, ds.n_items))
    n_served = int((np.asarray(ds.user_layout.entity_ids)
                    < ds.n_users).sum())
    dt = _time_serving(lambda: _topn_blocks(state, dlay, cfg.topn, bits)[1])
    metrics.log(event="serving", users=n_served, topn=cfg.topn,
                serve_s=round(dt, 4),
                recs_per_s=round(n_served / dt, 1), **extra)


def _train_sharded(cfg: RunConfig, ds: Dataset, metrics: MetricsLogger,
                   out: Optional[str], resume: Optional[str],
                   warm_start: Optional[str] = None) -> TrainResult:
    from ycnr_tpu.parallel import (
        build_bpr_bits,
        build_sharded_data,
        gather_state,
        make_mesh,
        scatter_state,
        sharded_als_epoch,
        sharded_bpr_epoch,
        sharded_ials_epoch,
        sharded_rmse,
        sharded_sgd_epoch,
    )

    params = _algo_params(cfg)
    dtype = jnp.dtype(params.dtype)
    D = cfg.mesh.n_shards
    mesh = make_mesh(D, cfg.mesh.axis)
    mu = ds.mu if cfg.algorithm == "sgd" else 0.0

    # item_sharded mode: both factor axes sharded, all-gather the other side
    # (SURVEY.md M6 alternative; ALS/iALS only — SGD needs replicated V)
    if (cfg.mesh.vstep_mode == "item_sharded"
            and cfg.algorithm in ("als", "ials")):
        return _train_dual(cfg, ds, metrics, out, resume, warm_start, mesh,
                           params, dtype)
    if cfg.ooc:
        return _train_sharded_ooc(cfg, ds, metrics, out, resume,
                                  warm_start, mesh, params, dtype)
    sgd_stream = cfg.algorithm == "sgd" and cfg.sgd.method == "stream"
    t_build = time.time()
    data, meta = build_sharded_data(
        ds.train_u, ds.train_i, ds.train_r, ds.n_users, ds.n_items, D,
        chunk_len=cfg.data.chunk_len, block_chunks=cfg.data.block_chunks,
        rank_hint=params.rank, test_u=ds.test_u, test_i=ds.test_i,
        test_r=ds.test_r,
        sgd_batch=(cfg.bpr.batch_size if cfg.algorithm == "bpr"
                   else cfg.sgd.batch_size),
        dtype=dtype, mesh=mesh,
        host_user_layout=cfg.measure_serving,
        # the stream path builds its own rating arrays below; skip the
        # shuffled-SGD stream (algo gate leaves placeholders)
        algo="stream-sgd" if sgd_stream else cfg.algorithm)
    metrics.log(event="sharded_data", shards=D,
                build_s=round(time.time() - t_build, 3))
    bpr_bits = None
    if cfg.algorithm == "bpr":
        bpr_bits = build_bpr_bits(ds.train_u, ds.train_i, meta,
                                  batch_size=cfg.bpr.batch_size, mesh=mesh)
    stream_data = None
    if sgd_stream:
        from ycnr_tpu.parallel.sgd_stream import (
            build_sharded_stream_sgd,
            sharded_sgd_stream_epoch,
        )

        gm = "capped" if cfg.sgd.grad_mode == "sum" else cfg.sgd.grad_mode
        stream_data, _ = build_sharded_stream_sgd(
            ds.train_u, ds.train_i, ds.train_r, meta, cfg.sgd.batch_size,
            seed=cfg.seed, dtype=dtype, grad_mode=gm, mesh=mesh)

    gstate, start_epoch, history = _start_state(
        cfg, ds, params, resume, warm_start, metrics, mu, dtype)
    gstate = zero_cold_entities(gstate, ds.train_u, ds.train_i)
    shm_writer = _shm_writer(cfg, gstate)
    st = scatter_state(gstate, meta, mesh)

    gstate = None  # set when the final-epoch checkpoint gathers the state
    key = jax.random.key(cfg.seed)
    for epoch in range(start_epoch, params.epochs):
        t0 = time.time()
        if cfg.algorithm == "als":
            st = sharded_als_epoch(
                mesh, st, data, cfg.als.lam,
                gather_bf16=cfg.als.gather_dtype == "bfloat16")
        elif cfg.algorithm == "ials":
            st = sharded_ials_epoch(
                mesh, st, data, cfg.ials.lam, cfg.ials.alpha,
                gather_bf16=cfg.ials.gather_dtype == "bfloat16")
        elif cfg.algorithm == "bpr":
            lr = cfg.bpr.lr * cfg.bpr.lr_decay**epoch
            st = sharded_bpr_epoch(mesh, st, data, bpr_bits, cfg.bpr.lam,
                                   lr, jax.random.fold_in(key, epoch),
                                   cfg.bpr.batch_size,
                                   grad_mode=cfg.bpr.grad_mode,
                                   shuffle=cfg.bpr.shuffle)
        elif stream_data is not None:
            lr = cfg.sgd.lr * cfg.sgd.lr_decay**epoch
            st = sharded_sgd_stream_epoch(mesh, st, stream_data,
                                          cfg.sgd.lam, lr,
                                          jax.random.fold_in(key, epoch))
        else:
            lr = cfg.sgd.lr * cfg.sgd.lr_decay**epoch
            st = sharded_sgd_epoch(mesh, st, data, cfg.sgd.lam, lr,
                                   jax.random.fold_in(key, epoch),
                                   cfg.sgd.batch_size)
        jax.block_until_ready(st)
        epoch_s = time.time() - t0
        gstate = None  # one gather per epoch, reused by metric/ckpt/shm
        if cfg.algorithm == "bpr":
            # ranking logits have no RMSE (single-chip path, same rule):
            # gather the factors and track 1 - hit-rate@N
            from ycnr_tpu.eval.ranking import hit_rate_at_n

            gstate = gather_state(st, meta)
            hr = hit_rate_at_n(gstate, ds.train_u,
                               ds.train_i, ds.test_u, ds.test_i,
                               n=cfg.topn, max_users=512)
            history.append(1.0 - hr)
            metrics.log(epoch=epoch + 1, hit_rate=round(hr, 4),
                        epoch_s=round(epoch_s, 4), algo="bpr", shards=D)
        else:
            rmse = sharded_rmse(mesh, st, data, meta.test_n)
            history.append(rmse)
            metrics.log(epoch=epoch + 1, rmse_test=round(rmse, 6),
                        epoch_s=round(epoch_s, 4), algo=cfg.algorithm,
                        shards=D)
        stop = _early_stop(cfg, history, metrics, epoch + 1)
        if out and cfg.checkpoint_every and (
                (epoch + 1) % cfg.checkpoint_every == 0
                or epoch + 1 == params.epochs or stop):
            if gstate is None:  # reused for TrainResult below
                gstate = gather_state(st, meta)
            save_checkpoint(os.path.join(out, "ckpt"), gstate, epoch + 1,
                            config=config_dict(cfg),
                            extra=_ckpt_extra(history),
                            backend=cfg.checkpoint_backend)
        if shm_writer is not None:
            # publishing needs the host-gathered state; reuse the
            # checkpoint gather when it happened this epoch
            shm_writer.publish(gstate if gstate is not None
                               else gather_state(st, meta), epoch + 1)
        if stop:
            break
    if shm_writer is not None:
        shm_writer.close()
    if cfg.measure_serving:
        _log_serving_metric_sharded(cfg, ds, st, data, meta, mesh, metrics)
    if gstate is None:
        gstate = gather_state(st, meta)
    return TrainResult(state=gstate, dataset=ds,
                       rmse_history=history, out_dir=out)


def _train_sharded_ooc(cfg: RunConfig, ds: Dataset, metrics: MetricsLogger,
                       out: Optional[str], resume: Optional[str],
                       warm_start: Optional[str], mesh, params,
                       dtype) -> TrainResult:
    """Mode-A sharded training from the OOC wire format: the user-view
    wire sliced block-contiguously across shards, per-shard item-view
    wires, item-Gram psum over NVLink (parallel/ooc_mesh.py). HBM per chip
    holds factors + 1/D of the wire — the mesh analog of the single-chip
    pinned tier (docs/SCALING.md "OOC x mesh")."""
    from ycnr_tpu.parallel import gather_state, scatter_state, sharded_rmse
    from ycnr_tpu.parallel.ooc_mesh import (build_sharded_wire,
                                            make_sharded_ooc_epoch,
                                            put_sharded_wire)
    from ycnr_tpu.parallel.shard import ShardedData, _stack_ragged

    D = cfg.mesh.n_shards
    sw, meta = build_sharded_wire(
        ds.train_u, ds.train_i, ds.train_r, ds.n_users, ds.n_items, D,
        rank_hint=params.rank, max_groups=cfg.data.max_groups, mesh=None)
    sw = put_sharded_wire(sw, mesh)
    metrics.log(event="ooc_residency", mesh_shards=D,
                hbm_pinned_bytes=sum(
                    np.asarray(getattr(g, n)).nbytes
                    for gr in (sw.ugroups, sw.igroups) for g in gr
                    for n in ("lo", "hi_pos", "hi_val", "rat", "cnt",
                              "eid")) // D,
                streamed_bytes=0)

    # held-out rows through the wire membership (cold users own sentinel
    # rows, so their predictions are exactly 0, as on one chip)
    shard_of = (meta.user_local // meta.upd).astype(np.int64)
    local_of = (meta.user_local % meta.upd).astype(np.int64)
    tper = [np.nonzero(shard_of[ds.test_u] == d)[0] for d in range(D)]
    tu, ti, tr = _stack_ragged(
        [(local_of[ds.test_u[p]], ds.test_i[p], ds.test_r[p])
         for p in tper], pads=(meta.upd, ds.n_items, 0.0))
    meta.test_n = len(ds.test_r)
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ycnr_tpu.parallel.mesh import AXIS

    sh = NamedSharding(mesh, P(AXIS))
    data = ShardedData(
        user_layout=None, item_layout=None, item_deg=sw.item_deg,
        sgd_u=jnp.zeros((D, 8), jnp.int32),
        sgd_i=jnp.zeros((D, 8), jnp.int32),
        sgd_r=jnp.zeros((D, 8), dtype),
        test_u=jax.device_put(tu, sh), test_i=jax.device_put(ti, sh),
        test_r=jax.device_put(tr, sh))

    gstate, start_epoch, history = _start_state(
        cfg, ds, params, resume, warm_start, metrics, 0.0, dtype)
    gstate = zero_cold_entities(gstate, ds.train_u, ds.train_i)
    shm_writer = _shm_writer(cfg, gstate)
    st = scatter_state(gstate, meta, mesh)
    gstate = None

    alpha = cfg.ials.alpha if cfg.algorithm == "ials" else None
    lam = cfg.ials.lam if cfg.algorithm == "ials" else cfg.als.lam
    gb = (cfg.ials if cfg.algorithm == "ials"
          else cfg.als).gather_dtype == "bfloat16"
    epoch_fn = make_sharded_ooc_epoch(mesh, sw, float(lam), alpha=alpha,
                                      gather_bf16=gb, dtype=dtype)
    for epoch in range(start_epoch, params.epochs):
        t0 = time.time()
        st = epoch_fn(st)
        jax.block_until_ready(st)
        epoch_s = time.time() - t0
        rmse = sharded_rmse(mesh, st, data, meta.test_n)
        history.append(rmse)
        metrics.log(epoch=epoch + 1, rmse_test=round(rmse, 6),
                    epoch_s=round(epoch_s, 4), algo=cfg.algorithm,
                    shards=D, ooc=True)
        stop = _early_stop(cfg, history, metrics, epoch + 1)
        gstate = None
        if out and cfg.checkpoint_every and (
                (epoch + 1) % cfg.checkpoint_every == 0
                or epoch + 1 == params.epochs or stop):
            gstate = gather_state(st, meta)
            save_checkpoint(os.path.join(out, "ckpt"), gstate, epoch + 1,
                            config=config_dict(cfg),
                            extra=_ckpt_extra(history),
                            backend=cfg.checkpoint_backend)
        if shm_writer is not None:
            shm_writer.publish(gstate if gstate is not None
                               else gather_state(st, meta), epoch + 1)
        if stop:
            break
    if shm_writer is not None:
        shm_writer.close()
    if cfg.measure_serving:
        metrics.log(event="serving_metric_skipped",
                    note="measure_serving needs the resident sharded "
                         "layout; serve from the checkpoint instead")
    if gstate is None:
        gstate = gather_state(st, meta)
    return TrainResult(state=gstate, dataset=ds,
                       rmse_history=history, out_dir=out)


def _log_serving_metric_sharded(cfg, ds, st, data, meta, mesh, metrics):
    """Top-N for every rated user ON the mesh (BASELINE config 5: 'full
    top-N serving over the mesh'), via the rated-bits fast path."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ycnr_tpu.eval.recommend import build_rated_bits
    from ycnr_tpu.parallel.mesh import AXIS
    from ycnr_tpu.parallel.shard import _topn_fn

    # commit the bits to their mesh sharding BEFORE timing, or the timed
    # call would include the host->device transfer (~1 GB at netflix scale)
    bits = jax.device_put(build_rated_bits(meta.user_layout_host, ds.n_items),
                          NamedSharding(mesh, P(AXIS)))
    n_served = int((np.asarray(meta.user_layout_host.entity_ids)
                    < meta.upd).sum())
    fn = _topn_fn(mesh, cfg.topn, True)
    dt = _time_serving(lambda: fn(st.U, st.bu, st.V, st.bi, st.mu,
                                  data.user_layout, bits)[1])
    metrics.log(event="serving", users=n_served, topn=cfg.topn,
                shards=meta.n_shards, mode="mesh",
                serve_s=round(dt, 4), recs_per_s=round(n_served / dt, 1))


def _train_dual(cfg: RunConfig, ds: Dataset, metrics: MetricsLogger,
                out: Optional[str], resume: Optional[str],
                warm_start: Optional[str], mesh, params,
                dtype) -> TrainResult:
    from ycnr_tpu.parallel.dual import (
        build_dual_sharded_data,
        dual_als_epoch,
        dual_gather_state,
        dual_ials_epoch,
        dual_rmse,
        dual_scatter_state,
    )

    data, meta = build_dual_sharded_data(
        ds.train_u, ds.train_i, ds.train_r, ds.n_users, ds.n_items,
        cfg.mesh.n_shards, chunk_len=cfg.data.chunk_len,
        block_chunks=cfg.data.block_chunks, rank_hint=params.rank,
        test_u=ds.test_u, test_i=ds.test_i, test_r=ds.test_r, dtype=dtype,
        mesh=mesh, host_user_layout=cfg.measure_serving)
    gstate, start_epoch, history = _start_state(
        cfg, ds, params, resume, warm_start, metrics, 0.0, dtype)
    gstate = zero_cold_entities(gstate, ds.train_u, ds.train_i)
    shm_writer = _shm_writer(cfg, gstate)
    st = dual_scatter_state(gstate, meta, mesh)

    gstate = None  # re-gathered per epoch below (checkpoint/publish reuse)
    for epoch in range(start_epoch, params.epochs):
        t0 = time.time()
        if cfg.algorithm == "als":
            st = dual_als_epoch(
                mesh, st, data, cfg.als.lam,
                gather_bf16=cfg.als.gather_dtype == "bfloat16")
        else:
            st = dual_ials_epoch(
                mesh, st, data, cfg.ials.lam, cfg.ials.alpha,
                gather_bf16=cfg.ials.gather_dtype == "bfloat16")
        jax.block_until_ready(st)
        epoch_s = time.time() - t0
        rmse = dual_rmse(mesh, st, data, meta.test_n)
        history.append(rmse)
        metrics.log(epoch=epoch + 1, rmse_test=round(rmse, 6),
                    epoch_s=round(epoch_s, 4), algo=cfg.algorithm,
                    shards=cfg.mesh.n_shards, mode="item_sharded")
        stop = _early_stop(cfg, history, metrics, epoch + 1)
        gstate = None  # gather at most once per epoch (all_gather of U AND V)
        if out and cfg.checkpoint_every and (
                (epoch + 1) % cfg.checkpoint_every == 0
                or epoch + 1 == params.epochs or stop):
            gstate = dual_gather_state(st, meta)
            save_checkpoint(os.path.join(out, "ckpt"), gstate, epoch + 1,
                            config=config_dict(cfg),
                            extra=_ckpt_extra(history),
                            backend=cfg.checkpoint_backend)
        if shm_writer is not None:
            shm_writer.publish(gstate if gstate is not None
                               else dual_gather_state(st, meta), epoch + 1)
        if stop:
            break
    if shm_writer is not None:
        shm_writer.close()
    if gstate is None:
        gstate = dual_gather_state(st, meta)
    if cfg.measure_serving:
        # top-N on the mesh with V still sharded: one V all-gather per call,
        # users scored shard-locally in item-cat space (dual_recommend_all)
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ycnr_tpu.parallel.dual import _dual_topn_fn, dual_rated_bits
        from ycnr_tpu.parallel.mesh import AXIS

        bits = jax.device_put(dual_rated_bits(meta),
                              NamedSharding(mesh, P(AXIS)))
        n_served = int((np.asarray(meta.user_layout_host.entity_ids)
                        < meta.upd).sum())
        fn = _dual_topn_fn(mesh, cfg.topn)
        dt = _time_serving(lambda: fn(st.U, st.V, st.mu,
                                      data.user_layout, bits)[1])
        metrics.log(event="serving", users=n_served, topn=cfg.topn,
                    shards=meta.n_shards, mode="mesh_item_sharded",
                    serve_s=round(dt, 4),
                    recs_per_s=round(n_served / dt, 1))
    return TrainResult(state=gstate, dataset=ds,
                       rmse_history=history, out_dir=out)
