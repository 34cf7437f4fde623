"""End-to-end train() driver: epochs, metrics JSONL, checkpoint, resume."""

import json
import os

import numpy as np

from ycnr_tpu.config import ALSConfig, DataConfig, MeshConfig, RunConfig, SGDConfig
from ycnr_tpu.train.loop import train


def _cfg(tmp_path, algorithm="als", epochs=3, shards=1, **mesh_kw):
    return RunConfig(
        name="t",
        algorithm=algorithm,
        data=DataConfig(source="synthetic", n_users=150, n_items=80,
                        n_ratings=6000, chunk_len=8, seed=1),
        als=ALSConfig(rank=6, lam=0.05, epochs=epochs),
        sgd=SGDConfig(rank=6, lr=0.02, epochs=epochs, batch_size=512),
        mesh=MeshConfig(n_shards=shards, **mesh_kw),
        out_dir=str(tmp_path),
        seed=0,
    )


def test_train_als_with_metrics_and_checkpoint(tmp_path):
    res = train(_cfg(tmp_path))
    assert len(res.rmse_history) == 3
    assert res.rmse_history[-1] < res.rmse_history[0]
    mpath = os.path.join(res.out_dir, "metrics.jsonl")
    records = [json.loads(x) for x in open(mpath)]
    assert [r["epoch"] for r in records] == [1, 2, 3]
    assert all("epoch_s" in r and "rmse_test" in r for r in records)
    assert os.path.exists(os.path.join(res.out_dir, "ckpt", "manifest.json"))


def test_train_resume_continues(tmp_path):
    cfg = _cfg(tmp_path, epochs=2)
    res1 = train(cfg)
    ck = os.path.join(res1.out_dir, "ckpt")
    cfg2 = cfg.replace(als=ALSConfig(rank=6, lam=0.05, epochs=4),
                       out_dir=str(tmp_path / "resumed"))
    res2 = train(cfg2, resume=ck)
    # the checkpoint carries the earlier RMSE history, so the resumed
    # run's trajectory spans ALL four epochs (early-stop windows survive)
    assert len(res2.rmse_history) == 4
    assert res2.rmse_history[:2] == [round(x, 6)
                                     for x in res1.rmse_history]
    # resumed run must beat the checkpointed rmse
    assert res2.rmse_history[-1] <= res1.rmse_history[-1] + 1e-9


def test_train_sgd(tmp_path):
    res = train(_cfg(tmp_path, algorithm="sgd", epochs=4))
    assert np.isfinite(res.rmse_history).all()


def test_train_bpr_resume_retraces(tmp_path):
    """A BPR run resumed from its epoch-2 checkpoint retraces the
    uninterrupted trajectory bitwise: the trainer keys draws on
    seed + 7919*epoch_idx, so epoch 3 is the same draw either way."""
    from ycnr_tpu.config import BPRConfig

    def bcfg(path, epochs):
        c = _cfg(path, algorithm="bpr", epochs=epochs)
        return c.replace(bpr=BPRConfig(rank=6, lam=0.01, lr=0.1,
                                       epochs=epochs, batch_size=512))

    full = train(bcfg(tmp_path / "full", 4))
    short = train(bcfg(tmp_path / "short", 2))
    resumed = train(bcfg(tmp_path / "resumed", 4),
                    resume=os.path.join(short.out_dir, "ckpt"))
    assert len(resumed.rmse_history) == 4  # history spans the resume
    np.testing.assert_array_equal(np.asarray(resumed.state.U),
                                  np.asarray(full.state.U))
    np.testing.assert_array_equal(np.asarray(resumed.state.bi),
                                  np.asarray(full.state.bi))
    # pre-resume entries come back 6dp-rounded from the manifest
    assert [round(x, 6) for x in resumed.rmse_history] == \
        [round(x, 6) for x in full.rmse_history]


def test_train_sharded_both_modes(tmp_path):
    r_gram = train(_cfg(tmp_path / "a", shards=4, vstep_mode="gram_psum"))
    r_dual = train(_cfg(tmp_path / "b", shards=4, vstep_mode="item_sharded"))
    np.testing.assert_allclose(r_gram.rmse_history, r_dual.rmse_history,
                               rtol=1e-5)
    # sharded matches single-chip (blocked vs bucketed paths, fp32)
    r_one = train(_cfg(tmp_path / "c", shards=1))
    np.testing.assert_allclose(r_gram.rmse_history, r_one.rmse_history,
                               rtol=1e-4)


def test_train_fused_epochs_matches_per_epoch(tmp_path):
    """fused_epochs=2 over 5 epochs (one partial tail block) must reproduce
    the per-epoch driver's RMSE history and still checkpoint + log."""
    cfg = _cfg(tmp_path / "seq", epochs=5)
    res_seq = train(cfg)
    cfg_f = _cfg(tmp_path / "fused", epochs=5).replace(fused_epochs=2)
    res_f = train(cfg_f)
    np.testing.assert_allclose(res_f.rmse_history, res_seq.rmse_history,
                               rtol=1e-5)
    records = [json.loads(x) for x in
               open(os.path.join(res_f.out_dir, "metrics.jsonl"))]
    assert [r["epoch"] for r in records] == [1, 2, 3, 4, 5]
    assert all("rmse_train" in r and r.get("fused") in (1, 2)
               for r in records)
    assert os.path.exists(os.path.join(res_f.out_dir, "ckpt",
                                       "manifest.json"))


def test_warm_program_overlap(tmp_path, monkeypatch):
    """The background program warm (compile overlapped with the layout
    pack) must compile
    on shapes that match the real layout bit for bit, and training results
    must be unchanged by it. Covers the plain and fused epoch paths."""
    import ycnr_tpu.train.loop as loop_mod

    base = train(_cfg(tmp_path / "off"))  # warm disabled (nnz below gate)
    monkeypatch.setattr(loop_mod, "_WARM_MIN_NNZ", 0)
    for sub, fused in (("on", 1), ("fused", 3)):
        cfg = _cfg(tmp_path / sub)
        if fused > 1:
            cfg = cfg.replace(fused_epochs=fused)
        res = train(cfg)
        assert np.allclose(res.rmse_history, base.rmse_history, atol=1e-6)
        records = [json.loads(x) for x in
                   open(os.path.join(res.out_dir, "metrics.jsonl"))]
        done = [r for r in records if r.get("event") == "warm_program_done"]
        assert len(done) == 1 and done[0]["shapes_match"] is True
