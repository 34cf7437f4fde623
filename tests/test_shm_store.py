"""Shared-memory factor store (reference C6c shm-typed-array analog).

Covers: create/publish/read roundtrip, epoch staleness peek, hot-reload
through ShmRecommender, and an attach from a REAL second process (the
reference's master-publishes / worker-attaches pattern)."""

import json
import os
import subprocess
import sys
import uuid

import numpy as np
import pytest

from ycnr_tpu.models.base import init_state
from ycnr_tpu.serve.shm import (
    FactorShmReader,
    FactorShmWriter,
    ShmRecommender,
    shm_available,
)

pytestmark = pytest.mark.skipif(
    not shm_available(), reason="native shm library unavailable (no g++?)")


@pytest.fixture
def shm_name():
    name = f"/ycnr_test_{uuid.uuid4().hex[:12]}"
    yield name
    from ycnr_tpu.native import get_shm_lib

    get_shm_lib().ycnr_shm_unlink(name.encode())


def _mk_state(n_users=13, n_items=9, rank=4, seed=3, mu=3.7):
    return init_state(n_users, n_items, rank, seed=seed, mu=mu)


def test_roundtrip(shm_name):
    state = _mk_state()
    with FactorShmWriter(shm_name, 13, 9, 4) as w:
        w.publish(state, epoch=5)
        with FactorShmReader(shm_name) as r:
            assert (r.n_users, r.n_items, r.rank) == (13, 9, 4)
            got, epoch = r.read()
            assert epoch == 5
            np.testing.assert_array_equal(np.asarray(got.U, np.float32),
                                          np.asarray(state.U, np.float32))
            np.testing.assert_array_equal(np.asarray(got.V, np.float32),
                                          np.asarray(state.V, np.float32))
            assert float(got.mu) == pytest.approx(3.7)


def test_epoch_peek_and_republish(shm_name):
    s1, s2 = _mk_state(seed=1), _mk_state(seed=2)
    with FactorShmWriter(shm_name, 13, 9, 4) as w:
        with FactorShmReader(shm_name) as r:
            assert r.epoch() == -2  # nothing published yet
            with pytest.raises(RuntimeError, match="nothing published"):
                r.read()
            w.publish(s1, 1)
            assert r.epoch() == 1
            w.publish(s2, 2)
            assert r.epoch() == 2
            got, e = r.read()
            assert e == 2
            np.testing.assert_array_equal(np.asarray(got.U, np.float32),
                                          np.asarray(s2.U, np.float32))


def test_attach_missing_name():
    with pytest.raises(FileNotFoundError):
        FactorShmReader(f"/ycnr_nope_{uuid.uuid4().hex[:8]}")


def test_shm_recommender_hot_reload(shm_name):
    n_users, n_items, rank = 6, 20, 4
    train_u = np.array([0, 0, 1, 2, 3, 4, 5])
    train_i = np.array([1, 2, 3, 4, 5, 6, 7])
    s1 = _mk_state(n_users, n_items, rank, seed=10, mu=0.0)
    s2 = _mk_state(n_users, n_items, rank, seed=20, mu=0.0)
    with FactorShmWriter(shm_name, n_users, n_items, rank) as w:
        w.publish(s1, 1)
        rec = ShmRecommender(shm_name, train_u, train_i)
        assert rec.epoch == 1
        r1 = np.asarray(rec.recommend(0, 5))
        # same request is cached until the trainer republishes
        np.testing.assert_array_equal(np.asarray(rec.recommend(0, 5)), r1)
        w.publish(s2, 2)
        r2 = np.asarray(rec.recommend(0, 5))
        assert rec.epoch == 2
        # factors changed -> top-N generally differs; check vs direct serve
        from ycnr_tpu.serve.engine import Recommender

        expect = np.asarray(Recommender(s2, train_u, train_i).recommend(0, 5))
        np.testing.assert_array_equal(r2, expect)
        rec.close()


def test_publish_dim_mismatch_raises(shm_name):
    with FactorShmWriter(shm_name, 13, 9, 4) as w:
        with pytest.raises(ValueError, match="dims"):
            w.publish(_mk_state(rank=8), 1)


def test_writer_restart_same_dims_keeps_readers_live(shm_name):
    s1, s2 = _mk_state(seed=1), _mk_state(seed=2)
    with FactorShmWriter(shm_name, 13, 9, 4) as w1:
        w1.publish(s1, 1)
        with FactorShmReader(shm_name) as r:
            assert r.read()[1] == 1
            # trainer restarts: same dims -> adopts the live segment
            with FactorShmWriter(shm_name, 13, 9, 4) as w2:
                w2.publish(s2, 2)
            got, e = r.read()
            assert e == 2
            np.testing.assert_array_equal(np.asarray(got.U, np.float32),
                                          np.asarray(s2.U, np.float32))


def test_writer_restart_new_dims_isolates_old_readers(shm_name):
    with FactorShmWriter(shm_name, 13, 9, 4) as w1:
        w1.publish(_mk_state(), 1)
        with FactorShmReader(shm_name) as old:
            # dims changed -> fresh segment; the old mapping stays intact
            with FactorShmWriter(shm_name, 20, 9, 8) as w2:
                w2.publish(_mk_state(20, 9, 8), 7)
                got, e = old.read()  # old reader: old data, no crash
                assert e == 1 and got.U.shape == (14, 4)
                with FactorShmReader(shm_name) as new:
                    assert (new.n_users, new.rank) == (20, 8)
                    assert new.read()[1] == 7


def test_concurrent_publish_never_tears(shm_name):
    """Seqlock contract: while a writer republishes constantly, every reader
    snapshot is internally consistent — here each publish writes uniform
    arrays (U==V==bu==bi==mu==epoch), so any mix of two epochs is detectable
    in a single snapshot."""
    import threading

    n_users, n_items, rank = 64, 64, 16
    states = []
    for c in range(1, 6):
        U = np.full((n_users + 1, rank), float(c), np.float32)
        import jax.numpy as jnp

        from ycnr_tpu.models.base import MFState
        states.append(MFState(jnp.asarray(U), jnp.asarray(U),
                              jnp.asarray(U[:, 0]), jnp.asarray(U[:, 0]),
                              jnp.asarray(np.float32(c))))

    stop = threading.Event()
    with FactorShmWriter(shm_name, n_users, n_items, rank) as w:
        w.publish(states[0], 1)

        def writer():
            k = 0
            while not stop.is_set():
                k += 1
                c = k % 5
                w.publish(states[c], c + 1)

        t = threading.Thread(target=writer, daemon=True)
        t.start()
        try:
            with FactorShmReader(shm_name) as r:
                seen = set()
                for _ in range(100):
                    got, e = r.read(max_retries=10_000)
                    c = float(e)
                    seen.add(e)
                    for arr in (got.U, got.V, got.bu, got.bi):
                        a = np.asarray(arr, np.float32)
                        assert (a == c).all(), "torn snapshot"
                    assert float(got.mu) == c
        finally:
            stop.set()
            t.join(timeout=10)
        assert len(seen) > 1, "writer never got a publish in between"


_CHILD = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from ycnr_tpu.serve.shm import FactorShmReader

with FactorShmReader(sys.argv[1]) as r:
    state, epoch = r.read()
    print(json.dumps({
        "epoch": epoch,
        "dims": [r.n_users, r.n_items, r.rank],
        "u_sum": float(np.asarray(state.U, np.float64).sum()),
        "mu": float(state.mu),
    }))
"""


def test_cross_process_attach(shm_name, tmp_path):
    state = _mk_state(n_users=31, n_items=17, rank=8, seed=7, mu=1.25)
    with FactorShmWriter(shm_name, 31, 17, 8) as w:
        w.publish(state, 42)
        script = tmp_path / "child.py"
        script.write_text(_CHILD)
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH="/root/repo" + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        out = subprocess.run([sys.executable, str(script), shm_name],
                             capture_output=True, text=True, timeout=240,
                             env=env, cwd="/root/repo")
        assert out.returncode == 0, out.stderr
        got = json.loads(out.stdout.strip().splitlines()[-1])
        assert got["epoch"] == 42
        assert got["dims"] == [31, 17, 8]
        assert got["u_sum"] == pytest.approx(
            float(np.asarray(state.U, np.float64).sum()), rel=1e-6)
        assert got["mu"] == pytest.approx(1.25)


def test_train_publishes_live_factors(shm_name, tmp_path):
    """train(cfg publish_shm=...) leaves the final epoch in shm, and a
    serving process can attach it (the serve-while-training pattern)."""
    from ycnr_tpu.config import ALSConfig, DataConfig, RunConfig
    from ycnr_tpu.train.loop import train

    cfg = RunConfig(
        name="shmtest", algorithm="als",
        data=DataConfig(source="synthetic", n_users=40, n_items=24,
                        n_ratings=600, chunk_len=8),
        als=ALSConfig(rank=6, epochs=2),
        out_dir=str(tmp_path), checkpoint_every=0, log_train_rmse=False,
        publish_shm=shm_name)
    result = train(cfg)
    with FactorShmReader(shm_name) as r:
        got, epoch = r.read()
        assert epoch == 2
        np.testing.assert_array_equal(
            np.asarray(got.U, np.float32),
            np.asarray(result.state.U, np.float32))
    rec = ShmRecommender(shm_name, result.dataset.train_u,
                         result.dataset.train_i)
    assert len(np.asarray(rec.recommend(0, 5))) == 5
    rec.close()


def test_publish_checkpoint_cli_path(shm_name, tmp_path):
    from ycnr_tpu.serve.shm import publish_checkpoint
    from ycnr_tpu.train.checkpoint import save_checkpoint

    state = _mk_state()
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, state, epoch=9)
    assert publish_checkpoint(ckpt, shm_name) == 9
    with FactorShmReader(shm_name) as r:
        got, e = r.read()
        assert e == 9
        np.testing.assert_array_equal(np.asarray(got.V, np.float32),
                                      np.asarray(state.V, np.float32))


def test_second_live_writer_in_other_process_refused(shm_name):
    """Single-writer guard: while another PROCESS's writer is alive, create
    must refuse (two writers on one seqlock could validate torn reads);
    after that process exits cleanly, the name is adoptable again."""
    child = subprocess.Popen(
        [sys.executable, "-c", f"""
import sys, time
sys.path.insert(0, {os.path.dirname(os.path.dirname(os.path.abspath(__file__)))!r})
from ycnr_tpu.serve.shm import FactorShmWriter
w = FactorShmWriter({shm_name!r}, 13, 9, 4)
print("ready", flush=True)
time.sleep(30)
"""],
        stdout=subprocess.PIPE, text=True)
    try:
        assert child.stdout.readline().strip() == "ready"
        with pytest.raises(OSError):
            FactorShmWriter(shm_name, 13, 9, 4)
    finally:
        child.kill()
        child.wait()
    # the killed child never cleared its pid; a dead owner is adoptable
    with FactorShmWriter(shm_name, 13, 9, 4) as w:
        w.publish(_mk_state(), 1)
