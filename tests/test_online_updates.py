"""Online serving updates (add_ratings) and early stopping."""

import dataclasses
import json

import numpy as np
import pytest

from ycnr_tpu.config import ALSConfig, DataConfig, RunConfig
from ycnr_tpu.data.synthetic import synthetic_ratings
from ycnr_tpu.models.base import init_state
from ycnr_tpu.serve.engine import Recommender
from ycnr_tpu.train.loop import train


def test_add_ratings_resolves_user_row():
    n_users, n_items = 30, 40
    u, i, r = synthetic_ratings(n_users, n_items, 400, true_rank=3, seed=2)
    state = init_state(n_users, n_items, 5, seed=0)
    rec = Recommender(state, u, i, train_r=r)
    lam = 0.05

    top_before = np.asarray(rec.recommend(3, 5))
    new_items = np.asarray([x for x in top_before[:2]])
    rec.add_ratings(3, new_items, [5.0, 5.0], lam=lam)

    # newly-rated items are masked out of the user's recs now
    top_after = np.asarray(rec.recommend(3, 5))
    assert not set(new_items.tolist()) & set(top_after.tolist())

    # updates live in the pending log until compaction materializes them
    assert rec.pending_count() == 2
    rec.compact()
    assert rec.pending_count() == 0
    # masking is identical after compaction
    assert not set(new_items.tolist()) & set(
        np.asarray(rec.recommend(3, 5)).tolist())

    # the row equals a fresh fold-in over the user's full updated list
    from ycnr_tpu.serve.fold_in import fold_in_users

    mine = rec.train_u == 3
    expect = fold_in_users(state, [rec.train_i[mine]], [rec.train_r[mine]],
                           lam=lam)[0]
    np.testing.assert_allclose(np.asarray(rec.state.U[3]), expect,
                               rtol=1e-5, atol=1e-7)
    # other rows untouched
    np.testing.assert_array_equal(np.asarray(rec.state.U[4]),
                                  np.asarray(state.U[4]))


def test_add_ratings_rerating_replaces():
    n_users, n_items = 10, 15
    u, i, r = synthetic_ratings(n_users, n_items, 80, true_rank=2, seed=1)
    state = init_state(n_users, n_items, 4, seed=0)
    rec = Recommender(state, u, i, train_r=r)
    before = int((rec.train_u == 2).sum())
    rated = rec.train_i[rec.train_u == 2][0]
    # re-rate an existing item twice in one update: last value wins, count
    # stays (no duplicate (u, i) rows in the solve)
    rec.add_ratings(2, [rated, rated], [1.0, 5.0])
    rec.compact()
    mine = rec.train_u == 2
    assert int(mine.sum()) == before
    assert rec.train_r[mine & (rec.train_i == rated)] == [5.0]


def test_add_ratings_guards():
    u = np.array([0, 1])
    i = np.array([1, 2])
    state = init_state(3, 5, 2, seed=0)
    rec_no_r = Recommender(state, u, i)
    with pytest.raises(ValueError, match="train_r"):
        rec_no_r.add_ratings(0, [3], [4.0])
    rec = Recommender(state, u, i, train_r=np.array([4.0, 3.0]))
    with pytest.raises(IndexError, match="recommend_cold"):
        rec.add_ratings(99, [3], [4.0])


def _cfg(tmp_path, patience, epochs=12):
    return RunConfig(
        name="es", algorithm="als",
        data=DataConfig(source="synthetic", n_users=60, n_items=30,
                        n_ratings=1200, chunk_len=8),
        als=ALSConfig(rank=4, epochs=epochs),
        out_dir=str(tmp_path), checkpoint_every=0, log_train_rmse=False,
        early_stop_patience=patience, early_stop_min_delta=1e-3)


def test_early_stop_triggers(tmp_path):
    # tiny ALS converges in a couple of epochs; patience 2 must cut the run
    res = train(_cfg(tmp_path, patience=2))
    assert len(res.rmse_history) < 12
    events = [json.loads(line) for line in open(
        f"{tmp_path}/es/metrics.jsonl")]
    assert any(e.get("event") == "early_stop" for e in events)


def test_early_stop_off_runs_all(tmp_path):
    res = train(_cfg(tmp_path, patience=0, epochs=4))
    assert len(res.rmse_history) == 4


def test_out_of_range_ids_are_loud():
    """Out-of-range users/items used to silently hit the zero trash row
    (identical bias-only recs, cached; inert-yet-persisted ratings)."""
    u = np.array([0, 1, 2])
    i = np.array([1, 2, 0])
    r = np.array([4.0, 3.0, 5.0], np.float32)
    state = init_state(3, 5, 2, seed=0)
    rec = Recommender(state, u, i, train_r=r)
    with pytest.raises(IndexError, match="user ids"):
        rec.recommend(99)
    with pytest.raises(IndexError, match="user ids"):
        rec.recommend_batch([0, 3])
    with pytest.raises(IndexError, match="item ids"):
        rec.add_ratings(0, [5], [4.0])
    with pytest.raises(IndexError, match="item ids"):
        rec.recommend_cold([0, 7], [4.0, 3.0])


def test_recommend_n_clamps_to_catalog():
    u = np.array([0, 1])
    i = np.array([1, 2])
    r = np.array([4.0, 3.0], np.float32)
    state = init_state(3, 5, 2, seed=0)
    rec = Recommender(state, u, i, train_r=r)
    out = rec.recommend(0, n=50)
    assert len(out) <= 5 and 1 not in out.tolist()


def test_compact_many_users_matches_fresh_rebuild():
    """compact() folds a many-user pending log correctly (vectorized
    packed-key join — the per-user rescan was quadratic)."""
    nu, ni = 120, 60
    u, i, r = synthetic_ratings(nu, ni, 2000, true_rank=3, seed=9)
    state = init_state(nu, ni, 4, seed=0)
    rec = Recommender(state, u, i, train_r=r, compact_threshold=10**9)
    rng = np.random.default_rng(3)
    for uid in range(50):
        items = rng.choice(ni, 3, replace=False)
        rec.add_ratings(uid, items, rng.uniform(1, 5, 3))
    assert rec.pending_count() > 0
    rec.compact()
    assert rec.pending_count() == 0
    # the folded arrays must equal a fresh engine built from the same
    # logical rating set: same per-user masks and ratings
    fresh = Recommender(state, rec.train_u, rec.train_i,
                        train_r=rec.train_r)
    for uid in range(0, 60, 7):
        np.testing.assert_array_equal(np.sort(rec._user_items(uid)),
                                      np.sort(fresh._user_items(uid)))
        a_i, a_r = rec._user_items_ratings(uid)
        b_i, b_r = fresh._user_items_ratings(uid)
        oa, ob = np.argsort(a_i), np.argsort(b_i)
        np.testing.assert_array_equal(a_i[oa], b_i[ob])
        np.testing.assert_allclose(a_r[oa], b_r[ob])


def test_early_stop_window_spans_resume(tmp_path):
    """The checkpoint carries the RMSE history, so a resumed run can
    early-stop immediately off the pre-resume trajectory (the round-1
    behavioral seam: the window used to restart at the resume point)."""
    import os

    cfg = _cfg(tmp_path, patience=0, epochs=6).replace(checkpoint_every=6)
    res1 = train(cfg)
    ck = os.path.join(res1.out_dir, "ckpt")
    res2 = train(cfg.replace(
        als=dataclasses.replace(cfg.als, epochs=20),
        early_stop_patience=2, early_stop_min_delta=1e-3,
        out_dir=str(tmp_path / "resumed")), resume=ck)
    # tiny ALS converged during the FIRST run; with the carried history the
    # resumed run notices within `patience` epochs instead of re-learning
    # the plateau from scratch
    assert len(res2.rmse_history) < 6 + 14
    assert res2.rmse_history[:6] == [round(x, 6)
                                     for x in res1.rmse_history]


def test_precompute_all_fills_cache():
    """precompute_all: one bulk pass caches every rated user's list; a
    subsequent recommend() serves from cache (no scorer call), respects
    pending updates folded in by the pre-pass compact, and a state swap
    invalidates the lot."""
    # the bulk pass runs the exact scorer; 2000 items is not a whole
    # number of its 128-item segments, so the padded tail is exercised
    n_users, n_items = 40, 2000
    u, i, r = synthetic_ratings(n_users, n_items, 800, true_rank=3, seed=4)
    state = init_state(n_users, n_items, 5, seed=0)
    rec = Recommender(state, u, i, train_r=r, compact_threshold=10**9)
    # a pending (uncompacted) online update must be honored by precompute
    pre = np.asarray(rec.recommend(7, 5))
    rec.add_ratings(7, pre[:1], [5.0], lam=0.05)
    assert rec.pending_count() > 0

    count = rec.precompute_all(n=5)
    assert count == len(np.unique(u))
    assert rec.pending_count() == 0  # compacted first

    # recommend() must now be a pure cache hit: poison the scorer
    import ycnr_tpu.serve.engine as eng

    def boom(*a, **kw):
        raise AssertionError("scorer called despite precompute")

    orig = eng.recommend_users
    eng.recommend_users = boom
    try:
        got = np.asarray(rec.recommend(7, 5))
        assert int(pre[0]) not in got.tolist()  # pending update respected
        for uid in np.unique(u)[:10]:
            rec.recommend(int(uid), 5)
    finally:
        eng.recommend_users = orig

    # a factor swap flushes the precomputed entries
    rec.update_state(init_state(n_users, n_items, 5, seed=1))
    assert rec.cache.get((7, 5)) is None
