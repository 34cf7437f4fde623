"""Golden regression metrics (SURVEY.md §4 item 4).

Deterministic seeds end-to-end, so the held-out RMSE after k epochs is a
stable regression number on every platform (CPU here; fp32 path). If an
intentional change moves these, update the constants in the same commit.
"""

import numpy as np

from ycnr_tpu.config import ALSConfig, DataConfig, IALSConfig, RunConfig, SGDConfig
from ycnr_tpu.train.loop import train


def _cfg(algorithm, **algo_kw):
    return RunConfig(
        name="golden",
        algorithm=algorithm,
        data=DataConfig(source="synthetic", n_users=400, n_items=200,
                        n_ratings=20_000, chunk_len=8, seed=7),
        als=ALSConfig(rank=10, lam=0.05, epochs=5, **algo_kw
                      ) if algorithm == "als" else ALSConfig(),
        sgd=SGDConfig(rank=10, lr=0.02, lr_decay=0.95, epochs=5,
                      batch_size=1024) if algorithm == "sgd" else SGDConfig(),
        ials=IALSConfig(rank=10, lam=0.3, alpha=5.0, epochs=3
                        ) if algorithm == "ials" else IALSConfig(),
        out_dir="",  # no artifacts
        seed=3,
    )


def test_golden_als_rmse():
    res = train(_cfg("als"), out_dir=None)
    # pinned 2026-08-16 (fp32, bucketed path)
    assert abs(res.rmse_history[-1] - 0.4413) < 0.01, res.rmse_history


def test_golden_sgd_rmse():
    res = train(_cfg("sgd"), out_dir=None)
    assert abs(res.rmse_history[-1] - 0.576) < 0.02, res.rmse_history


def test_golden_ials_ranking_quality():
    """Pinned implicit-feedback quality (not just finiteness): hit-rate@10
    and NDCG@10 on the fixed synthetic set. The band is tight enough to
    catch a wrong confidence weighting — measured 2026-08-17: halving the
    effective alpha (1.0 vs 5.0) moves hit_rate by ~0.06 and ndcg by ~0.10,
    3-5x these tolerances. An untrained state scores hit_rate 0.105 /
    ndcg 0.065."""
    from ycnr_tpu.eval.ranking import ranking_metrics_at_n

    res = train(_cfg("ials"), out_dir=None)
    assert np.isfinite(res.rmse_history).all()
    ds = res.dataset
    m = ranking_metrics_at_n(res.state, ds.train_u, ds.train_i,
                             ds.test_u, ds.test_i, n=10)
    # pinned 2026-08-17 (fp32, bucketed path, alpha=5, lam=0.3, 3 epochs)
    assert abs(m["hit_rate"] - 0.296) < 0.02, m
    assert abs(m["ndcg"] - 0.2486) < 0.02, m


def test_golden_bpr_ranking_quality():
    """Pinned pairwise-ranking quality on the same fixed set (fp32,
    grad_mode=emean default, 8 epochs). Deterministic draws (seed-keyed)
    make this a stable regression number; measured 2026-08-18. Reference
    for the band: flipping to grad_mode='sum' moves hit_rate 0.427 ->
    0.409 and ndcg 0.438 -> 0.427 on this data."""
    from ycnr_tpu.config import BPRConfig
    from ycnr_tpu.eval.ranking import ranking_metrics_at_n

    cfg = _cfg("als").replace(
        algorithm="bpr",
        bpr=BPRConfig(rank=10, lam=0.01, lr=0.1, epochs=8,
                      batch_size=1024))
    res = train(cfg, out_dir=None)
    ds = res.dataset
    m = ranking_metrics_at_n(res.state, ds.train_u, ds.train_i,
                             ds.test_u, ds.test_i, n=10)
    assert abs(m["hit_rate"] - 0.427) < 0.015, m
    assert abs(m["ndcg"] - 0.4378) < 0.015, m


def _cfg_calibrated(algorithm):
    """Same shapes/seeds as _cfg but on the CALIBRATED generator (published
    ML-20M rating histogram + Pareto degrees).
    Note the quality class shifts toward real-data numbers: ALS plateaus
    near 0.82 RMSE (real ML-20M sits ~0.78-0.82) instead of the planted
    mode's easy 0.44 — the whole-star spikes and degree tail make the
    problem realistically hard, which is the point of the mode."""
    from ycnr_tpu.config import BPRConfig

    return RunConfig(
        name="golden-cal", algorithm=algorithm,
        data=DataConfig(source="synthetic", n_users=400, n_items=200,
                        n_ratings=20_000, chunk_len=8, seed=7,
                        synthetic_mode="calibrated"),
        als=ALSConfig(rank=10, lam=0.05, epochs=5),
        ials=IALSConfig(rank=10, lam=0.3, alpha=5.0, epochs=3),
        bpr=BPRConfig(rank=10, lam=0.01, lr=0.1, epochs=8,
                      batch_size=1024),
        out_dir="", seed=3)


def test_golden_als_rmse_calibrated():
    res = train(_cfg_calibrated("als"), out_dir=None)
    # pinned 2026-08-18 (fp32, bucketed path, calibrated generator)
    assert abs(res.rmse_history[-1] - 0.8223) < 0.012, res.rmse_history


def test_golden_ials_ranking_quality_calibrated():
    from ycnr_tpu.eval.ranking import ranking_metrics_at_n

    res = train(_cfg_calibrated("ials"), out_dir=None)
    ds = res.dataset
    m = ranking_metrics_at_n(res.state, ds.train_u, ds.train_i,
                             ds.test_u, ds.test_i, n=10)
    # pinned 2026-08-18 (alpha=5, lam=0.3, 3 epochs, calibrated generator)
    assert abs(m["hit_rate"] - 0.2325) < 0.02, m
    assert abs(m["ndcg"] - 0.1793) < 0.02, m


def test_golden_bpr_ranking_quality_calibrated():
    from ycnr_tpu.eval.ranking import ranking_metrics_at_n

    res = train(_cfg_calibrated("bpr"), out_dir=None)
    ds = res.dataset
    m = ranking_metrics_at_n(res.state, ds.train_u, ds.train_i,
                             ds.test_u, ds.test_i, n=10)
    # pinned 2026-08-18 (grad_mode=emean default, calibrated generator)
    assert abs(m["hit_rate"] - 0.3779) < 0.015, m
    assert abs(m["ndcg"] - 0.3692) < 0.015, m
