"""Properties of the synthetic ratings generator (ycnr_tpu/data/synthetic.py).

The generator is the primary data source in this no-network environment
(SURVEY.md §7), so its invariants — exact dedup, determinism, target count,
rating range — are load-bearing for every downstream test and bench.
"""

import numpy as np
import pytest

from ycnr_tpu.data.synthetic import _sorted_unique, synthetic_ratings


def _keys(u, i, n_items):
    return u.astype(np.int64) * n_items + i


@pytest.mark.parametrize("power_law", [0.0, 0.6, 1.0])
def test_no_duplicates_and_exact_count(power_law):
    u, i, r = synthetic_ratings(500, 300, 30_000, seed=11,
                                power_law=power_law)
    keys = _keys(u, i, 300)
    assert len(np.unique(keys)) == len(keys)
    # sparse regime (20% density): the adaptive oversampler must hit the
    # requested count exactly
    assert len(r) == 30_000


@pytest.mark.parametrize("n,hi", [(0, 1), (1, 5), (1000, 7), (50_000, 1 << 40)],
                         ids=["empty", "one", "dup-heavy", "sparse"])
def test_sorted_unique_is_np_unique(n, hi):
    x = np.random.default_rng(n).integers(0, hi, n, dtype=np.int64)
    np.testing.assert_array_equal(_sorted_unique(x), np.unique(x))


def test_deterministic():
    a = synthetic_ratings(200, 100, 5_000, seed=3)
    b = synthetic_ratings(200, 100, 5_000, seed=3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    c = synthetic_ratings(200, 100, 5_000, seed=4)
    assert not np.array_equal(a[0], c[0]) or not np.array_equal(a[1], c[1])


def test_rating_range_and_levels():
    u, i, r = synthetic_ratings(300, 200, 10_000, seed=0)
    assert r.min() >= 0.5 and r.max() <= 5.0
    # half-star levels
    np.testing.assert_array_equal(r * 2, np.round(r * 2))
    uf, if_, rf = synthetic_ratings(300, 200, 10_000, seed=0,
                                    rating_levels=False)
    assert rf.dtype == np.float32


def test_indices_in_range():
    u, i, r = synthetic_ratings(123, 45, 2_000, seed=9)
    assert u.min() >= 0 and int(u.max()) < 123
    assert i.min() >= 0 and int(i.max()) < 45
    assert u.dtype == np.int32 and i.dtype == np.int32


def test_nearly_full_grid_caps_gracefully():
    # request more ratings than the grid holds: generator must stop at the
    # ~98% density cap instead of looping forever
    u, i, r = synthetic_ratings(40, 30, 40 * 30 + 500, seed=2)
    assert len(r) <= 40 * 30
    keys = _keys(u, i, 30)
    assert len(np.unique(keys)) == len(keys)


def test_power_law_skews_popularity():
    u, i, r = synthetic_ratings(2_000, 1_000, 60_000, seed=5, power_law=1.0)
    counts = np.bincount(i, minlength=1_000)
    top = np.sort(counts)[-20:].sum()
    # with a zipf-ish law the top-2% of items hold far more than 2% of mass
    assert top > 0.10 * len(r)


def test_calibrated_rating_histogram_exact():
    """The calibrated mode's rating marginal matches the published ML-20M
    histogram to largest-remainder rounding."""
    from ycnr_tpu.data.synthetic import (ML20M_RATING_HIST,
                                         synthetic_ratings_calibrated)

    u, i, r = synthetic_ratings_calibrated(800, 400, 40_000, seed=3)
    n = len(r)
    assert n > 38_000  # dedup drop is small
    levels, counts = np.unique(r, return_counts=True)
    got = dict(zip(levels.tolist(), (counts / n).tolist()))
    for v, p in ML20M_RATING_HIST.items():
        assert abs(got.get(v, 0.0) - p) < 1.5 / n + 1e-9, (v, got.get(v), p)


def test_calibrated_degrees_floor_and_tail():
    from ycnr_tpu.data.synthetic import synthetic_ratings_calibrated

    nu, ni, nnz = 1_500, 900, 120_000
    u, i, r = synthetic_ratings_calibrated(nu, ni, nnz, seed=1)
    deg = np.bincount(u, minlength=nu)
    # ML-20M filters users to >= 20 ratings; dedup can shave a couple off
    # a heavy user whose redraws collide, never below 20 - 2
    assert deg.min() >= 18, deg.min()
    # Pareto tail: the max degree is far above the mean
    assert deg.max() > 4 * deg.mean()
    # total close to requested (per-user dedup drop only; this grid
    # is 8.9% dense — far denser than real ML-20M's 0.54%)
    assert len(r) > 0.92 * nnz
    # items Zipf-skewed
    ic = np.bincount(i, minlength=ni)
    assert np.sort(ic)[-int(ni * 0.02):].sum() > 0.08 * len(r)


def test_calibrated_deterministic_and_planted_structure():
    from ycnr_tpu.data.synthetic import synthetic_ratings_calibrated

    a = synthetic_ratings_calibrated(400, 300, 20_000, seed=7)
    b = synthetic_ratings_calibrated(400, 300, 20_000, seed=7)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    c = synthetic_ratings_calibrated(400, 300, 20_000, seed=8)
    assert not np.array_equal(a[2], c[2])
    # quantile mapping preserves planted order structure: a rank-8 model
    # must be learnable — oracle ALS holdout RMSE beats the constant
    # predictor by a clear margin
    from ycnr_tpu.data.split import train_test_split
    from ycnr_tpu.oracle.numpy_mf import als_wr_epoch, rmse

    u, i, r = synthetic_ratings_calibrated(400, 300, 20_000, seed=7,
                                           noise=0.08)
    (tu, ti, tr), (su, si, sr) = train_test_split(u, i, r, 0.1, 0)
    rng = np.random.default_rng(0)
    U = rng.normal(0, 0.1, (400, 8))
    V = rng.normal(0, 0.1, (300, 8))
    for _ in range(4):
        U, V = als_wr_epoch(U, V, tu, ti, tr.astype(np.float64), 0.05)
    const = float(np.sqrt(np.mean((sr - tr.mean()) ** 2)))
    got = rmse(U, V, su, si, sr.astype(np.float64))
    assert got < 0.85 * const, (got, const)


def test_calibrated_via_dataset_config():
    from ycnr_tpu.config import DataConfig
    from ycnr_tpu.data.dataset import load_dataset

    ds = load_dataset(DataConfig(source="synthetic", n_users=300,
                                 n_items=200, n_ratings=8_000,
                                 synthetic_mode="calibrated", chunk_len=8))
    assert len(ds.train_r) + len(ds.test_r) > 7_500
    levels = np.unique(np.concatenate([ds.train_r, ds.test_r]))
    assert 5.0 in levels and 0.5 in levels  # full star range present
    import pytest

    with pytest.raises(ValueError, match="synthetic_mode"):
        load_dataset(DataConfig(source="synthetic",
                                synthetic_mode="bogus"))
