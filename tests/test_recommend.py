"""Masked top-N serving vs oracle (SURVEY.md C13, call stack 3.5)."""

import numpy as np
import pytest

from ycnr_tpu.data.synthetic import synthetic_ratings
from ycnr_tpu.eval.recommend import recommend_all, recommend_users
from ycnr_tpu.models.base import state_from_numpy
from ycnr_tpu.ops.layout import build_blocked_csr
from ycnr_tpu.oracle import numpy_mf as om


def _setup(seed=0, n_users=40, n_items=60, nnz=1200, k=5):
    u, i, r = synthetic_ratings(n_users, n_items, nnz, true_rank=3, seed=seed)
    rng = np.random.default_rng(seed)
    U = rng.normal(0, 1.0, (n_users, k))
    V = rng.normal(0, 1.0, (n_items, k))
    return u, i, r, U, V, n_users, n_items


def test_recommend_all_matches_oracle():
    u, i, r, U, V, nu, ni = _setup()
    layout = build_blocked_csr(u, i, r, nu, ni, 8, 32)
    state = state_from_numpy(U, V)
    uids, items, scores = recommend_all(state, layout, n=7)
    assert set(uids.tolist()) == set(np.unique(u).tolist())
    for row, uid in enumerate(uids):
        rated = i[u == uid]
        # beyond the unrated count, slots hold arbitrary -inf ties
        m = min(7, ni - len(set(rated.tolist())))
        expect = om.topn(U.astype(np.float32), V.astype(np.float32),
                         rated, uid, 7)
        np.testing.assert_array_equal(items[row][:m], expect[:m])
        assert not (set(items[row][:m].tolist()) & set(rated.tolist()))
        assert np.all(np.diff(scores[row]) <= 0)


def test_recommend_users_matches_oracle():
    u, i, r, U, V, nu, ni = _setup(seed=2)
    state = state_from_numpy(U, V)
    ask = np.array([0, 5, 17, 39])
    items, scores = recommend_users(state, u, i, ask, n=5)
    for row, uid in enumerate(ask):
        rated = i[u == uid]
        m = min(5, ni - len(set(rated.tolist())))
        expect = om.topn(U.astype(np.float32), V.astype(np.float32),
                         rated, uid, 5)
        np.testing.assert_array_equal(items[row][:m], expect[:m])


def test_recommend_with_biases():
    """SGD-trained states serve with mu + b_u + b_i + UV^T scores."""
    u, i, r, U, V, nu, ni = _setup(seed=3)
    rng = np.random.default_rng(3)
    bu = rng.normal(0, 0.3, nu)
    bi = rng.normal(0, 0.3, ni)
    state = state_from_numpy(U, V, bu, bi, mu=3.2)
    ask = np.array([1, 2])
    items, scores = recommend_users(state, u, i, ask, n=5)
    for row, uid in enumerate(ask):
        rated = i[u == uid]
        expect = om.topn(U.astype(np.float32), V.astype(np.float32), rated,
                         uid, 5, bu=bu.astype(np.float32),
                         bi=bi.astype(np.float32), mu=3.2)
        np.testing.assert_array_equal(items[row], expect)


def test_rated_bits_builder_matches_bruteforce():
    u, i, r, U, V, nu, ni = _setup(seed=5)
    from ycnr_tpu.eval.recommend import build_rated_bits

    layout = build_blocked_csr(u, i, r, nu, ni, 8, 32)
    bits = build_rated_bits(layout, ni)
    W = 4 * (-(-(ni + 1) // 128))  # aligned to 128-bit segments
    assert bits.shape == (layout.n_blocks, layout.block_entities, W)
    # every pad column beyond n_items is masked
    assert np.all(bits[..., (ni >> 5) + 1 :] == np.uint32(0xFFFFFFFF))
    eid = np.asarray(layout.entity_ids)
    for b in range(layout.n_blocks):
        for s in range(layout.block_entities):
            got = np.zeros(ni + 1, bool)
            for w in range(W):
                for bit in range(32):
                    if w * 32 + bit <= ni and (bits[b, s, w] >> bit) & 1:
                        got[w * 32 + bit] = True
            want = np.zeros(ni + 1, bool)
            want[ni] = True  # trash column always set
            if eid[b, s] < nu:
                want[np.unique(i[u == eid[b, s]])] = True
            np.testing.assert_array_equal(got, want)


def test_bits_path_matches_scatter_path():
    """The fused bitmask + exact segment-top-k path must agree with the
    scatter + full-sort reference path (needs n_items > n*128 so the
    segment stage actually runs)."""
    nu, ni, nnz, k, n = 60, 700, 9000, 6, 5
    u, i, r = synthetic_ratings(nu, ni, nnz, true_rank=3, seed=7)
    # one mega-user who rated most items
    extra_i = np.setdiff1d(np.arange(ni), i[u == 0])[:600]
    u = np.concatenate([u, np.zeros(len(extra_i), np.int64)])
    i = np.concatenate([i, extra_i])
    r = np.concatenate([r, np.ones(len(extra_i), np.float32)])
    rng = np.random.default_rng(7)
    state = state_from_numpy(rng.normal(size=(nu, k)),
                             rng.normal(size=(ni, k)),
                             rng.normal(0, 0.3, nu), rng.normal(0, 0.3, ni),
                             mu=3.0)
    layout = build_blocked_csr(u, i, r, nu, ni, 8, 32)
    from ycnr_tpu.eval.recommend import _topn_blocks, build_rated_bits

    ids_ref, sc_ref = _topn_blocks(state, layout, n)  # scatter path
    bits = build_rated_bits(layout, ni)
    ids_new, sc_new = _topn_blocks(state, layout, n, bits)
    np.testing.assert_allclose(np.asarray(sc_new), np.asarray(sc_ref),
                               rtol=0, atol=0)
    # ids may differ only where scores tie exactly (measure-zero here)
    np.testing.assert_array_equal(np.asarray(ids_new), np.asarray(ids_ref))


def test_user_with_all_items_rated():
    # a user who rated every item gets NEG_INF everywhere; top-k still returns
    # n indices without crashing
    u = np.zeros(10, np.int32)
    i = np.arange(10, dtype=np.int32)
    r = np.ones(10, np.float32)
    rng = np.random.default_rng(0)
    state = state_from_numpy(rng.normal(size=(1, 3)), rng.normal(size=(10, 3)))
    items, scores = recommend_users(state, u, i, np.array([0]), n=5)
    assert items.shape == (1, 5)
    assert np.all(scores <= -1e38)


@pytest.mark.parametrize("n_items", [130, 300, 1000])
def test_exact_scorer_matches_float64_at_unaligned_widths(n_items):
    """The exact scorer's 128-item segments pad the catalog; at widths
    that are not a multiple of 128 its float32 top-10 must still be the
    float64 top-10 (scores within f32 rounding, rated items excluded)."""
    import jax.numpy as jnp

    n_users, k = 50, 16
    u, i, r = synthetic_ratings(n_users, n_items, 20 * n_users, true_rank=3,
                                seed=n_items)
    rng = np.random.default_rng(n_items)
    U = rng.normal(0, 1.0, (n_users, k))
    V = rng.normal(0, 1.0, (n_items, k))
    bu, bi = rng.normal(0, .1, n_users), rng.normal(0, .1, n_items)
    state = state_from_numpy(U, V, bu, bi, mu=3.5, dtype=jnp.float32)
    uids, items, scores = recommend_all(
        state, build_blocked_csr(u, i, r, n_users, n_items, 8, 32), n=10)
    U32, V32 = (x.astype(np.float32).astype(np.float64) for x in (U, V))
    b32 = [x.astype(np.float32).astype(np.float64) for x in (bu, bi)]
    for row, uid in enumerate(uids):
        s = 3.5 + b32[0][uid] + b32[1] + V32 @ U32[uid]
        s[i[u == uid]] = -np.inf
        ref = np.sort(s)[::-1][:10]
        np.testing.assert_allclose(s[items[row]], ref, rtol=0, atol=1e-4)
        np.testing.assert_allclose(scores[row], ref, rtol=0, atol=1e-4)
