"""BPR-MF device-vs-oracle parity + determinism + collision masking
(models/bpr.py vs oracle/numpy_mf.bpr_epoch_batched)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ycnr_tpu.data.synthetic import synthetic_ratings
from ycnr_tpu.models.base import init_state
from ycnr_tpu.models.bpr import (
    BPRTrainer,
    bpr_epoch,
    pack_rated_bits,
    prepare_bpr_data,
)
from ycnr_tpu.oracle.numpy_mf import bpr_epoch_batched


def _implicit(n_users=40, n_items=30, nnz=600, seed=0):
    u, i, r = synthetic_ratings(n_users, n_items, nnz, true_rank=3,
                                seed=seed)
    return u, i


@pytest.mark.parametrize("grad_mode", ["sum", "mean", "emean"])
def test_bpr_oracle_parity_f64(grad_mode):
    n_users, n_items, B = 40, 30, 100
    u, i = _implicit(n_users, n_items)
    n = (len(u) // B) * B  # no padding: oracle has no pad concept
    u, i = u[:n], i[:n]
    rng = np.random.default_rng(1)
    perm = rng.permutation(n)
    negs = rng.integers(0, n_items, n).astype(np.int32)

    st = init_state(n_users, n_items, 5, seed=2, dtype=jnp.float64)
    # snapshot before the epoch: bpr_epoch donates the state buffers
    U0, V0, bi0, bu0 = (np.asarray(st.U), np.asarray(st.V),
                        np.asarray(st.bi), np.asarray(st.bu))
    data = prepare_bpr_data(u, i, B, n_users, n_items)
    out = bpr_epoch(st, data, jnp.asarray(perm), jnp.asarray(negs),
                    0.02, 0.05, B, grad_mode)

    # device pairs perm-ordered positives with negs in given order
    oU, oV, obi = bpr_epoch_batched(
        U0[:-1], V0[:-1], bi0[:-1], u[perm], i[perm], negs,
        0.02, 0.05, B, grad_mode)
    np.testing.assert_allclose(np.asarray(out.U)[:-1], oU, atol=1e-12)
    np.testing.assert_allclose(np.asarray(out.V)[:-1], oV, atol=1e-12)
    np.testing.assert_allclose(np.asarray(out.bi)[:-1], obi, atol=1e-12)
    # trash rows stay zero, bu/mu untouched
    assert np.all(np.asarray(out.U)[-1] == 0)
    assert np.all(np.asarray(out.V)[-1] == 0)
    np.testing.assert_array_equal(np.asarray(out.bu), bu0)


def test_bpr_deterministic_and_learns():
    n_users, n_items = 60, 40
    u, i = _implicit(n_users, n_items, nnz=1200, seed=3)
    data = prepare_bpr_data(u, i, 256, n_users, n_items)
    tr = BPRTrainer(lam=0.01, lr=0.15, batch_size=256, seed=5)
    st1 = init_state(n_users, n_items, 8, seed=7)
    st2 = init_state(n_users, n_items, 8, seed=7)
    for e in range(30):
        st1 = tr.epoch(st1, data, e)
        st2 = tr.epoch(st2, data, e)
    np.testing.assert_array_equal(np.asarray(st1.U), np.asarray(st2.U))
    # ranking signal: observed pairs should outscore random unobserved ones
    U, V, bi = (np.asarray(st1.U), np.asarray(st1.V), np.asarray(st1.bi))
    pos = np.einsum("nk,nk->n", U[u], V[i]) + bi[i]
    rated = set(zip(u.tolist(), i.tolist()))
    rng = np.random.default_rng(0)
    neg_u, neg_i = [], []
    while len(neg_u) < len(u):
        a = int(rng.integers(0, n_users))
        b = int(rng.integers(0, n_items))
        if (a, b) not in rated:
            neg_u.append(a)
            neg_i.append(b)
    neg = (np.einsum("nk,nk->n", U[neg_u], V[neg_i])
           + bi[np.asarray(neg_i)])
    auc = float(np.mean(pos[:, None] > neg[None, :]))
    assert auc > 0.8, auc


def test_bpr_emean_tracks_mean_quality():
    """The expected-multiplicity mode must land in the same quality band
    as realized-multiplicity "mean" (it exists purely to avoid mean's
    on-device counting cost)."""
    n_users, n_items = 80, 60
    u, i = _implicit(n_users, n_items, nnz=2400, seed=11)
    data = prepare_bpr_data(u, i, 512, n_users, n_items)
    aucs = {}
    for gm in ("mean", "emean"):
        tr = BPRTrainer(lam=0.01, lr=0.15, batch_size=512, seed=5,
                        grad_mode=gm)
        st = init_state(n_users, n_items, 8, seed=7)
        for e in range(25):
            st = tr.epoch(st, data, e)
        U, V, bi = (np.asarray(st.U), np.asarray(st.V), np.asarray(st.bi))
        pos = np.einsum("nk,nk->n", U[u], V[i]) + bi[i]
        rng = np.random.default_rng(0)
        rated = set(zip(u.tolist(), i.tolist()))
        nu_, ni_ = [], []
        while len(nu_) < 1500:
            a = int(rng.integers(0, n_users))
            b = int(rng.integers(0, n_items))
            if (a, b) not in rated:
                nu_.append(a)
                ni_.append(b)
        neg = (np.einsum("nk,nk->n", U[nu_], V[ni_])
               + bi[np.asarray(ni_)])
        aucs[gm] = float(np.mean(pos[:, None] > neg[None, :]))
    assert aucs["emean"] > 0.7, aucs
    assert abs(aucs["emean"] - aucs["mean"]) < 0.06, aucs


def test_bpr_collision_masking_extreme():
    """A user who rated the whole catalog except one item: nearly every
    sampled negative collides; updates must stay finite and the trash rows
    zero (no NaN from all-masked batches)."""
    n_items = 16
    full_u = np.zeros(n_items - 1, np.int32)
    full_i = np.arange(n_items - 1, dtype=np.int32)
    data = prepare_bpr_data(full_u, full_i, 8, 1, n_items)
    tr = BPRTrainer(lam=0.01, lr=0.1, batch_size=8, seed=0)
    st = init_state(1, n_items, 4, seed=1)
    for e in range(3):
        st = tr.epoch(st, data, e)
    assert np.all(np.isfinite(np.asarray(st.U)))
    assert np.all(np.isfinite(np.asarray(st.V)))
    assert np.all(np.asarray(st.U)[-1] == 0)


def test_pack_rated_bits_roundtrip():
    n_users, n_items = 25, 70
    u, i = _implicit(n_users, n_items, nnz=500, seed=9)
    bits = pack_rated_bits(u, i, n_users, n_items)
    dense = np.zeros((n_users + 1, n_items), bool)
    dense[u, i] = True
    for uu in range(n_users + 1):
        got = [(bits[uu, b // 32] >> np.uint32(b % 32)) & 1
               for b in range(n_items)]
        np.testing.assert_array_equal(np.asarray(got, bool), dense[uu])
