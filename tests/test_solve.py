"""Batched SPD solve: the XLA path against float64, the rule that picks
between it and the CUDA kernel, and (on a GPU only) the kernel itself."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ycnr_tpu.ops import cuda_solve
from ycnr_tpu.ops.cuda_solve import MAX_RANK
from ycnr_tpu.ops.gram import guarded_batched_solve, solve_method, solve_override

HOPPER = dict(capability=(9, 0), toolkit=True)


def _systems(B, k, seed=0, dtype=np.float32):
    """ALS-shaped systems: Gram of up to 2k gathered rows plus the
    lam * n_e ridge; every 5th system is an empty slot (n_e = 0)."""
    rng = np.random.default_rng(seed)
    n = rng.integers(1, 2 * k + 1, B)
    n[::5] = 0
    rows = rng.normal(0, (3.5 / k) ** 0.5, (B, 2 * k, k))
    rows *= (np.arange(2 * k)[None, :] < n[:, None])[..., None]
    r = rng.uniform(1, 5, (B, 2 * k)) * (np.arange(2 * k)[None] < n[:, None])
    A = np.einsum("brk,brm->bkm", rows, rows)
    b = np.einsum("brk,br->bk", rows, r)
    reg = 0.05 * n + (n == 0)
    return A.astype(dtype), b.astype(dtype), reg.astype(dtype)


def _solve64(A, b, reg):
    A = np.asarray(A, np.float64)
    A = 0.5 * (A + np.swapaxes(A, -1, -2))
    A = A + np.asarray(reg, np.float64)[:, None, None] * np.eye(A.shape[-1])
    return np.linalg.solve(A, np.asarray(b, np.float64)[..., None])[..., 0]


@pytest.mark.parametrize("B", [64, 37], ids=["aligned", "ragged"])
@pytest.mark.parametrize("k", [8, 10, 16, 32, 64, 128])
def test_xla_solve_matches_float64(k, B):
    A, b, reg = _systems(B, k, seed=k + B)
    x = np.asarray(jax.jit(guarded_batched_solve)(A, b, reg))
    ref = _solve64(A, b, reg)
    scale = np.abs(ref).max(axis=1, keepdims=True) + 1e-30
    # f32 solve of systems with cond <~ 1e3: forward error ~ k eps cond
    assert np.abs(x - ref).max() <= 1e-3 * scale.max()
    assert (np.abs(x - ref) / scale).max() < 1e-3


def test_identity_guard_solves_to_exact_zero():
    A, b, reg = _systems(40, 16)
    empty = np.arange(40) % 5 == 0
    assert (b[empty] == 0).all() and (reg[empty] == 1).all()
    x = np.asarray(guarded_batched_solve(A, b, reg))
    assert (x[empty] == 0.0).all()


def test_solve_symmetrises_its_input():
    A, b, reg = _systems(8, 10, seed=3)
    skew = np.triu(np.full((10, 10), 1e-3, np.float32), 1)
    x0 = np.asarray(guarded_batched_solve(A, b, reg))
    x1 = np.asarray(guarded_batched_solve(A + skew - skew.T, b, reg))
    np.testing.assert_allclose(x1, x0, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("backend,capability,toolkit,dtype,k,want", [
    ("gpu", (9, 0), True, jnp.float32, 10, "cuda"),
    ("gpu", (9, 0), True, jnp.float32, MAX_RANK, "cuda"),
    ("gpu", (9, 0), True, jnp.float32, MAX_RANK + 1, "xla"),
    ("gpu", (9, 0), True, jnp.float32, 128, "xla"),
    ("gpu", (9, 0), True, jnp.float64, 10, "xla"),
    ("gpu", (9, 0), True, jnp.bfloat16, 10, "xla"),
    ("gpu", (8, 0), True, jnp.float32, 10, "xla"),
    ("gpu", (10, 0), True, jnp.float32, 10, "xla"),
    ("gpu", (9, 0), False, jnp.float32, 10, "xla"),
    ("cpu", (9, 0), True, jnp.float32, 10, "xla"),
])
def test_auto_dispatch_rule(backend, capability, toolkit, dtype, k, want):
    assert solve_method(dtype, k, "auto", backend=backend,
                        capability=capability, toolkit=toolkit) == want


def test_device_capability_is_none_off_the_gpu():
    assert cuda_solve.device_capability() is None
    assert not cuda_solve.runnable(None, True)


def test_auto_dispatch_on_this_host_is_xla_without_a_gpu():
    # the CPU test host: no capability is queried, XLA is the answer
    assert jax.default_backend() == "cpu"
    assert solve_method(jnp.float32, 10) == "xla"


@pytest.mark.parametrize("backend,capability,toolkit,dtype,k", [
    ("cpu", (9, 0), True, jnp.float32, 10),
    ("gpu", (9, 0), True, jnp.float64, 10),
    ("gpu", (9, 0), True, jnp.float32, MAX_RANK + 1),
    ("gpu", (8, 9), True, jnp.float32, 10),
    ("gpu", None, True, jnp.float32, 10),
    ("gpu", (9, 0), False, jnp.float32, 10),
])
def test_forced_cuda_refuses_where_it_cannot_run(backend, capability,
                                                 toolkit, dtype, k):
    with pytest.raises(ValueError, match="CUDA solve needs"):
        solve_method(dtype, k, "cuda", backend=backend,
                     capability=capability, toolkit=toolkit)


def test_forced_cuda_up_to_kernel_max_rank():
    assert solve_method(jnp.float32, MAX_RANK, "cuda", backend="gpu",
                        **HOPPER) == "cuda"


def test_override_steers_auto_and_restores():
    with solve_override("xla"):
        assert solve_method(jnp.float32, 10, backend="gpu", **HOPPER) == "xla"
        # an explicit method still wins over the override
        assert solve_method(jnp.float32, 10, "cuda", backend="gpu",
                            **HOPPER) == "cuda"
    assert solve_method(jnp.float32, 10, backend="gpu", **HOPPER) == "cuda"
    with pytest.raises(ValueError):
        with solve_override("pallas"):
            pass
    with pytest.raises(ValueError):
        solve_method(jnp.float32, 10, "pallas")


def test_library_name_follows_source(monkeypatch, tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("a")
    monkeypatch.setattr(cuda_solve, "_SRC", str(src))
    p1 = cuda_solve.library_path()
    src.write_text("b")
    p2 = cuda_solve.library_path()
    assert p1 != p2 and p1.endswith(".so")
    assert cuda_solve._BUILD_DIR in p1


# ---- on the card only: `JAX_PLATFORMS=cuda python -m pytest -m gpu` ----

@pytest.mark.gpu
@pytest.mark.parametrize("k", [10, 32, MAX_RANK])
def test_cuda_kernel_matches_float64(k):
    A, b, reg = _systems(1000, k, seed=k)
    x = np.asarray(jax.jit(lambda *a: guarded_batched_solve(
        *a, method="cuda"))(A, b, reg))
    ref = _solve64(A, b, reg)
    scale = np.abs(ref).max(axis=1, keepdims=True) + 1e-30
    assert (np.abs(x - ref) / scale).max() < 1e-3
    assert (x[::5] == 0.0).all()  # identity-guard slots


@pytest.mark.gpu
def test_cuda_kernel_under_vmap():
    A, b, reg = _systems(64, 16)
    f = jax.vmap(lambda A, b, r: guarded_batched_solve(A, b, r, "cuda"))
    x = np.asarray(f(A.reshape(4, 16, 16, 16), b.reshape(4, 16, 16),
                     reg.reshape(4, 16)))
    np.testing.assert_allclose(x.reshape(64, 16), _solve64(A, b, reg),
                               rtol=1e-3, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [10, MAX_RANK])
def test_cuda_kernel_matches_float64_ials_systems(k):
    # iALS shape: alpha-weighted Gram plus a dense base Gram F^T F shared by
    # every system, constant ridge lam (models/bucketed_phase, parallel/)
    A, b, _ = _systems(1000, k, seed=k + 1)
    rng = np.random.default_rng(k)
    F = rng.normal(0, (3.5 / k) ** 0.5, (4 * k, k))
    A = (40.0 * A + (F.T @ F)[None]).astype(np.float32)
    reg = np.full(1000, 0.1, np.float32)
    x = np.asarray(jax.jit(lambda *a: guarded_batched_solve(
        *a, method="cuda"))(A, b, reg))
    ref = _solve64(A, b, reg)
    scale = np.abs(ref).max(axis=1, keepdims=True) + 1e-30
    assert (np.abs(x - ref) / scale).max() < 1e-3
    np.testing.assert_allclose(
        x, np.asarray(guarded_batched_solve(A, b, reg, "xla")),
        rtol=1e-3, atol=1e-3 * float(np.abs(ref).max()))
