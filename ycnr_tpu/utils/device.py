"""Which device a run is on, and refusing to measure on the wrong one."""

from __future__ import annotations

import subprocess

import jax


def describe_device() -> dict:
    """platform, device_kind and count, as JAX reports them."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu(what: str = "this run") -> None:
    """SystemExit unless JAX's default backend is the GPU."""
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"{what} needs the GPU backend; JAX found "
                         f"{backend!r} ({jax.devices()})")


def cpu_asked(platform_flag, platforms) -> bool:
    """Whether a run asked for the CPU: ``--platform cpu``, or the
    platform list (``jax.config.jax_platforms``, from ``JAX_PLATFORMS``)
    naming the CPU first; "cuda,cpu" asks for the GPU."""
    want = platform_flag or platforms or ""
    return want.split(",")[0].strip() == "cpu"


def require_accelerator_unless_cpu_asked(platform_flag) -> None:
    """SystemExit when JAX fell back to the CPU without being asked to:
    a CPU run needs ``--platform cpu`` or ``JAX_PLATFORMS=cpu``."""
    if jax.default_backend() == "cpu" and not cpu_asked(
            platform_flag, jax.config.jax_platforms):
        raise SystemExit("no accelerator found (JAX fell back to the CPU); "
                         "pass --platform cpu to run on the CPU")


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]
