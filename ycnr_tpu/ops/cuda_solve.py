"""Batched k x k SPD solve on the GPU: one CUDA kernel through ``jax.ffi``.

The kernel (``spd_solve.cu``) solves ``(sym(A) + reg I) x = b`` for every
system of a batch with the matrix held in shared memory from the one read of
``A`` to the write of ``x``; the plain XLA path it replaces reads the
``[B, k, k]`` systems several times (regularise, symmetrise, ``potrf``, two
triangular solves). ``ops.gram.guarded_batched_solve`` decides which one
runs (``solve_method``); this module only builds and calls the kernel.

The shared library is compiled from the source next to this file with
``nvcc`` for ``sm_90a`` on first use, into ``_build/`` (git-ignored), under a
name keyed by the source's hash so an edit rebuilds it. ``nvcc`` is found
through ``$CUDA_HOME``, then ``/usr/local/cuda``, then ``$PATH``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading

import jax

# Largest rank the kernel takes. Measured on an H100 at B = 138,493 systems
# it beat XLA's Cholesky at k = 10 and 64, in the solve alone and in the
# ML-20M epoch, and lost at k = 128 (PERF.md, "Bring-up on H100"), so it
# is built only up to 64.
MAX_RANK = 64
TARGET = "ycnr_spd_solve"

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "spd_solve.cu")
_BUILD_DIR = os.path.join(_DIR, "_build")
_lock = threading.Lock()
_registered = False


def _find_nvcc() -> str | None:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    return shutil.which("nvcc")


def _nvcc() -> str:
    found = _find_nvcc()
    if found is None:
        raise RuntimeError(
            "the GPU solve kernel needs the CUDA toolkit's nvcc to build "
            "(set CUDA_HOME)")
    return found


def device_capability() -> tuple[int, int] | None:
    """(major, minor) compute capability of the first device, or None
    where it is not a CUDA GPU."""
    cc = getattr(jax.devices()[0], "compute_capability", None)
    if not cc:
        return None
    major, minor = str(cc).split(".")[:2]
    return int(major), int(minor)


@functools.lru_cache(maxsize=1)
def toolkit_found() -> bool:
    """The kernel library is built, or nvcc is there to build it."""
    return os.path.exists(library_path()) or _find_nvcc() is not None


def runnable(capability: tuple[int, int] | None, toolkit: bool) -> bool:
    """The kernel is built for sm_90a, so it runs on Hopper (compute
    capability 9.x) only, and only where it is built or can be."""
    return capability is not None and capability[0] == 9 and toolkit


def library_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(_BUILD_DIR, f"libycnr_spd_solve.{digest}.so")


def build_library() -> str:
    """Compile spd_solve.cu (once per source version); returns the .so."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-o", tmp, _SRC]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def _register() -> None:
    global _registered
    with _lock:
        if _registered:
            return
        lib = ctypes.CDLL(build_library())
        jax.ffi.register_ffi_target(
            TARGET, jax.ffi.pycapsule(lib.YcnrSpdSolve), platform="CUDA")
        _registered = True


def cuda_spd_solve(A, b, reg):
    """x with (sym(A) + reg I) x = b; A [B, k, k], b [B, k], reg [B], all
    float32, k <= MAX_RANK. The regularise/symmetrise happens in-kernel."""
    _register()
    call = jax.ffi.ffi_call(TARGET, jax.ShapeDtypeStruct(b.shape, b.dtype),
                            vmap_method="broadcast_all")
    return call(A, b, reg)
