"""Checkpoint / resume (SURVEY.md §5).

The reference persists trained factors to disk/PG tables so recommendation
can run without retraining; a dead worker means rerunning the epoch. Here
every epoch can durably snapshot {U, V, b_u, b_i, mu, epoch, config},
making jobs trivially resumable mid-training (fixed-mesh SPMD needs no
elastic membership).

Crash protocol (verified by tests/test_crash_recovery.py's SIGKILL run):
arrays land in an epoch-stamped file/dir first, then the manifest naming
them is renamed into place — the ONE commit point. A kill anywhere leaves
the previous (manifest, arrays) pair intact and consistent; a fixed arrays
name would open a window between the two renames where the old manifest
pairs with the new arrays and a resume would silently retrace a different
trajectory. Stale epoch files are garbage-collected only after the commit.

Two array backends behind one manifest format:

* ``npz`` (default) — single-file NumPy archive; zero extra deps, ideal for
  host-side serving fleets loading factors.
* ``orbax`` — ``orbax.checkpoint.StandardCheckpointer`` over the state
  pytree; the JAX-ecosystem standard (TensorStore/OCDBT storage). Use when
  checkpoints should interop with other JAX tooling.

``load_checkpoint`` dispatches on the manifest, so readers never care which
backend wrote a checkpoint.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ycnr_tpu.models.base import MFState

_MANIFEST = "manifest.json"
_ARRAYS = "state.npz"
_ORBAX_DIR = "state.orbax"


def _np_savable(x: np.ndarray) -> np.ndarray:
    # np.savez writes ml_dtypes arrays (bfloat16 etc.) as raw void dtype
    # ('|V2') with no error, which can never be loaded back into JAX.
    # Store them widened to float32; load_checkpoint casts back per the
    # manifest dtype (bf16 -> f32 is lossless).
    x = np.asarray(x)
    if x.dtype.kind == "V" or not isinstance(x.dtype.type(),
                                             (np.number, np.bool_)):
        return x.astype(np.float32)
    return x


def _save_arrays_npz(path: str, state: MFState, epoch: int) -> str:
    name = f"state-{epoch}.npz"
    tmp = os.path.join(path, name + ".tmp.npz")
    np.savez(
        tmp,
        U=_np_savable(state.U), V=_np_savable(state.V),
        bu=_np_savable(state.bu), bi=_np_savable(state.bi),
        mu=_np_savable(state.mu),
    )
    os.replace(tmp, os.path.join(path, name))
    return name


def orbax_checkpoint():
    """The orbax.checkpoint module, or a clear error where it is absent
    (it is optional: the default npz backend needs only NumPy)."""
    try:
        import orbax.checkpoint as ocp
    except ImportError as e:
        raise RuntimeError(
            "checkpoint backend 'orbax' needs the orbax-checkpoint "
            "package, which is not installed; use the default npz "
            "backend") from e
    return ocp


def _save_arrays_orbax(path: str, state: MFState, epoch: int) -> str:
    ocp = orbax_checkpoint()

    name = f"state-{epoch}.orbax"
    target = os.path.join(path, name)
    # write to a scratch dir, then rename: the epoch-stamped dir must never
    # be visible half-written (the manifest commit happens after)
    tmp = target + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(os.path.abspath(tmp), dict(state._asdict()))
    ckptr.wait_until_finished()
    if os.path.exists(target):
        shutil.rmtree(target)
    os.replace(tmp, target)
    return name


def _gc_stale_arrays(path: str, keep: str):
    """Drop array files/dirs from superseded epochs (and interrupted tmp
    writes) AFTER the manifest commit — never the one just committed, never
    legacy fixed-name files a pre-stamp manifest may still reference."""
    for entry in os.listdir(path):
        if entry == keep or not entry.startswith("state-"):
            continue
        full = os.path.join(path, entry)
        try:
            if os.path.isdir(full):
                shutil.rmtree(full)
            else:
                os.remove(full)
        except OSError:
            pass  # concurrent reader/cleaner; stale files are harmless


def save_checkpoint(path: str, state: MFState, epoch: int,
                    config: Optional[dict] = None,
                    extra: Optional[dict] = None, backend: str = "npz"):
    """Snapshot state into directory `path` (atomic: the manifest naming the
    arrays is renamed into place last)."""
    os.makedirs(path, exist_ok=True)
    if backend == "orbax":
        arrays = _save_arrays_orbax(path, state, epoch)
    elif backend == "npz":
        arrays = _save_arrays_npz(path, state, epoch)
    else:
        raise ValueError(f"unknown checkpoint backend {backend!r}")
    manifest = {
        "epoch": int(epoch),
        "rank": int(state.U.shape[1]),
        "n_users": int(state.U.shape[0] - 1),
        "n_items": int(state.V.shape[0] - 1),
        "dtype": str(state.U.dtype),
        "config": config or {},
        "extra": extra or {},
        "backend": backend,
        "arrays": arrays,
        "format": 3,
    }
    mtmp = os.path.join(path, _MANIFEST + ".tmp")
    with open(mtmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(mtmp, os.path.join(path, _MANIFEST))
    _gc_stale_arrays(path, arrays)


def _load_arrays_orbax(path: str, name: str) -> MFState:
    ocp = orbax_checkpoint()

    ckptr = ocp.StandardCheckpointer()
    tree = ckptr.restore(os.path.abspath(os.path.join(path, name)))
    return MFState(**{k: jnp.asarray(v) for k, v in tree.items()})


def load_checkpoint(path: str) -> Tuple[MFState, dict]:
    """Restore (state, manifest) from a checkpoint directory (either
    backend; dispatches on the manifest)."""
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("backend", "npz") == "orbax":
        # format<3 manifests predate epoch-stamped array names
        return _load_arrays_orbax(
            path, manifest.get("arrays", _ORBAX_DIR)), manifest
    z = np.load(os.path.join(path, manifest.get("arrays", _ARRAYS)))
    # non-numpy state dtypes (bfloat16) are stored widened to float32;
    # cast back to the manifest's recorded dtype
    dt = jnp.dtype(manifest.get("dtype", "float32"))
    state = MFState(jnp.asarray(z["U"], dt), jnp.asarray(z["V"], dt),
                    jnp.asarray(z["bu"], dt), jnp.asarray(z["bi"], dt),
                    jnp.asarray(z["mu"], dt))
    return state, manifest


def config_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)
