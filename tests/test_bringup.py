"""What keeps a run honest about its device: the compile-cache placement,
the GPU-only entry points refusing the CPU, chip_smoke's result line, and
the device-memory limit the out-of-core budget starts from."""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

from ycnr_tpu.utils import compile_cache
from ycnr_tpu.utils.device import require_accelerator_unless_cpu_asked

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fake_jax(platforms="", backend="cpu"):
    """A stand-in for the jax module: records config updates."""
    seen = {}
    config = types.SimpleNamespace(jax_platforms=platforms,
                                   update=lambda k, v: seen.__setitem__(k, v))
    return types.SimpleNamespace(config=config,
                                 default_backend=lambda: backend), seen


def _cache_updates(monkeypatch):
    """Record every jax.config update enable_compile_cache makes."""
    fake, seen = _fake_jax()
    monkeypatch.setattr(compile_cache, "jax", fake)
    return seen


def test_compile_cache_uses_env_dir_when_set(monkeypatch, tmp_path):
    seen = _cache_updates(monkeypatch)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert seen["jax_compilation_cache_dir"] == str(tmp_path)


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    seen = _cache_updates(monkeypatch)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert seen["jax_compilation_cache_dir"] == path
    # nothing derived from /tmp, a uid or a pid
    assert not path.startswith("/tmp") and str(os.getpid()) not in path


def test_compile_cache_sets_no_other_dir(monkeypatch, tmp_path):
    seen = _cache_updates(monkeypatch)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    compile_cache.enable_compile_cache("gpu")
    dirs = {v for k, v in seen.items() if "dir" in k}
    assert dirs == {str(tmp_path)}
    # an explicit CPU run sets no cache at all
    seen.clear()
    assert compile_cache.enable_compile_cache("cpu") is None
    assert seen == {}


def test_compile_cache_on_for_gpu_first_platform_list(monkeypatch, tmp_path):
    fake, seen = _fake_jax("cuda,cpu")
    monkeypatch.setattr(compile_cache, "jax", fake)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    fake.config.jax_platforms = "cpu"
    assert compile_cache.enable_compile_cache() is None


def test_cli_sets_cache_only_through_the_helper():
    import ycnr_tpu.cli as cli

    src = open(cli.__file__).read()
    assert "jax_compilation_cache_dir" not in src
    assert "YCNR_COMPILE_CACHE" not in src and "/tmp" not in src


@pytest.mark.parametrize("flag,env,ok", [
    ("cpu", "", True), (None, "cpu", True), (None, "", False),
    ("cuda", "", False), (None, "cuda,cpu", False)])
def test_cpu_fallback_needs_asking(monkeypatch, flag, env, ok):
    from ycnr_tpu.utils import device

    monkeypatch.setattr(device, "jax", _fake_jax(env, "cpu")[0])
    if ok:
        require_accelerator_unless_cpu_asked(flag)
    else:
        with pytest.raises(SystemExit, match="no accelerator"):
            require_accelerator_unless_cpu_asked(flag)


def _run(args, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu():
    p = _run(["chip_smoke.py"])
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
    assert "needs the GPU backend" in p.stderr


def test_bench_refuses_cpu_outside_smoke():
    p = _run(["bench.py", "--epochs", "1"])
    assert p.returncode != 0 and p.stdout == ""
    assert "needs the GPU backend" in p.stderr


def test_chip_smoke_result_line(monkeypatch, capsys):
    sys.path.insert(0, ROOT)
    import chip_smoke

    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    monkeypatch.setattr(chip_smoke, "phase_device", lambda cards: dev)
    ran = []
    for name in ("phase_kernel", "phase_ref", "phase_ooc"):
        monkeypatch.setattr(chip_smoke, name,
                            lambda *a, n=name: ran.append(n))
    monkeypatch.setattr(chip_smoke, "phase_main",
                        lambda *a: ran.append("phase_main") or {"rmse": []})
    chip_smoke.main([])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": dev}
    assert last == ('{"ok": true, "device": {"platform": "gpu", "kind": '
                    '"NVIDIA H100 80GB HBM3", "count": 1}}')
    assert ran == ["phase_kernel", "phase_main", "phase_ref", "phase_ooc"]


def test_chip_smoke_cards_runs_only_the_card_phase(monkeypatch, capsys):
    sys.path.insert(0, ROOT)
    import chip_smoke

    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}
    monkeypatch.setattr(chip_smoke, "phase_device", lambda cards: dev)
    ran = []
    for name in ("phase_kernel", "phase_main", "phase_ref", "phase_ooc",
                 "phase_cards"):
        monkeypatch.setattr(chip_smoke, name,
                            lambda *a, n=name: ran.append(n))
    chip_smoke.main(["--cards", "4"])
    assert ran == ["phase_cards"]
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["device"]["count"] == 4


def test_device_memory_limit_cpu_is_host_ram():
    from ycnr_tpu.models.ooc import device_memory_limit

    lim = device_memory_limit()
    assert lim == os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def test_device_memory_limit_refuses_silent_accelerator():
    from ycnr_tpu.models.ooc import device_memory_limit

    fake = types.SimpleNamespace(platform="gpu", memory_stats=lambda: {})
    with pytest.raises(RuntimeError, match="no bytes_limit"):
        device_memory_limit(fake)
    told = types.SimpleNamespace(platform="gpu",
                                 memory_stats=lambda: {"bytes_limit": 7})
    assert device_memory_limit(told) == 7


def test_bf16_copy_cap_scales_with_device_memory(monkeypatch):
    import jax.numpy as jnp

    from ycnr_tpu.models import ooc

    assert ooc.bf16_copy_max_bytes(80 * 2**30) == 80 * 2**30 // 32
    monkeypatch.setattr(ooc, "device_memory_limit",
                        lambda device=None: 32 * 1000)
    # a [100, 5] f32 factor's bf16 copy is 1000 bytes: exactly the cap
    assert ooc._phase_bf16(jnp.zeros((100, 5), jnp.float32), True)
    assert not ooc._phase_bf16(jnp.zeros((101, 5), jnp.float32), True)
    assert not ooc._phase_bf16(jnp.zeros((100, 5), jnp.float32), False)


def test_orbax_missing_is_a_clear_error(monkeypatch):
    from ycnr_tpu.train import checkpoint

    monkeypatch.setitem(sys.modules, "orbax", None)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    with pytest.raises(RuntimeError, match="orbax-checkpoint package"):
        checkpoint.orbax_checkpoint()


def test_inverse_cdf_matches_searchsorted():
    from ycnr_tpu.data.synthetic import _inverse_cdf

    rng = np.random.default_rng(0)
    for n in (1, 3, 1000, 50_000):
        p = 1.0 / np.arange(1, n + 1)
        rng.shuffle(p)
        c = np.cumsum(p)
        c /= c[-1]
        x = rng.random(200_000)
        x[:2] = (0.0, np.nextafter(1.0, 0.0))
        np.testing.assert_array_equal(_inverse_cdf(c, x),
                                      np.searchsorted(c, x))
