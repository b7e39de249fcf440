"""Script contracts: bench.py and chip_smoke.py measure the GPU and refuse
to run anywhere else, the platform decision lives in lws_jax.device, and
the examples run."""
import json
import os
import shutil
import subprocess
import sys

import pytest

import jax

from lws_jax import device

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


def _cpu_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _run(args, cwd=ROOT, timeout=300):
    return subprocess.run([sys.executable] + args, cwd=cwd, env=_cpu_env(),
                          capture_output=True, text=True, timeout=timeout)


def _json_lines(out):
    found = []
    for line in out.splitlines():
        try:
            found.append(json.loads(line))
        except ValueError:
            pass
    return found


def test_bench_refuses_without_gpu():
    proc = _run([os.path.join(ROOT, "bench.py"), "--config", "3"])
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr
    assert not _json_lines(proc.stdout)


def test_chip_smoke_refuses_without_gpu():
    proc = _run([os.path.join(ROOT, "chip_smoke.py")])
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr
    assert not _json_lines(proc.stdout)


def test_chip_smoke_needs_the_repository(tmp_path):
    """Alone in a directory the script cannot import the library and must
    fail without printing a result."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = _cpu_env()
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert not _json_lines(proc.stdout)


def test_platform_decision(monkeypatch):
    """gpu_available is the one platform decision; require_gpu refuses the
    CPU; describe reports what JAX sees."""
    assert device.platform() == "cpu"
    assert not device.gpu_available()
    with pytest.raises(RuntimeError, match="no GPU"):
        device.require_gpu()
    d = device.describe()
    assert d == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                 "count": len(jax.devices())}
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert device.gpu_available()
    monkeypatch.setattr(jax, "default_backend", lambda: "cuda")
    assert not device.gpu_available()


def test_compile_cache_location(monkeypatch):
    """JAX_COMPILATION_CACHE_DIR wins and nothing is set in code; otherwise
    one fixed, git-ignored directory inside the checkout."""
    set_calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: set_calls.append((k, v)))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert device.use_compile_cache() == "/elsewhere/cache"
    assert set_calls == []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    path = device.use_compile_cache()
    assert set_calls == [("jax_compilation_cache_dir", path)]
    assert path == os.path.join(ROOT, ".jax_cache")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_multichip_example_runs():
    proc = _run([os.path.join(ROOT, "examples", "multichip.py")],
                timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "data-parallel run_lws" in proc.stdout
    assert "time-sharded batch_lws" in proc.stdout
