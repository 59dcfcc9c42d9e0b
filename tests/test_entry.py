"""Entry points: the choice of backend, the refusal to measure without a
GPU (bench.py, bench_suite, chip_smoke.py), the compile-cache directory,
and a rehearsal of chip_smoke.py's phases at a tiny size on the CPU."""

import importlib.util
import json
import pathlib
import shutil
import subprocess
import sys

import jax
import pytest

from latticeboltzmann_tpu.models import engine
from latticeboltzmann_tpu.utils import compile_cache, device

REPO = pathlib.Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(name, REPO / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _FakeDevice:
    def __init__(self, platform, kind):
        self.platform = platform
        self.device_kind = kind


@pytest.mark.parametrize("name", ["xla", "pallas", "sharded"])
def test_resolve_backend_keeps_explicit_names(name):
    assert engine.resolve_backend(name) == name


def test_resolve_auto_is_xla_off_gpu():
    assert jax.default_backend() == "cpu"
    assert engine.resolve_backend("auto") == "xla"


def test_resolve_auto_on_gpu(monkeypatch):
    monkeypatch.setattr(engine.jax, "default_backend", lambda: "gpu")
    assert engine.resolve_backend("auto") == engine.GPU_BACKEND
    assert engine.GPU_BACKEND in engine.available_backends()
    assert "interpret" not in engine.GPU_BACKEND


def test_require_gpu_accepts_a_gpu():
    devs = [_FakeDevice("gpu", "NVIDIA H100 80GB HBM3")] * 4
    assert device.require_gpu(devs) == {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4
    }


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        device.require_gpu()
    assert device.describe()["platform"] == "cpu"


def test_nvidia_smi_missing(monkeypatch):
    def missing(*a, **k):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(device.subprocess, "run", missing)
    assert device.nvidia_smi().startswith("unavailable")


def test_bench_refuses_without_gpu(capsys):
    assert _load("bench").main([]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "no GPU" in out.err


def test_bench_suite_refuses_without_gpu(capsys):
    from latticeboltzmann_tpu import bench_suite

    assert bench_suite.main(["--quick"]) == 2
    assert capsys.readouterr().out == ""


def test_chip_smoke_refuses_without_gpu(capsys):
    assert _load("chip_smoke").main([]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "no GPU" in out.err


def test_chip_smoke_alone_fails(tmp_path):
    """Copied out of the repository, the script finds no engine and
    prints no result."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
        text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin:/usr/local/bin", "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode != 0 and proc.stdout == ""


def _rehearsal(monkeypatch):
    """chip_smoke.py at a tiny size, the kernel interpreted, with the GPU
    check faked: every phase's control flow and comparison, on the CPU."""
    smoke = _load("chip_smoke")
    monkeypatch.setattr(device, "require_gpu", device.describe)
    monkeypatch.setattr(smoke, "KERNEL", "pallas-interpret")
    monkeypatch.setattr(smoke, "SCENE", (24, 48))
    monkeypatch.setattr(smoke, "GOLDEN", (16, 40))
    monkeypatch.setattr(smoke, "GOLDEN_STEPS", 6)
    monkeypatch.setattr(smoke, "SERVED_STEPS", 8)
    monkeypatch.setattr(smoke, "PARITY_STEPS", 6)
    monkeypatch.setattr(smoke, "MEASURE_STEPS", {(24, 48): 4, (16, 64): 2})
    return smoke


@pytest.mark.parametrize("argv,phases", [([], "abcde"), (["--multi"], "af")])
def test_chip_smoke_rehearsal(monkeypatch, capsys, argv, phases):
    smoke = _rehearsal(monkeypatch)
    assert smoke.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    assert {ln[1] for ln in lines[:-1] if ln.startswith("[")} == set(phases)
    assert json.loads(lines[-1]) == {"ok": True, "device": device.describe()}
    assert jax.config.jax_enable_x64  # the suite's setting survives phase d


def test_cache_dir_unset_is_repo_default():
    assert compile_cache.cache_dir({}) == str(REPO / ".jax_cache")
    assert compile_cache.cache_dir({compile_cache.ENV_VAR: ""}) == str(REPO / ".jax_cache")


def test_cache_dir_follows_variable():
    assert compile_cache.cache_dir({compile_cache.ENV_VAR: "/x/cache"}) == "/x/cache"


def test_enable_defers_to_variable(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert compile_cache.enable({compile_cache.ENV_VAR: "/x/cache"}) == "/x/cache"
    assert calls == []


def test_enable_sets_repo_default(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert compile_cache.enable({}) == str(REPO / ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", str(REPO / ".jax_cache"))]
