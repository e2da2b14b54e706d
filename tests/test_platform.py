"""The platform module: the one place that decides which machine runs."""

from __future__ import annotations

import pathlib
import re

import pytest

from tpu_zstd import platform

PKG = pathlib.Path(__file__).resolve().parent.parent / "tpu_zstd"


@pytest.mark.parametrize("backend,want", [("cpu", False), ("gpu", True)])
def test_kernel_choice(monkeypatch, backend, want):
    monkeypatch.setattr(platform, "backend", lambda: backend)
    assert platform.use_gpu_kernels() is want


def test_cpu_backend_here():
    # The test run forces the CPU backend (tests/conftest.py).
    assert platform.backend() == "cpu"
    assert platform.use_gpu_kernels() is False
    assert platform.accelerator_available() is False


def test_device_summary():
    s = platform.device_summary()
    assert s["platform"] == "cpu"
    assert isinstance(s["kind"], str) and s["count"] >= 1


def test_is_tpu_available_is_the_accelerator_check(monkeypatch):
    import tpu_zstd

    monkeypatch.setattr(platform, "accelerator_available", lambda: True)
    assert tpu_zstd.is_tpu_available() is True
    monkeypatch.setattr(platform, "accelerator_available", lambda: False)
    assert tpu_zstd.is_tpu_available() is False


@pytest.mark.parametrize("env", [True, False])
def test_compile_cache_dir(monkeypatch, tmp_path, env):
    if env:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert platform.compile_cache_dir() == str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = PKG.parent / ".jax_cache"
        assert pathlib.Path(platform.compile_cache_dir()) == want


def _sources():
    for p in sorted(PKG.rglob("*.py")):
        if p.name != "platform.py":
            yield p, p.read_text()


def test_no_platform_checks_outside_platform_module():
    bad = []
    for p, src in _sources():
        for pat in (r"default_backend\(", r"device_kind", r"pallas\.tpu",
                    r"pallas import tpu", r"""["']tpu["']"""):
            if re.search(pat, src):
                bad.append(f"{p.relative_to(PKG)}: {pat}")
    assert not bad, bad


def test_library_never_chooses_interpret_mode():
    bad = [str(p.relative_to(PKG)) for p, src in _sources()
           if re.search(r"interpret\s*=\s*(True|[a-z_.]*default_backend)", src)]
    assert not bad, bad
