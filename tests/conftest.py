"""Test configuration: the CPU backend with a virtual 8-device mesh, so the
sharding tests run without accelerators, and the Pallas kernels run in the
interpreter where a test asks for it. Tests marked `gpu` need a CUDA card:
they skip here, and run on the card with

    RUN_GPU_TESTS=1 python -m pytest -m gpu -n 0 tests/
"""

import os

ON_GPU = os.environ.get("RUN_GPU_TESTS") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

from tpu_zstd import platform  # noqa: E402

# Persistent compilation cache: the suite's dominant cost is re-compiling the
# same staged-pipeline shapes in every xdist worker process (and again on a
# second run). With the cache, only the first worker to reach a shape pays
# LLVM; everyone else (including back-to-back reruns) loads the compiled
# executable from disk. Also shrinks the per-process accumulated-compile count
# that triggers the XLA:CPU LLVM crash.
platform.init_compile_cache()

import signal

import numpy as np
import pytest

DEFAULT_TIMEOUT_S = 900


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "timeout(seconds): per-test wall-clock limit (SIGALRM)"
    )


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    """Per-test wall-clock limit via SIGALRM (pytest-timeout is not
    installed). A hung compile or device call raises instead of wedging the
    whole worker — a suite that stalls silently cannot gate correctness."""
    limit = DEFAULT_TIMEOUT_S
    m = item.get_closest_marker("timeout")
    if m and m.args:
        limit = int(m.args[0])

    def _on_alarm(signum, frame):
        raise TimeoutError(f"test exceeded {limit}s wall-clock limit")

    old = signal.signal(signal.SIGALRM, _on_alarm)
    signal.alarm(limit)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture
def gpu():
    """Skip unless the CUDA GPU kernels are in use (decided at run time)."""
    if not platform.use_gpu_kernels():
        pytest.skip("needs a CUDA GPU; its check also runs as a chip_smoke.py phase")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0xC0FFEE)


def _gen_cases(rng):
    return {
        "empty": b"",
        "one_byte": b"a",
        "short_text": b"hello world, hello zstd",
        "rle": b"\x55" * 3000,
        "repetitive": b"abcabcabcabc" * 200,
        "cycle256": bytes(range(256)) * 8,
        "random_4k": rng.integers(0, 256, 4096, dtype=np.uint8).tobytes(),
        "low_entropy": rng.integers(0, 8, 8192, dtype=np.uint8).tobytes(),
        "text": b"the quick brown fox jumps over the lazy dog. " * 300,
        "mixed": b"".join(
            bytes(rng.integers(0, 256, 64, dtype=np.uint8)) + b"COMMON-PATTERN" * 8
            for _ in range(40)
        ),
        "multiblock": b"some repetitive content 0123456789 " * 9000,  # > 128 KiB
    }


@pytest.fixture(scope="session")
def corpus(rng):
    return _gen_cases(rng)
