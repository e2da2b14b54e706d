"""chip_smoke.py: refuses to run without a GPU, and its phases work.

The phases run here at a tiny size on the CPU (4 KB blocks, a handful of
items; the Pallas kernels through the interpreter). On the card the script
runs them at full size; see its docstring.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from bench import make_corpus  # noqa: E402
from tpu_zstd import CompressionConfig  # noqa: E402


@pytest.fixture(scope="module")
def small():
    cfg = dataclasses.replace(CompressionConfig.from_level(3), block_size=4096, hash_log=13)
    corpus = make_corpus(160_000, seed=5)
    items = [corpus[i * 4096:(i + 1) * 4096] for i in range(6)]
    return cfg, corpus, items


def _run(script: pathlib.Path, cwd: pathlib.Path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, str(script)], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=600,
    )


def test_exits_nonzero_without_gpu():
    r = _run(REPO / "chip_smoke.py", REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_exits_nonzero_without_the_package(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(tmp_path / "chip_smoke.py", tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_phase_batch_compress(small):
    cfg, _, items = small
    info = cs.phase_batch_compress(items, cfg)
    assert info["bytes_verified"] == sum(len(x) for x in items)
    assert info["degradations"] == 0 and "native engine" in info["decoders"]


def test_phase_device_decompress(small):
    cfg, _, items = small
    info = cs.phase_device_decompress(items, cfg)
    assert info["bytes_verified"] == sum(len(x) for x in items)


def test_phase_single_shot(small):
    cfg, corpus, _ = small
    info = cs.phase_single_shot(corpus[:30_000], cfg)
    assert info["bytes_verified"] == 30_000


def test_phase_hybrid(small):
    cfg, corpus, _ = small
    info = cs.phase_hybrid(corpus[30_000:50_000], cfg)
    assert info["backend"] == ["TPU_KERNELS", "TPU_KERNELS"]


def test_phase_kernels_interpret(small):
    cfg, _, items = small
    info = cs.phase_kernels(items, cfg, interpret=True)
    assert info["shapes"]["rep_codes"][0] == len(items)


def test_phase_four_on_virtual_devices(small):
    # tests/conftest.py gives the CPU backend 8 virtual devices.
    cfg, corpus, _ = small
    info = cs.phase_four(corpus, 2, cfg)
    assert info["frames_identical"] == 8


def test_phase_fails_loudly_on_a_wrong_frame(small, monkeypatch):
    cfg, _, items = small
    from tpu_zstd.utils import native

    monkeypatch.setattr(native.NativeEngine, "decompress", lambda self, f, n: b"")
    with pytest.raises(AssertionError, match="native engine mismatch"):
        cs.verify_frames([b"x"], [items[0]])
