"""The one place that asks JAX which machine the codec runs on.

Every other module decides through these functions, never by reading
`jax.default_backend()` or a device's `device_kind` itself:

- `use_gpu_kernels()`: whether the hand-written Pallas kernels (Triton route,
  `ops/pallas_rep.py`, `ops/pallas_greedy.py`) run. True on a CUDA GPU; on
  the CPU the plain `lax.scan` references run instead. Interpret mode is
  never chosen here: only tests ask for it.
- `accelerator_available()`: whether JAX sees a device other than the CPU.
- `device_summary()`: platform, device kind and count, as benchmark and
  smoke-test lines report them.
- `init_compile_cache()`: the persistent compilation cache shared by the
  tests and the entry scripts.
"""

from __future__ import annotations

import os

import jax

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def backend() -> str:
    """JAX's default backend platform: "gpu" on a CUDA card, "cpu" here."""
    return jax.default_backend()


def use_gpu_kernels() -> bool:
    """True when the Triton-route Pallas kernels are compiled for the card."""
    return backend() == "gpu"


def accelerator_available() -> bool:
    """True when JAX sees an accelerator (any device that is not the CPU)."""
    try:
        return any(d.platform != "cpu" for d in jax.devices())
    except RuntimeError:
        return False


def device_summary() -> dict:
    """{"platform", "kind", "count"} of the devices JAX uses by default."""
    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def compile_cache_dir() -> str:
    """$JAX_COMPILATION_CACHE_DIR when set, else `<repo>/.jax_cache`."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(_REPO, ".jax_cache")


def init_compile_cache(min_compile_secs: float = 0.5) -> str:
    """Point JAX's persistent compilation cache at `compile_cache_dir()`."""
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", min_compile_secs)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
