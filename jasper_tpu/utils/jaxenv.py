"""JAX runtime configuration shared by every entry point.

The first jit of each counting/scan program shape compiles; the persistent
compilation cache makes that a once-per-cache cost instead of a
once-per-process cost. Library code calls setup_compilation_cache() lazily
before the first device work; it is idempotent.

Where the cache lives: JAX_COMPILATION_CACHE_DIR when it is set (JAX reads
it itself, and nothing here overrides it); otherwise one fixed directory
inside the checkout, CACHE_DIR.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)

_DONE = False


def setup_compilation_cache() -> str:
    """Enable JAX's persistent compilation cache (idempotent); returns the
    cache directory."""
    global _DONE
    import jax

    if not _DONE:
        if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            os.makedirs(CACHE_DIR, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
        _DONE = True
    return jax.config.jax_compilation_cache_dir


def gpu_devices(count: int = 1) -> list:
    """jax.devices() when JAX found at least ``count`` GPUs; otherwise a
    RuntimeError. Measurement entry points call this instead of falling
    back to the CPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"no GPU: JAX found {devs[0].platform} devices")
    if len(devs) < count:
        raise RuntimeError(f"need {count} GPUs, JAX found {len(devs)}")
    return devs


def nvidia_smi() -> list[str]:
    """One 'name, power.limit' line per card, as nvidia-smi reports them."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
