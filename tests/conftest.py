"""Test config: force a virtual 8-device CPU platform.

Bench and production run on the GPU; tests exercise the same code on a
host-only mesh (multi-device sharding paths included). jax is already imported
by the jaxtyping pytest plugin before this file runs, so env vars alone are
too late — use jax.config.update, which works post-import (backends only
initialize at first use).
"""

import os
import sys

# CPU unless the caller picked a platform (the card's tests run with
# JAX_PLATFORMS=cuda -m gpu); subprocesses inherit the choice
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
try:
    jax.config.update("jax_num_cpu_devices", 8)
except Exception:
    pass  # XLA_FLAGS fallback above

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
