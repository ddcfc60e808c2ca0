"""Runtime setup: where the persistent compilation cache lands, and the
smoke script's refusal to run without a GPU. Each case is its own process
(cache setup is once per process)."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROG = """
import sys
sys.path.insert(0, {repo!r})
import jax, jax.numpy as jnp
from jasper_tpu.utils.jaxenv import setup_compilation_cache
print(setup_compilation_cache())
c = float(sys.argv[1])  # a constant unique to this run: a new cache entry
jax.jit(lambda x: x * c + 1)(jnp.arange(8.0)).block_until_ready()
"""


def _run(env_dir, tmp_path):
    import uuid

    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    prog = tmp_path / "prog.py"
    prog.write_text(_PROG.format(repo=REPO))
    c = str(1 + uuid.uuid4().int % 10**6 / 7.0)
    r = subprocess.run([sys.executable, str(prog), c], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return r.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("from_env", [True, False])
def test_compile_cache_location(from_env, tmp_path):
    from jasper_tpu.utils.jaxenv import CACHE_DIR

    want = str(tmp_path / "cc") if from_env else CACHE_DIR
    before = set(os.listdir(want)) if os.path.isdir(want) else set()
    got = _run(want if from_env else None, tmp_path)
    assert os.path.abspath(got) == os.path.abspath(want)
    assert CACHE_DIR == os.path.join(REPO, ".jax_cache")
    assert set(os.listdir(want)) - before, "no cache entry written there"


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       env=env, capture_output=True, text=True, timeout=300,
                       cwd=REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr
