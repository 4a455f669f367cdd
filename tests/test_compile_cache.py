"""Placement of the persistent compilation cache (phlash_tpu/__init__.py).

JAX reads JAX_COMPILATION_CACHE_DIR only at its own import, so the package
sets the directory through jax.config; each case runs in a fresh process.
"""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dir(env_value):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    out = subprocess.run(
        [sys.executable, "-c",
         "import phlash_tpu, jax; print(jax.config.jax_compilation_cache_dir)"],
        env=env, capture_output=True, text=True, check=True, timeout=120, cwd=ROOT,
    )
    return out.stdout.strip().splitlines()[-1]


def test_cache_dir_follows_environment(tmp_path):
    assert _cache_dir(str(tmp_path)) == str(tmp_path)


@pytest.mark.parametrize("env_value", [None, ""])
def test_cache_dir_defaults_to_checkout(env_value):
    assert _cache_dir(env_value) == os.path.join(ROOT, ".jax_cache")
