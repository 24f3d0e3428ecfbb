# -*- coding: utf-8 -*-
"""Where the package puts JAX's persistent compilation cache (subprocess:
the setting is made once, when the package is imported)."""

import os
import subprocess
import sys

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = "import jax, remo3d_jax; print(repr(jax.config.jax_compilation_cache_dir))"


@pytest.mark.parametrize(
    "platforms, env_dir, expected",
    [
        # An accelerator run with no JAX_COMPILATION_CACHE_DIR: a fixed path
        # inside the checkout.
        ("gpu", None, os.path.join(REPO_ROOT, ".jax_cache")),
        # JAX_COMPILATION_CACHE_DIR set: JAX's own reading of it stands.
        ("gpu", "/nonexistent/cache-from-env", "/nonexistent/cache-from-env"),
        # Pure-CPU runs keep no cache.
        ("cpu", None, None),
    ],
)
def test_compilation_cache_dir(platforms, env_dir, expected):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = platforms
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    env["PYTHONPATH"] = REPO_ROOT
    out = subprocess.run(
        [sys.executable, "-c", PROBE], env=env, cwd=REPO_ROOT,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == repr(expected)
