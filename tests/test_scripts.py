# -*- coding: utf-8 -*-
"""The GPU scripts refuse to run without a GPU: non-zero exit, no result."""

import os
import subprocess
import sys

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_script_fails_without_gpu(script):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, os.path.join(REPO_ROOT, script)], env=env, cwd=REPO_ROOT,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert "no GPU" in out.stderr, out.stderr
    assert '"ok"' not in out.stdout and '"metric"' not in out.stdout, out.stdout
