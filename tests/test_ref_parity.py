"""Cross-package parity vs. the actual reference implementation.

Runs tools/ref_parity.py in a subprocess (it imports the reference's pure
modules from /root/reference/src with dependency stubs and needs its own
x64/module-namespace state, which must not leak into this test process).
See the tool's docstring for the check list; rc 0 = full parity.
"""

import os
import subprocess
import sys

import pytest

REF_SRC = os.environ.get("PHLASH_REF_SRC", "/root/reference/src")
TOOL = os.path.join(os.path.dirname(__file__), "..", "tools", "ref_parity.py")


@pytest.mark.heavy  # ~18 min of f64 scan compiles on a 1-core host
@pytest.mark.skipif(
    not os.path.isdir(os.path.join(REF_SRC, "phlash")),
    reason="reference source tree not available",
)
def test_cross_package_parity():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, TOOL],
        env=env,
        capture_output=True,
        text=True,
        timeout=1700,
    )
    assert r.returncode == 0, f"parity harness failed:\n{r.stdout}\n{r.stderr}"
    assert "PARITY PASS" in r.stdout


@pytest.mark.heavy  # two tiny full fits (ours + re-enacted reference), ~8 min
@pytest.mark.skipif(
    not os.path.isdir(os.path.join(REF_SRC, "phlash")),
    reason="reference source tree not available",
)
def test_posterior_reproduction_quick():
    """North-star closure at the posterior level: tools/posterior_repro.py
    composes the reference's own pure modules with the vendored blackjax
    sampler semantics into a runnable reference fit, runs both packages on
    one simulated dataset, and compares the posterior clouds (cross-package
    TV of medians + mutual 95%-band coverage).  --quick here (smoke
    thresholds); the full-size run + thresholds are recorded in
    POSTERIOR_REPRO.json."""
    tool = os.path.join(os.path.dirname(__file__), "..", "tools", "posterior_repro.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, tool, "--quick"],
        env=env,
        capture_output=True,
        text=True,
        timeout=1700,
    )
    assert r.returncode == 0, f"posterior repro failed:\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}"
    assert "POSTERIOR REPRO PASS" in r.stdout
