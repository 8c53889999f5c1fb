"""Fast-tier demo golds (VERDICT r4 item 9).

Two cheap end-to-end demo runs in the DEFAULT test selection, so a
regression in any printed norm surfaces without --runslow. Values pinned
to 1e-3 relative against the recorded host-CPU runs (RESULTS.md).
"""
import os
import re
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = "/root/reference/meshes"
needs_ref = pytest.mark.skipif(
    not os.path.isdir(REF), reason="reference mesh artifacts not present"
)
FLOAT = r"([-+0-9.eE]+)"


def run_demo(args, timeout=600):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run(
        [sys.executable] + args, capture_output=True, text=True,
        timeout=timeout, cwd=HERE, env=env,
    )
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    return p.stdout + p.stderr


def grab(out, pat):
    m = re.search(pat, out)
    assert m, f"pattern {pat!r} not found in demo output"
    return float(m.group(1))


@needs_ref
def test_poisson_r1_k1_gold_fast():
    """poisson --k 1 --ref 1: printed norms pinned at 1e-3 relative."""
    out = run_demo(["demos/poisson.py", "--k", "1", "--ref", "1"])
    l2 = grab(out, f"L2 norm: {FLOAT}")
    h10 = grab(out, f"H10 norm: {FLOAT}")
    assert abs(l2 - 0.20044365701574396) < 1e-3 * 0.2004
    assert abs(h10 - 0.5368716825885946) < 1e-3 * 0.5369


@needs_ref
def test_elasticity_r1_k1_gold_fast():
    """linear_elasticity --k 1 --ref 1: stress error pinned at 1e-3
    relative (demo report: linear_elasticity.py:360-366)."""
    out = run_demo(["demos/linear_elasticity.py", "--k", "1", "--ref", "1"])
    s = grab(out, f"Extraction error norm: {FLOAT}")
    assert abs(s - 0.05757853137705619) < 1e-3 * 0.0576
