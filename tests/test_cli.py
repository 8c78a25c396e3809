"""CLI interface tests (the reference's positional driver signature)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _run(*args):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, "-m", "multigrid_parallel", *args],
        capture_output=True,
        text=True,
        cwd=REPO,
        env=env,
        timeout=1200,
    )


def test_cli_3d_solve():
    r = _run("5", "2", "2", "--quiet", "--tol", "1e-6")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "error vs analytic" in r.stdout
    assert "cycles:" in r.stdout


def test_cli_1d_solve():
    r = _run("5", "4", "2", "--ndim", "1", "--quiet", "--tol", "1e-6")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "cycles:" in r.stdout


def test_cli_rejects_bad_coarse_n():
    r = _run("6", "2", "2", "--quiet")
    assert r.returncode != 0
    assert "power of two" in (r.stderr + r.stdout)


def test_cli_fmg_with_mixed():
    # --fmg used to be silently dropped when combined with --mixed; now
    # solve_mixed bootstraps with an f64 FMG pass.
    r = _run("5", "2", "2", "--quiet", "--tol", "1e-6", "--mixed", "--fmg")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "cycles:" in r.stdout


def test_cli_fmg_with_electrospray_errors_loudly():
    r = _run("5", "2", "2", "--quiet", "--electrospray", "--fmg")
    assert r.returncode != 0
    assert "--fmg is not supported" in (r.stderr + r.stdout)


def test_cli_vtk_output(tmp_path):
    out = tmp_path / "err.vtk"
    r = _run("5", "2", "2", "--quiet", "--tol", "1e-6", "--vtk", str(out))
    assert r.returncode == 0, r.stderr[-2000:]
    assert out.exists()
    assert out.read_text().startswith("# vtk DataFile")


def test_cli_electrospray_mixed_depth_cap():
    # The production electrospray flags end-to-end through argparse: the
    # one-jit mixed path with a W-cycle and the gamma_min_n depth cap
    # (docs/MIXED_BC.md §4-§5). At 33^3 the cap (>=17) skips only the
    # 9-level revisit.
    r = _run("5", "4", "2", "--quiet", "--tol", "1e-6", "--electrospray",
             "--mixed", "--gamma", "2", "--gamma-min", "17", "--band", "2", "2")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "cycles:" in r.stdout


@pytest.mark.parametrize("flag", ["--fold", "--split"])
def test_cli_rejects_removed_tier_flags(flag):
    r = _run("5", "4", "2", "--quiet", "--electrospray", flag)
    assert r.returncode != 0
    assert "unrecognized arguments" in r.stderr
