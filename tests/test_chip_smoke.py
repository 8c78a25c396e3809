"""chip_smoke.py: its phases at small size on the CPU backend, its
refusal to run without a GPU, and its last line.

The full-size phases need the card. They carry the ``gpu`` marker and
skip here; on a GPU machine run them with

    JAX_PLATFORMS=cuda python -m pytest tests/test_chip_smoke.py -m gpu
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

import chip_smoke as cs
from multigrid_parallel.ops import stencils_3d as ops3

REPO = Path(__file__).resolve().parents[1]


def _run_script(args, cwd=REPO):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py", *args], capture_output=True,
        text=True, cwd=cwd, env=env, timeout=600,
    )


def test_phase_c_parity_33():
    out = cs.phase_c_parity(levels=4)
    assert out["grid"] == 33 and out["n_cycles"] == out["c_cycles"] == 14
    assert out["cli_n_cycles"] == 14
    assert out["error"] <= out["error_tol"]
    lo, hi = cs.RATIO_RANGE
    assert lo <= out["ratio_min"] <= out["ratio_max"] <= hi


@pytest.mark.parametrize("wrong", ({"cycles": 20}, {"err": 1e-10}))
def test_phase_c_parity_fails_on_wrong_fingerprint(monkeypatch, wrong):
    cycles, err = cs.C_REFERENCE[33]
    monkeypatch.setitem(cs.C_REFERENCE, 33,
                        (wrong.get("cycles", cycles), wrong.get("err", err)))
    with pytest.raises(cs.SmokeFailure):
        cs.phase_c_parity(levels=4)


def test_phase_perf_path_17():
    out = cs.phase_perf_path(levels=3, repeats=2)
    assert out["grid"] == 17 and len(out["warm_s"]) == 2
    assert out["n_cycles"] == out["f64_n_cycles"]
    assert out["error"] <= out["error_tol"]
    assert out["rel_l2_vs_f64"] <= out["rel_l2_tol"]


def test_phase_electrospray_17():
    out = cs.phase_electrospray(levels=3)
    assert out["grid"] == 17 and out["gamma_min_n"] == 5
    assert out["n_cycles"] == out["host_n_cycles"]
    assert out["max_abs_diff_V"] <= out["tol_V"]


def test_phase_transfer_small():
    out = cs.phase_transfer(levels=(3, 4), repeats=1)
    for n in (17, 33):
        for form in cs.FORMS:
            assert out[f"solve_{n}_{form}"]["n_cycles"] > 0
        for dt in ("float32", "float64"):
            assert set(out[f"ops_{n}_{dt}"]) == {
                f"{op}_{form}_ms" for op in ("restrict", "prolong")
                for form in cs.FORMS}
    assert out["half_sweep"]["grid"] == 33
    assert out["half_sweep"]["bytes"] == 3 * 4 * 33 ** 3


def test_transfer_form_restores_operators():
    before = ops3.restrict_full_weighting, ops3.prolong_correct
    for form in cs.FORMS:
        with cs._transfer_form(form):
            assert ops3.prolong_correct is getattr(ops3, f"prolong_correct_{form}")
        assert (ops3.restrict_full_weighting, ops3.prolong_correct) == before


def test_phase_four_17_on_four_cpu_devices():
    out = cs.phase_four(levels=3, n_dev=4)
    assert out["slabs_1d"]["n_cycles"] == out["single"]["n_cycles"]
    assert out["slabs_1d"]["rel_l2"] <= out["rel_l2_tol"]
    assert out["mesh_2d"]["mesh"] == [2, 2]
    assert out["mesh_2d"]["rel_l2"] <= out["rel_l2_tol"]
    assert out["electrospray_1d"]["max_abs_diff_V"] <= out["electrospray_1d"]["tol_V"]


def test_phase_device_refuses_cpu():
    with pytest.raises(SystemExit):
        cs.phase_device()


@pytest.mark.parametrize("args", ([], ["--four"]))
def test_script_refuses_without_gpu(args):
    r = _run_script(args)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs" in r.stderr


def test_script_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_script([], cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("count", (1, 4))
def test_result_line_format(count):
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count,
           "extra": "dropped"}
    line = cs.result_line(dev)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count}}


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda -m gpu)")


@pytest.mark.gpu
@pytest.mark.parametrize("name", [name for name, _ in cs.ONE_CARD_PHASES])
def test_phase_full_size_on_gpu(gpu, name):
    jax.config.update("jax_enable_x64", True)
    out = dict(cs.ONE_CARD_PHASES)[name]()
    assert out
