"""The device-report helpers, the refusal to measure without a GPU, and
the persistent compilation cache location."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from multigrid_parallel.utils import compile_cache
from multigrid_parallel.utils.device import (
    device_info,
    peak_bytes_in_use,
    require_gpu,
)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def restore_cache_dir():
    prev = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", prev)


def test_cache_follows_env_var(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper sets no other directory
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_defaults_to_fixed_checkout_dir(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == str(REPO / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    # the same path on every call: no pid, time or temp dir in it
    assert compile_cache.enable_compile_cache() == path
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_device_info_reports_the_backend():
    info = device_info()
    assert info == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                    "count": len(jax.devices())}


@pytest.mark.parametrize("count", (1, 4))
def test_require_gpu_refuses_cpu(count):
    with pytest.raises(SystemExit, match="needs"):
        require_gpu(count)


def test_peak_bytes_not_measured_on_cpu():
    assert peak_bytes_in_use() is None


def test_bench_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "bench.py"], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=600)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "needs 1 GPU" in r.stderr


def test_bench_run_reports_device_and_convergence(monkeypatch):
    """bench.run's record at 17^3, with the GPU check replaced by a fake
    device (the timing itself means nothing on the CPU)."""
    import bench

    fake = {"platform": "gpu", "kind": "fake", "count": 1}
    monkeypatch.setattr(bench, "require_gpu", lambda: fake)
    monkeypatch.setattr(bench, "gpu_name_power", lambda: "fake, 0 W")
    out = bench.run(levels=3, repeats=2)
    d = out["detail"]
    assert out["metric"] == "3d_poisson_17_time_to_solution"
    assert out["value"] == min(d["wall_times_s"]) and len(d["wall_times_s"]) == 2
    assert out["vs_baseline"] is None  # only 257^3 has a C baseline
    assert d["final_residual"] <= 1e-8 * d["initial_residual"]
    assert d["error_vs_analytic"] < 2e-8
    assert (d["platform"], d["device_kind"], d["device_count"]) == ("gpu", "fake", 1)
    assert d["gpu_name_power_limit"] == "fake, 0 W"
