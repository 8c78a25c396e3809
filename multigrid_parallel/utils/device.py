"""The accelerator a measurement ran on, and the refusal to run without one.

Every timing this package reports names its device: JAX's platform,
device kind and count, plus the card's name and power limit as
``nvidia-smi`` reads them (a card set below its maximum power limit runs
slower under load). A measurement path calls :func:`require_gpu` first
and stops when JAX found no GPU; it never falls back to the CPU.
"""

from __future__ import annotations

import subprocess

import jax


def device_info() -> dict:
    """``{"platform", "kind", "count"}`` of the devices JAX uses."""
    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def require_gpu(count: int = 1) -> dict:
    """device_info(), or SystemExit(2) unless JAX sees ``count`` GPUs."""
    info = device_info()
    if info["platform"] != "gpu" or info["count"] < count:
        raise SystemExit(
            f"needs {count} GPU(s); JAX found {info['count']} "
            f"{info['platform']} device(s)"
        )
    return info


def gpu_name_power() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` output, one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def peak_bytes_in_use(device=None):
    """Peak device bytes held by this process's arrays, or None where the
    backend keeps no allocator statistics (the CPU)."""
    stats = (device or jax.devices()[0]).memory_stats()
    return None if not stats else stats.get("peak_bytes_in_use")
