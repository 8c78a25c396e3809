"""Per-level, per-stage timing instrumentation.

The equivalent of timing_info.h: the same 7-stage-per-level
call-count/wall-time table (stage names from mg_3d.h:136-140), gathered
two ways:

  * ``TimingInfo`` + ``profile_cycle`` — runs each V-cycle stage as its own
    jitted call with ``block_until_ready`` timing. Accurate per-stage wall
    times, at the cost of un-fusing the cycle (a jitted V-cycle fuses
    stages, so in-line host timers are meaningless there — SURVEY.md §5).
  * ``jax.named_scope`` annotations (in profile_cycle's staged fns) so
    ``jax.profiler.trace`` captures the same structure on-device.
"""

from __future__ import annotations

import time
from typing import Callable, List

import jax
import jax.numpy as jnp

# The reference's stage names, verbatim (mg_3d.h:136-137).
STAGE_NAMES = (
    "Smoother1",
    "CalcResidual1",
    "Restrict Residual",
    "Recurse, Direct Solve",
    "Prolongate&Correct",
    "Smoother2",
    "CalcResidual2",
)


class TimingInfo:
    """Call counts and cumulative wall time per stage (timing_info.h:6-12)."""

    def __init__(self, stage_names=STAGE_NAMES):
        self.stage_names = tuple(stage_names)
        self.num_calls = [0] * len(self.stage_names)
        self.time_taken = [0.0] * len(self.stage_names)

    def reset(self):
        # resetTimingInfo (timing_info.h:34-38)
        self.num_calls = [0] * len(self.stage_names)
        self.time_taken = [0.0] * len(self.stage_names)

    def record(self, stage: int, seconds: float):
        self.num_calls[stage] += 1
        self.time_taken[stage] += seconds

    def table(self) -> str:
        # printTimingInfo layout (timing_info.h:40-47)
        lines = [f"{'Stage':<24}{'numCalls':>10}{'timeTaken(s)':>16}"]
        for name, calls, t in zip(self.stage_names, self.num_calls, self.time_taken):
            lines.append(f"{name:<24}{calls:>10}{t:>16.6f}")
        return "\n".join(lines)

    def __repr__(self):
        return f"TimingInfo({dict(zip(self.stage_names, self.time_taken))})"


def timed_call(info: TimingInfo, stage: int, fn: Callable, *args):
    """Run fn, block on the result, and record wall time for `stage`."""
    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    info.record(stage, time.perf_counter() - t0)
    return out


def profile_cycle(hier, coarse_solve, cfg, u, f, infos: List[TimingInfo]):
    """One V-cycle with per-level per-stage timing into ``infos`` (one
    TimingInfo per level, coarsest first, like tInfo in mg_3d.h:26).

    The staged functions are jitted separately (cached across calls), so
    this mode measures true per-stage device time at the cost of fusion.
    """
    from multigrid_parallel.cycles import _ops, _smooth

    ops = _ops(hier.ndim)

    def smooth_fn(level, red_first):
        h = hier.spacing(level)

        @jax.jit
        def fn(u, f):
            with jax.named_scope(f"L{level}/smooth"):
                return _smooth(ops, cfg, u, f, h, red_first)

        return fn

    def resid_fn(level):
        h = hier.spacing(level)
        return jax.jit(lambda u, f: ops.residual(u, f, h))

    def _go(u, f, level):
        info = infos[level]
        if level == 0:
            return timed_call(info, 3, jax.jit(coarse_solve), f)
        u = timed_call(info, 0, smooth_fn(level, True), u, f)
        r = timed_call(info, 1, resid_fn(level), u, f)
        fc = timed_call(info, 2, jax.jit(ops.restrict_full_weighting), r)
        t0 = time.perf_counter()
        ec0 = jnp.zeros((hier.sizes[level - 1],) * hier.ndim, dtype=u.dtype)
        ec = _go(ec0, fc, level - 1)
        infos[level].record(3, time.perf_counter() - t0)
        u = timed_call(info, 4, jax.jit(ops.prolong_correct), ec, u)
        u = timed_call(info, 5, smooth_fn(level, False), u, f)
        h = hier.spacing(level)
        norm = timed_call(info, 6, jax.jit(lambda u, f: ops.residual_norm(u, f, h)), u, f)
        return u if level < hier.num_levels - 1 else (u, norm)

    return _go(u, f, hier.num_levels - 1)
