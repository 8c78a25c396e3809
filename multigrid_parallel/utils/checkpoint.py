"""Checkpoint / resume of solver state.

The reference has no checkpointing (SURVEY.md §5) — its only artifacts
are end-of-run VTK dumps. Since the functional solver state is just the
finest (u, f) pair plus static hyper-parameters, save/resume here is a
single compressed npz with a metadata header; a half-finished solve
resumes bit-exactly (the cycle is a pure function of (u, f)).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from multigrid_parallel.cycles import CycleConfig
from multigrid_parallel.hierarchy import Hierarchy

_FORMAT_VERSION = 1


def save_state(
    path: str,
    u: jnp.ndarray,
    f: jnp.ndarray,
    hier: Hierarchy,
    cfg: Optional[CycleConfig] = None,
    extra: Optional[dict] = None,
) -> None:
    meta = {
        "format_version": _FORMAT_VERSION,
        "hierarchy": {
            "ndim": hier.ndim,
            "coarse_n": hier.coarse_n,
            "num_levels": hier.num_levels,
            "length": hier.length,
            "dtype": np.dtype(hier.dtype).name,
        },
        "cycle_config": dataclasses.asdict(cfg) if cfg else None,
        "extra": extra or {},
    }
    np.savez_compressed(
        path, u=np.asarray(u), f=np.asarray(f), meta=json.dumps(meta)
    )


def load_state(path: str) -> Tuple[jnp.ndarray, jnp.ndarray, Hierarchy, Optional[CycleConfig], dict]:
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["meta"]))
        if meta["format_version"] > _FORMAT_VERSION:
            raise ValueError(f"checkpoint from newer format: {meta['format_version']}")
        hm = meta["hierarchy"]
        hier = Hierarchy(
            ndim=hm["ndim"],
            coarse_n=hm["coarse_n"],
            num_levels=hm["num_levels"],
            length=hm["length"],
            dtype=jnp.dtype(hm["dtype"]),
        )
        cfg = CycleConfig(**meta["cycle_config"]) if meta["cycle_config"] else None
        u = jnp.asarray(data["u"], dtype=hier.dtype)
        f = jnp.asarray(data["f"], dtype=hier.dtype)
        return u, f, hier, cfg, meta["extra"]
