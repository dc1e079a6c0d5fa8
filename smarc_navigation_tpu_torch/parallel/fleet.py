"""Mission fleets: ``batch_timelines`` and the combined PF + SLAM mission
``run_combined``. The SLAM+PF mission fleet (``run_fleet``/``fleet_step``/
``init_fleet``) and the raycast fleet are not ported yet (ROADMAP.md
Queue 1)."""

from __future__ import annotations

import numpy as np
import torch

from ..configs import EKFSlamConfig, PFConfig
from ..models import ekf_slam as slam
from ..models import particle_filter as pf
from ..ops.timeline import Timeline


def _structure(tl: Timeline):
    return (tuple(tl.channels), tuple(tl.windows), tuple(tl.events))


def batch_timelines(timelines: list) -> Timeline:
    """Stack per-mission numpy-leaved Timelines into one batched Timeline
    (leading mission axis B) on the host; ``.to(device)`` ships it.

    Every timeline must have the same channels and the same leaf shapes and
    dtypes as the first — checked for ALL of them, so a mismatched mission
    raises here instead of surfacing as a broadcast error mid-replay."""
    if not timelines:
        raise ValueError("batch_timelines needs at least one timeline")
    first = timelines[0]
    ref = [(np.shape(x), np.asarray(x).dtype) for x in first.leaves()]
    for b, tl in enumerate(timelines[1:], start=1):
        if _structure(tl) != _structure(first) or tl.dt != first.dt:
            raise ValueError(
                f"timeline {b} has channels {_structure(tl)} / dt {tl.dt}, "
                f"timeline 0 has {_structure(first)} / dt {first.dt}")
        got = [(np.shape(x), np.asarray(x).dtype) for x in tl.leaves()]
        if got != ref:
            raise ValueError(
                f"timeline {b} leaf shapes/dtypes {got} differ from "
                f"timeline 0's {ref}")
    leaves_per_tl = [tl.leaves() for tl in timelines]
    stacked = iter([np.stack(xs, axis=0) for xs in zip(*leaves_per_tl)])
    return first.map(lambda _x: next(stacked))


def run_combined(
    tl_slam: Timeline,            # batched (B=1) SLAM timeline, tensor leaves
    tl_pf: Timeline,              # single-mission PF timeline, tensor leaves
    slam_params: slam.SlamParams,
    slam_cfg: EKFSlamConfig,
    pf_params: pf.PFParams,
    pf_cfg: PFConfig,
    n_particles: int,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """One mission replayed through both estimators on their kernel paths:
    the particle bank through the segmented multi-tick predict
    (``particle_filter.run`` with ``use_pallas=True``: K5 + K7) and the
    EKF-SLAM filter through the event-compacted path
    (``ekf_slam.run_fleet_compact``: K1 + K2 on event ticks only). Returns
    one scalar that depends on both outputs."""
    _final_pf, out_pf = pf.run(
        tl_pf, pf_params, pf_cfg, n_particles=n_particles, generator=generator,
        scheme="systematic", use_pallas=True)
    final_s, _out_s = slam.run_fleet_compact(tl_slam, slam_params, slam_cfg)
    return (torch.sum(out_pf["mean"]) + torch.sum(final_s.mu[:, 0:6])
            + torch.sum(final_s.n_active))
