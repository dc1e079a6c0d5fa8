"""Observability: scalar state channels, error dashboards, run reports.

Covers the reference's L5 outputs (SURVEY.md §2.5):
* ``flatten_odometry`` — the odom/tf listener nodes that fan a pose track
  out into 13 named scalar topics for controllers/NodeRED dashboards
  (``tf_convenience_topics/src/odom_listener.cpp:46-109``,
  ``tf_listener.cpp:68-128``).
* ``error_dashboard`` — the matplotlib error plots + final stats of
  ``auv_particle_filter/scripts/visual_tools.py:60-146`` and the offline
  per-axis error plots of ``rosbags/rosbag_handler.py:7-49``.
* ``run_report`` — machine-readable per-mission summary (metrics + filter
  health) the reference never had.

Port of ``smarc_navigation_tpu/io/observability.py``: the numpy functions
are the reference's; ``run_report`` goes through the port's
``metrics.summarize`` (float32 tensors on ``device``). One divergence, on
purpose: where matplotlib is not installed, ``error_dashboard(path=...)``
warns once, writes no PNG and still returns the stats (the reference raises
``ImportError``).
"""

from __future__ import annotations

import json
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from . import metrics

_warned_no_matplotlib = False


def flatten_odometry(track: np.ndarray, twist: Optional[np.ndarray] = None,
                     altitude: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
    """(T, 6) pose track [+ (T, 6) twist] -> named scalar series.

    Mirrors the 13 Float64 topics of odom_listener.cpp: roll, pitch, yaw,
    x, y, z(depth), u, v, w, p, q, r, altitude.
    """
    track = np.asarray(track)
    out = {
        "x": track[:, 0], "y": track[:, 1], "depth": track[:, 2],
        "roll": track[:, 3], "pitch": track[:, 4], "yaw": track[:, 5],
    }
    if twist is not None:
        twist = np.asarray(twist)
        for i, name in enumerate(["u", "v", "w", "p", "q", "r"]):
            out[name] = twist[:, i]
    if altitude is not None:
        out["altitude"] = np.asarray(altitude)
    return out


def _rotmat_np(rpy: np.ndarray) -> np.ndarray:
    """R(roll, pitch, yaw), batched (..., 3) -> (..., 3, 3), numpy f64."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), np.cos(y), np.sin(y)
    R = np.empty(rpy.shape[:-1] + (3, 3))
    R[..., 0, 0] = cy * cp
    R[..., 0, 1] = cy * sp * sr - sy * cr
    R[..., 0, 2] = cy * sp * cr + sy * sr
    R[..., 1, 0] = sy * cp
    R[..., 1, 1] = sy * sp * sr + cy * cr
    R[..., 1, 2] = sy * sp * cr - cy * sr
    R[..., 2, 0] = -sp
    R[..., 2, 1] = cp * sr
    R[..., 2, 2] = cp * cr
    return R


def _rotvec_np(R: np.ndarray) -> np.ndarray:
    """Batched SO(3) log: rotation matrices -> angle·axis vectors."""
    tr = np.clip((np.trace(R, axis1=-2, axis2=-1) - 1.0) / 2.0, -1.0, 1.0)
    angle = np.arccos(tr)
    skew = np.stack(
        [R[..., 2, 1] - R[..., 1, 2],
         R[..., 0, 2] - R[..., 2, 0],
         R[..., 1, 0] - R[..., 0, 1]], axis=-1
    )
    s = np.sin(angle)
    # angle/(2 sin angle), with the small-angle limit 1/2
    scale = np.where(s > 1e-8, angle / np.maximum(2.0 * s, 1e-30), 0.5)
    return skew * scale[..., None]


def twist_from_track(
    ticks: np.ndarray,
    poses: np.ndarray,          # (T, 6) [xyz, rpy] map-frame pose track
    window_s: float = 2.0,
) -> np.ndarray:
    """Average twist over a trailing window, derived from the pose track —
    tf's ``lookupTwist`` (``tf_convenience_topics/src/tf_listener.cpp:75``,
    averaging interval 2.0 s): linear = Δposition / Δt and angular =
    log(R_now · R_prevᵀ) / Δt, both in the map (observation) frame.

    Returns (T, 6) [u v w, p q r]; zeros until a full window exists.
    """
    ticks = np.asarray(ticks, np.float64)
    poses = np.asarray(poses, np.float64)
    prev = np.clip(
        np.searchsorted(ticks, ticks - window_s, side="right") - 1, 0, len(ticks) - 1
    )
    dt = ticks - ticks[prev]
    ok = dt > 1e-9
    dts = np.where(ok, dt, 1.0)
    lin = (poses[:, 0:3] - poses[prev, 0:3]) / dts[:, None]
    R_now = _rotmat_np(poses[:, 3:6])
    R_prev = _rotmat_np(poses[prev, 3:6])
    ang = _rotvec_np(R_now @ np.swapaxes(R_prev, -1, -2)) / dts[:, None]
    out = np.concatenate([lin, ang], axis=-1)
    out[~ok] = 0.0
    return out


def tf_listener_scalars(
    ticks: np.ndarray,
    poses: np.ndarray,          # (T, 6) map-frame pose track
    window_s: float = 2.0,
    altitude: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """The tf_listener node's 13 Float64 topics derived purely from the
    pose track (``tf_listener.cpp:68-128``): orientation + position from
    the transform, velocities from ``lookupTwist``, depth = −z."""
    poses = np.asarray(poses)
    tw = twist_from_track(ticks, poses, window_s)
    out = flatten_odometry(poses, twist=tw, altitude=altitude)
    out["depth"] = -poses[:, 2]  # tf_listener publishes depth = -origin.z
    return out


def have_matplotlib() -> bool:
    """Whether matplotlib imports; warns once (naming it) where it does not."""
    global _warned_no_matplotlib
    try:
        import matplotlib  # noqa: F401
        return True
    except ImportError:
        if not _warned_no_matplotlib:
            _warned_no_matplotlib = True
            warnings.warn("matplotlib is not installed: error_dashboard writes no PNG "
                          "(the stats are returned all the same)", stacklevel=3)
        return False


def error_dashboard(
    t: np.ndarray,
    tracks: Dict[str, np.ndarray],   # name -> (T, >=3) pose tracks
    gt: np.ndarray,                  # (T, >=3)
    path: Optional[str] = None,
):
    """Per-source error plots + path-length/final-error stats
    (visual_tools.py semantics). Writes a PNG if ``path`` is given and
    matplotlib is installed (else warns once and writes nothing); always
    returns the stats dict."""
    stats = {}
    for name, tr in tracks.items():
        tr = np.asarray(tr)
        err = np.linalg.norm(tr[:, :2] - gt[:, :2], axis=-1)
        stats[name] = {
            "path_length": float(np.sum(np.linalg.norm(np.diff(tr[:, :3], axis=0), axis=-1))),
            "final_error": float(err[-1]),
            "mean_error": float(err.mean()),
        }
    if path is not None and not have_matplotlib():
        return stats
    if path is not None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(2, 1, figsize=(9, 7), sharex=True)
        for name, tr in tracks.items():
            tr = np.asarray(tr)
            axes[0].plot(tr[:, 0], tr[:, 1], label=name)
            axes[1].plot(t, np.linalg.norm(tr[:, :2] - gt[:, :2], axis=-1), label=name)
        axes[0].plot(gt[:, 0], gt[:, 1], "k--", label="ground truth")
        axes[0].set_xlabel("x [m]"), axes[0].set_ylabel("y [m]"), axes[0].legend()
        axes[1].set_xlabel("t [s]"), axes[1].set_ylabel("xy error [m]"), axes[1].legend()
        fig.tight_layout()
        fig.savefig(path, dpi=110)
        plt.close(fig)
    return stats


def run_report(est_pose: np.ndarray, gt_pose: np.ndarray,
               extra: Optional[dict] = None, path: Optional[str] = None,
               device="cuda") -> dict:
    """``metrics.summarize`` of est/gt (T, 6) as float32 on ``device``,
    plus ``extra``; written as JSON to ``path`` if given."""
    def t(x):
        if isinstance(x, torch.Tensor):
            return x.to(device, torch.float32)
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)

    rep = metrics.summarize(t(est_pose), t(gt_pose))
    if extra:
        rep.update(extra)
    if path:
        with open(path, "w") as f:
            json.dump(rep, f, indent=2)
    return rep
