"""Trajectory / filter-consistency metrics on torch tensors (port of
``smarc_navigation_tpu/io/metrics.py``).

Covers the metric definitions the reference declares but never publishes
numbers for (SURVEY.md §6): per-axis error vs ground truth
(``rosbag_handler.py:22-35``), path length and final-position error
(``visual_tools.py:60-76``) — plus the NEES/NIS consistency statistics.
Each function runs on the device of its inputs.
"""

from __future__ import annotations

import torch

from ..utils.geometry import wrap_angle
from ..utils.linalg import spd_solve


def position_errors(est_pos: torch.Tensor, gt_pos: torch.Tensor) -> torch.Tensor:
    """(T,3),(T,3) -> (T,) Euclidean position error."""
    return torch.linalg.norm(est_pos - gt_pos, dim=-1)


def rmse(est: torch.Tensor, gt: torch.Tensor, angular: bool = False) -> torch.Tensor:
    d = est - gt
    if angular:
        d = wrap_angle(d)
    return torch.sqrt(torch.mean(torch.sum(d * d, dim=-1)))


def per_axis_error(est: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """(T, D) signed per-axis error track (rosbag_handler.py style)."""
    return est - gt


def path_length(pos: torch.Tensor) -> torch.Tensor:
    """(T,3) -> scalar travelled distance (visual_tools.py:60-69)."""
    return torch.sum(torch.linalg.norm(torch.diff(pos, dim=0), dim=-1))


def final_error(est_pos: torch.Tensor, gt_pos: torch.Tensor) -> torch.Tensor:
    """Final-position error (visual_tools.py:70-76)."""
    return torch.linalg.norm(est_pos[-1] - gt_pos[-1])


def nees(err: torch.Tensor, Sigma: torch.Tensor) -> torch.Tensor:
    """Normalized estimation error squared, per step.

    err (T, n) state error (angles pre-wrapped), Sigma (T, n, n) -> (T,).
    Consistent filter: mean ≈ n.
    """
    return torch.sum(err * spd_solve(Sigma, err), dim=-1)


def nis(nu: torch.Tensor, S: torch.Tensor, mask=None) -> torch.Tensor:
    """Normalized innovation squared per measurement; mask selects real ones."""
    v = torch.sum(nu * spd_solve(S, nu), dim=-1)
    if mask is not None:
        v = torch.where(mask, v, torch.zeros_like(v))
    return v


def summarize(est_pose: torch.Tensor, gt_pose: torch.Tensor) -> dict:
    """Standard mission report: est/gt (T, 6) -> scalar metrics dict (one
    host copy of the seven scalars)."""
    err = position_errors(est_pose[:, :3], gt_pose[:, :3])
    vals = torch.stack([
        rmse(est_pose[:, :3], gt_pose[:, :3]),
        rmse(est_pose[:, 3:6], gt_pose[:, 3:6], angular=True),
        final_error(est_pose[:, :3], gt_pose[:, :3]),
        path_length(est_pose[:, :3]),
        path_length(gt_pose[:, :3]),
        torch.mean(err),
        torch.max(err),
    ]).tolist()
    keys = ("rmse_pos", "rmse_att", "final_error", "path_length_est", "path_length_gt",
            "mean_error", "max_error")
    return dict(zip(keys, vals))
