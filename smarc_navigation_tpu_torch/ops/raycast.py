"""Simulated MBES ray casting on the device (PyTorch port of
``smarc_navigation_tpu/ops/raycast.py``).

Renders a multibeam ping against a flat seafloor plus spherical rock
landmarks, so that a Monte-Carlo fleet synthesizes its sonar inside the
tick loop and never touches the host:

* the beams fan across-track in the vehicle's y/z plane;
* per beam: ray/plane and ray/sphere intersections, the nearest hit wins;
* intensity: the background, or the rock reflectivity on a rock hit.

``ping_detections`` feeds the rendered ping through
``ops.sonar.extract_peaks``: sim -> perception in one call. Where the
reference vmaps these over missions, they take a leading mission axis:
pose6 (B, 6), landmarks (B, L, 3), lm_mask (B, L) -> (B, beams) ranges;
the single-mission shapes (6,), (L, 3), (L,) work too.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..utils.geometry import rotmat_from_rpy
from . import sonar


class MBESSpec(NamedTuple):
    num_beams: int = 64
    swath_rad: float = 2.0          # total fan opening
    max_range: float = 60.0
    floor_z: float = -15.0
    rock_radius: float = 1.0
    base_intensity: float = 1.0
    rock_intensity: float = 10.0


def beam_dirs_base(spec: MBESSpec, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """(beams, 3) unit beam directions in the base frame (across-track fan).
    The beam angles are the f64 ``linspace`` rounded to ``dtype``."""
    th = torch.as_tensor(np.linspace(-spec.swath_rad / 2, spec.swath_rad / 2, spec.num_beams),
                         dtype=dtype, device=device)
    return torch.stack([torch.zeros_like(th), torch.sin(th), -torch.cos(th)], dim=-1)


def render_ping(
    pose6: torch.Tensor,        # (..., 6) vehicle pose in the map frame
    landmarks: torch.Tensor,    # (..., L, 3)
    lm_mask: torch.Tensor,      # (..., L)
    spec: MBESSpec = MBESSpec(),
    dirs: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (ranges (..., beams), intensities (..., beams)) for one ping per
    mission. ``dirs`` (``beam_dirs_base``) may be given to reuse it across
    calls; the three-term dot products are summed in index order."""
    if dirs is None:
        dirs = beam_dirs_base(spec, pose6.dtype, pose6.device)
    R = rotmat_from_rpy(pose6[..., 3:6])                            # (..., 3, 3)
    # d = dirs @ R^T in the map frame: d[..., n, i] = Σ_k dirs[n, k] R[..., i, k]
    Rb = R[..., None, :, :]                                         # (..., 1, 3, 3)
    d = (dirs[:, None, 0] * Rb[..., 0] + dirs[:, None, 1] * Rb[..., 1]
         + dirs[:, None, 2] * Rb[..., 2])                           # (..., beams, 3)
    p = pose6[..., 0:3]

    # seafloor plane z = floor_z
    dz = d[..., 2]
    t_floor = (spec.floor_z - p[..., 2:3]) / torch.where(torch.abs(dz) < 1e-6,
                                                         torch.full_like(dz, -1e-6), dz)
    far = torch.full_like(t_floor, spec.max_range)
    t_floor = torch.where((t_floor > 0) & (t_floor < spec.max_range), t_floor, far)

    # spheres at the landmarks
    oc = landmarks - p[..., None, :]                                # (..., L, 3)
    ocb, db = oc[..., None, :, :], d[..., :, None, :]               # (..., 1, L, 3), (..., n, 1, 3)
    t_ca = (ocb[..., 0] * db[..., 0] + ocb[..., 1] * db[..., 1]
            + ocb[..., 2] * db[..., 2])                             # (..., beams, L)
    oc2 = oc[..., 0] * oc[..., 0] + oc[..., 1] * oc[..., 1] + oc[..., 2] * oc[..., 2]
    d2 = oc2[..., None, :] - t_ca ** 2
    r2 = spec.rock_radius ** 2
    hit = (d2 < r2) & (t_ca > 0) & lm_mask[..., None, :]
    t_hit = t_ca - torch.sqrt(torch.clamp(r2 - d2, min=0.0))
    t_hit = torch.where(hit & (t_hit > 0), t_hit, torch.full_like(t_hit, spec.max_range))
    t_rock = torch.amin(t_hit, dim=-1)                              # (..., beams)

    rock_first = t_rock < t_floor
    ranges = torch.where(rock_first, t_rock, t_floor)
    intensities = torch.where(rock_first, torch.full_like(ranges, spec.rock_intensity),
                              torch.full_like(ranges, spec.base_intensity))
    return ranges, intensities


def ping_detections(
    pose6: torch.Tensor,
    landmarks: torch.Tensor,
    lm_mask: torch.Tensor,
    spec: MBESSpec = MBESSpec(),
    max_detections: int = 8,
    dirs: torch.Tensor | None = None,
    idx: torch.Tensor | None = None,
):
    """Render + extract: from vehicle poses to base-frame landmark
    detections (what the perception layer hands the SLAM filter) ->
    (points (..., K, 3), mask (..., K)). ``dirs`` and ``idx`` (int64
    ``arange(beams)``) may be given to reuse them across calls."""
    ranges, intens = render_ping(pose6, landmarks, lm_mask, spec, dirs)
    th0 = -spec.swath_rad / 2
    dth = spec.swath_rad / (spec.num_beams - 1)
    det = sonar.extract_peaks(intens, ranges, angle_min=th0, angle_increment=dth,
                              range_max=spec.max_range, max_detections=max_detections,
                              idx=idx)
    # the beams fan in the y/z plane: (r cos a, r sin a, 0) -> base (0, y, z)
    pts = torch.stack([torch.zeros_like(det.points[..., 0]), det.points[..., 1],
                       -det.points[..., 0]], dim=-1)
    pts = torch.where(det.mask[..., None], pts, torch.zeros_like(pts))
    return pts, det.mask
