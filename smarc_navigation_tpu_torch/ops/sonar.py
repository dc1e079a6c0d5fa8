"""Sonar perception: landmark extraction from raw sonar data (PyTorch port
of ``smarc_navigation_tpu/ops/sonar.py``).

* ``extract_peaks`` — the sidescan/MBES LaserScan peak extractor
  (``sonar_manipulator.hpp:44-97``): 5-tap mean smoothing, adaptive
  threshold (mean intensity, disabled when the signal is flat), runs of
  consecutive over-threshold beams, the middle-of-run beam -> polar ->
  cartesian point in the sensor frame, compacted into a fixed-K detection
  bank with a validity mask. No host loop and no data-dependent shape.
* ``detect_blobs`` — the FLS rock detector (``fls_rock_detector.cpp:
  69-150``): box blur, threshold, connected components by iterative
  min-label propagation, area- and circularity-gated centroids; pixel ->
  FLS-frame coordinates (rows - y - 1, x - cols/2) (``:119-137``).
* ``fuse_submap`` — the MBES submap builder (``mbes_receptor.cpp:64-107``);
  ``save_pcd`` its host-side ASCII PCD dump.

Where the reference vmaps a single-scan function, these take leading batch
axes: ``extract_peaks`` on (..., n) scans, ``detect_blobs`` and
``connected_components`` on (..., H, W) images. The discrete outputs
(detection masks and beams, blob areas and masks) do not depend on the
summation order of a backend: the 5-tap smoother sums its taps in a fixed
order, and the blob sums are integer-valued (exact in f32 below 2^24, so
``index_add_``'s atomics on the card change nothing).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F


class Detections(NamedTuple):
    points: torch.Tensor  # (..., K, 3) sensor-frame cartesian points
    mask: torch.Tensor    # (..., K)


def smooth_intensities(intensities: torch.Tensor) -> torch.Tensor:
    """5-tap mean filter; the 2 edge beams on each side pass through raw
    (``sonar_manipulator.hpp:44-59``). The weighted taps are summed in a
    fixed order, ((t0 + t1) + (t2 + t3)) + t4: the reference's
    ``jnp.convolve`` on the CPU gives these bits."""
    x = intensities
    n = x.shape[-1]
    if n < 5:
        return x
    t = [x[..., k:n - 4 + k] * 0.2 for k in range(5)]
    inner = ((t[0] + t[1]) + (t[2] + t[3])) + t[4]
    return torch.cat([x[..., :2], inner, x[..., -2:]], dim=-1)


def adaptive_threshold(smoothed: torch.Tensor, range_max) -> torch.Tensor:
    """Mean-intensity threshold per scan; if the mean is within ±10 % of the
    max the scan is flat (no target) and the threshold is pushed out of
    reach (``sonar_manipulator.hpp:61-66``)."""
    mean = torch.mean(smoothed, dim=-1)
    mx = torch.amax(smoothed, dim=-1)
    flat = (mean >= 0.9 * mx) & (mean <= 1.1 * mx)
    if not isinstance(range_max, torch.Tensor):
        range_max = mean.new_full((), range_max)    # a fill: no host data on the card
    return torch.where(flat, range_max * 10.0, mean)


def extract_peaks(
    intensities: torch.Tensor,  # (..., n) beam intensities
    ranges: torch.Tensor,       # (..., n) beam ranges
    angle_min,
    angle_increment,
    range_max,
    max_detections: int = 8,
    idx: torch.Tensor | None = None,
) -> Detections:
    """Scans -> up to K sensor-frame landmark points each.

    Runs of hot beams come from two scans, as in the reference: a reversed
    ``cummin`` finds each run's exclusive end, a ``cumsum`` numbers the
    valid runs; the K-slot compaction is a masked reduction over beams.
    ``idx`` (int64 ``arange(n)`` on the scans' device) may be given to
    reuse it across calls (a CUDA graph's tick must not build it)."""
    n = intensities.shape[-1]
    dtype, dev = intensities.dtype, intensities.device
    if idx is None:
        idx = torch.arange(n, device=dev)
    smoothed = smooth_intensities(intensities)
    thresh = adaptive_threshold(smoothed, range_max)

    # over-threshold beams; beam 0 can never fire (the reference stores the
    # beam index with 0 as the empty sentinel, sonar_manipulator.hpp:67-73)
    hot = (smoothed >= 1.05 * thresh[..., None]) & (idx > 0)

    # run-length segmentation: a run's exclusive end is the first non-hot
    # index at or after it (reversed cummin)
    prev_hot = torch.cat([torch.zeros_like(hot[..., :1]), hot[..., :-1]], dim=-1)
    run_start = hot & ~prev_hot
    nonhot_at = torch.where(hot, torch.full_like(idx, n), idx)
    run_end = torch.flip(torch.cummin(torch.flip(nonhot_at, (-1,)), dim=-1).values, (-1,))
    run_len = torch.where(run_start, run_end - idx, torch.zeros_like(idx))

    # middle-of-run beam (size//2 for even, (size+1)//2 for odd: the
    # reference's off-centre pick, sonar_manipulator.hpp:82-86)
    offset = torch.where(run_len % 2 == 0, run_len // 2, (run_len + 1) // 2)
    mid = torch.clamp(idx + offset, 0, n - 1)
    valid_run = run_start & (run_len > 1)

    # the k-th valid run's quantities are masked sums over the beam axis
    slot = torch.cumsum(valid_run.to(torch.int64), dim=-1) - 1
    ks = idx[:max_detections] if max_detections <= n else torch.arange(max_detections, device=dev)
    onehot = (slot[..., None, :] == ks[:, None]) & valid_run[..., None, :]   # (..., K, n)
    det_beam = torch.sum(torch.where(onehot, mid[..., None, :], torch.zeros_like(mid[..., None, :])),
                         dim=-1)
    det_mask = torch.any(onehot, dim=-1)

    alpha = angle_min + angle_increment * det_beam.to(dtype)
    # the range sampled at the mid beam
    mid_oh = (idx == det_beam[..., None]) & det_mask[..., None]              # (..., K, n)
    r = torch.sum(torch.where(mid_oh, ranges[..., None, :], torch.zeros_like(ranges[..., None, :])),
                  dim=-1)
    pts = torch.stack([r * torch.cos(alpha), r * torch.sin(alpha), torch.zeros_like(r)], dim=-1)
    pts = torch.where(det_mask[..., None], pts, torch.zeros_like(pts))
    return Detections(points=pts, mask=det_mask)


def scans_to_base(
    det_left: Detections,
    det_right: Detections,
    rot_base_left: torch.Tensor,
    trans_base_left: torch.Tensor,
    rot_base_right: torch.Tensor,
    trans_base_right: torch.Tensor,
) -> Detections:
    """ApproximateTime-synced left/right sonar pair -> base-frame PoseArray
    (``mbes_receptor.cpp:68-109``)."""
    l_pts = det_left.points @ rot_base_left.T + trans_base_left
    r_pts = det_right.points @ rot_base_right.T + trans_base_right
    pts = torch.cat([torch.where(det_left.mask[..., None], l_pts, torch.zeros_like(l_pts)),
                     torch.where(det_right.mask[..., None], r_pts, torch.zeros_like(r_pts))],
                    dim=-2)
    return Detections(points=pts, mask=torch.cat([det_left.mask, det_right.mask], dim=-1))


# ---------------------------------------------------------------------------
# FLS blob detection
# ---------------------------------------------------------------------------

def _box_1d(x: torch.Tensor, k: int) -> torch.Tensor:
    """Mean of k taps along the last axis, numpy's ``convolve(..., "same")``
    alignment (zero padding: k//2 before, (k-1)//2 after)."""
    n = x.shape[-1]
    xp = F.pad(x, (k // 2, (k - 1) // 2))
    w = 1.0 / k
    out = xp[..., 0:n] * w
    for j in range(1, k):
        out = out + xp[..., j:j + n] * w
    return out


def box_blur(img: torch.Tensor, k: int = 5) -> torch.Tensor:
    """Separable k×k box blur (the stand-in for the reference's
    GaussianBlur): rows, then columns."""
    img = _box_1d(img, k)
    return _box_1d(img.transpose(-1, -2), k).transpose(-1, -2)


def connected_components(mask: torch.Tensor, iters: int = 64) -> torch.Tensor:
    """Min-label propagation over the 4-neighbourhood of (..., H, W) masks;
    labels are flat pixel indices, background -1. ``iters`` bounds the
    largest blob diameter; the loop always runs ``iters`` rounds (an early
    exit would be a host sync)."""
    H, W = mask.shape[-2:]
    big = H * W
    flat = torch.arange(big, device=mask.device).reshape(H, W)
    lab = torch.where(mask, flat, torch.full_like(flat, big))
    for _ in range(iters):
        pad = F.pad(lab, (1, 1, 1, 1), value=big)
        neigh = torch.minimum(torch.minimum(pad[..., :-2, 1:-1], pad[..., 2:, 1:-1]),
                              torch.minimum(pad[..., 1:-1, :-2], pad[..., 1:-1, 2:]))
        lab = torch.where(mask, torch.minimum(lab, neigh), torch.full_like(lab, big))
    return torch.where(mask, lab, torch.full_like(lab, -1))


def detect_blobs(
    img: torch.Tensor,         # (..., H, W) intensity image
    threshold: float = 0.5,    # relative to the max after the blur
    min_area: int = 600,       # SimpleBlobDetector params (fls_rock_detector.cpp:93-102,174-176)
    max_area: int = 5000,
    max_blobs: int = 8,
    cc_iters: int = 96,
    min_circularity: float = 0.1,  # fls_rock_detector.cpp:96-97,176
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (centroids_px (..., K, 2) as (x, y), areas (..., K) int32, mask
    (..., K)).

    The circularity gate is SimpleBlobDetector's 4πA/P² filter
    (``fls_rock_detector.cpp:95-97``) with the perimeter counted as the
    component's 4-neighbourhood boundary edges."""
    H, W = img.shape[-2:]
    lead = img.shape[:-2]
    dev, dtype = img.device, img.dtype
    hw = H * W
    blurred = box_blur(img, 5)
    mask = blurred >= threshold * torch.amax(blurred, dim=(-2, -1), keepdim=True)
    lab = connected_components(mask, cc_iters)

    flat = lab.reshape(lead + (hw,))
    pix = torch.arange(hw, device=dev)
    ys = torch.div(pix, W, rounding_mode="floor").to(dtype)
    xs = (pix % W).to(dtype)
    on = flat >= 0
    safe = torch.where(on, flat, torch.zeros_like(flat))

    # boundary-edge count per pixel: 4-neighbours that are off or outside
    pad = F.pad(mask, (1, 1, 1, 1), value=False)
    nbr_off = ((~pad[..., :-2, 1:-1]).to(torch.int32) + (~pad[..., 2:, 1:-1]).to(torch.int32)
               + (~pad[..., 1:-1, :-2]).to(torch.int32)
               + (~pad[..., 1:-1, 2:]).to(torch.int32)).reshape(lead + (hw,))

    # per-component sums, scattered to the root's flat index (one row per
    # image: the batch folds into the scatter index)
    nb = math.prod(lead)
    base = (torch.arange(nb, device=dev) * hw)[:, None]
    tgt = (safe.reshape(nb, hw) + base).reshape(-1)
    zi = torch.zeros(nb * hw, dtype=torch.int32, device=dev)
    zf = torch.zeros(nb * hw, dtype=dtype, device=dev)
    onf = on.reshape(-1)
    area = zi.index_add(0, tgt, onf.to(torch.int32)).reshape(lead + (hw,))
    perim = zi.index_add(0, tgt, torch.where(onf, nbr_off.reshape(-1), 0)).reshape(lead + (hw,))
    sx = zf.index_add(0, tgt, torch.where(onf, xs.expand(lead + (hw,)).reshape(-1), 0.0)
                      ).reshape(lead + (hw,))
    sy = zf.index_add(0, tgt, torch.where(onf, ys.expand(lead + (hw,)).reshape(-1), 0.0)
                      ).reshape(lead + (hw,))

    circ = (4.0 * math.pi) * area / torch.clamp(perim * perim, min=1).to(dtype)
    is_root = (flat == pix) & on
    good = is_root & (area >= min_area) & (area <= max_area) & (circ >= min_circularity)

    # the k-th good root's quantities are masked sums over pixels
    slot = torch.cumsum(good.to(torch.int64), dim=-1) - 1
    ks = torch.arange(max_blobs, device=dev)
    onehot = (slot[..., None, :] == ks[:, None]) & good[..., None, :]       # (..., K, hw)
    cnt = torch.clamp(area, min=1).to(dtype)

    def pick(v):
        return torch.sum(torch.where(onehot, v[..., None, :], torch.zeros_like(v[..., None, :])),
                         dim=-1)

    out_area = pick(area).to(torch.int32)
    out_x = pick(sx / cnt)
    out_y = pick(sy / cnt)
    out_mask = torch.any(onehot, dim=-1)
    return torch.stack([out_x, out_y], dim=-1), out_area, out_mask


def blobs_to_fls_frame(centroids_px: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Keypoint pixels -> FLS-frame pixel coordinates (z=0):
    x' = rows - y - 1, y' = x - cols/2 (``fls_rock_detector.cpp:119-137``)."""
    x, y = centroids_px[..., 0], centroids_px[..., 1]
    return torch.stack([rows - y - 1.0, x - cols / 2.0, torch.zeros_like(x)], dim=-1)


# ---------------------------------------------------------------------------
# MBES submap fusion
# ---------------------------------------------------------------------------

def fuse_submap(
    ping_points: torch.Tensor,    # (P, B, 3) beam points in the sensor frame
    ping_mask: torch.Tensor,      # (P, B)
    rot_map_ping: torch.Tensor,   # (P, 3, 3) map<-sensor rotation per ping
    trans_map_ping: torch.Tensor,  # (P, 3)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fuse a window of pings into the middle ping's frame
    (``mbes_mapper/src/mbes_receptor.cpp:64-107``).

    Returns (points (P·B, 3) in the mid-ping frame, mask (P·B,))."""
    mid = ping_points.shape[0] // 2
    pts_map = (torch.einsum("pij,pbj->pbi", rot_map_ping, ping_points)
               + trans_map_ping[:, None, :])
    r_mid_t = rot_map_ping[mid].T
    pts_mid = torch.einsum("ij,pbj->pbi", r_mid_t, pts_map - trans_map_ping[mid])
    return pts_mid.reshape(-1, 3), ping_mask.reshape(-1)


def save_pcd(
    path: str,
    points,                # (N, 3) submap points (masked rows dropped)
    mask=None,             # (N,) optional validity mask
    viewpoint_trans=None,  # (3,) submap frame origin in map (sensor_origin_)
    viewpoint_quat=None,   # (4,) xyzw (sensor_orientation_)
) -> int:
    """Persist a fused submap as an ASCII PCD v0.7 file, the reference's
    ``pcl::io::savePCDFileASCII`` dump per submap
    (``mbes_mapper/src/mbes_receptor.cpp:92-106``), with the VIEWPOINT
    header carrying the submap frame's map pose. Host side; tensors are
    copied to numpy. Returns the number of points written."""
    import os

    import numpy as np

    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    pts = np.asarray(host(points), np.float64).reshape(-1, 3)
    if mask is not None:
        pts = pts[host(mask).reshape(-1)]
    vp_t = [0.0, 0.0, 0.0] if viewpoint_trans is None else list(
        np.asarray(host(viewpoint_trans), np.float64))
    # PCD VIEWPOINT order is (tx ty tz qw qx qy qz)
    if viewpoint_quat is None:
        q = [1.0, 0.0, 0.0, 0.0]
    else:
        vq = host(viewpoint_quat)
        q = [float(vq[3]), float(vq[0]), float(vq[1]), float(vq[2])]
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    n = len(pts)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
        f"WIDTH {n}\nHEIGHT 1\n"
        "VIEWPOINT " + " ".join(f"{v:.9g}" for v in (vp_t + q)) + "\n"
        f"POINTS {n}\nDATA ascii\n"
    )
    with open(path, "w") as f:
        f.write(header)
        for x, y, z in pts:
            f.write(f"{x:.9g} {y:.9g} {z:.9g}\n")
    return n
