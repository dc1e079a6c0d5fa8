"""Sensor conditioning & frame-bootstrap glue (reference layer L1).

Pure-function equivalents of the small rospy conditioning nodes
(SURVEY.md §2.3): GPS→UTM odometry with dual-antenna heading
(``sam_dead_reckoning/scripts/gps_node.py:42-129``), the one-shot
utm→map / map→odom frame bootstraps (``gps_node.py:49-66``,
``dr_node.py:110-148``, ``uw_gps/scripts/aux_dr_node.py:62-113``),
SBG yaw→heading (``yaw_2_heading.py:22-26``), GPS-track heading spoofing
(``spoof_gps_imu.py``), covariance-overriding IMU republishing
(``republish_yost_odom.py:31-60``), and lat/lon waypoint/buoy markers
(``wp_vis_node.py:30-54``, ``algae_map.py:33-61``).

Everything here is host-side preprocessing that runs once per fix/stream
while building mission timelines — no ROS, no callbacks, no state.
Port of ``smarc_navigation_tpu/models/sensors.py``: absolute-UTM math stays
in host float64 numpy, bit for bit the reference's; only the local frames
(``bootstrap_map_odom``, the heading rotation of ``gps_world_correction``)
are float32 tensors, on ``device``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np

import torch

from ..utils import geodesy
from ..utils.geometry import Transform, rpy_from_quat


class UtmOdometry(NamedTuple):
    easting: np.ndarray
    northing: np.ndarray
    heading: Optional[np.ndarray] = None  # dual-antenna only


def gps_to_utm_odometry(lat_deg, lon_deg, zone: int, status=None) -> UtmOdometry:
    """NavSatFix stream -> UTM odometry; fixes with status == -1 (no fix)
    are dropped (``gps_node.py:42-44``)."""
    lat = np.asarray(lat_deg, np.float64)
    lon = np.asarray(lon_deg, np.float64)
    if status is not None:
        ok = np.asarray(status) != -1
        lat, lon = lat[ok], lon[ok]
    e, n = geodesy.latlon_to_utm(lat, lon, zone, xp=np)
    return UtmOdometry(easting=e, northing=n)


def dual_antenna_fix(
    lat_prt, lon_prt, lat_stb, lon_stb, zone: int
) -> UtmOdometry:
    """Port/starboard antenna pair -> midpoint + heading
    (``gps_node.py:81-94``): heading = atan2(ΔE, ΔN) − π/2 of prt−stb."""
    e_p, n_p = geodesy.latlon_to_utm(np.asarray(lat_prt), np.asarray(lon_prt), zone, xp=np)
    e_s, n_s = geodesy.latlon_to_utm(np.asarray(lat_stb), np.asarray(lon_stb), zone, xp=np)
    d_n, d_e = n_p - n_s, e_p - e_s
    heading = np.arctan2(d_e, d_n) - np.pi / 2.0
    return UtmOdometry(
        easting=(e_p + e_s) / 2.0, northing=(n_p + n_s) / 2.0, heading=heading
    )


def bootstrap_utm_map(first_easting: float, first_northing: float) -> Transform:
    """One-shot static utm->map transform anchored at the first fix
    (``gps_node.py:49-66``: identity rotation, translation = first fix).

    Host-side frame: the fields are numpy float64, NOT device arrays —
    absolute UTM coordinates (~6.5e6 m Baltic northings) lose ~0.4 m to
    f32 quantization, so all absolute-UTM math stays in host f64
    (``utm_points_to_map``) and only local map-frame offsets go to device.
    """
    return Transform(
        rot=np.eye(3, dtype=np.float64),
        trans=np.array([first_easting, first_northing, 0.0], np.float64),
    )


def _host_f64(x) -> np.ndarray:
    """A numpy array or a tensor (on any device) as host float64."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def utm_points_to_map(pts_utm: np.ndarray, utm_map: Transform) -> np.ndarray:
    """Absolute UTM points (N, 3) -> map frame, entirely in host float64
    (the inverse-apply of ``utm_map`` without any f32 round trip)."""
    rot = _host_f64(utm_map.rot)
    trans = _host_f64(utm_map.trans)
    pts = np.atleast_2d(np.asarray(pts_utm, np.float64))
    return (pts - trans) @ rot  # rows: rotᵀ(p - t)


def bootstrap_map_odom(
    gps_map_xy: np.ndarray, sbg_heading_quat: np.ndarray, device="cuda"
) -> Transform:
    """One-shot map->odom: translation = first GPS fix in map frame, yaw from
    the SBG heading (``dr_node.py:110-148``; roll/pitch zeroed). A float32
    Transform on ``device``."""
    f32 = dict(dtype=torch.float32, device=device)
    q = torch.as_tensor(np.asarray(sbg_heading_quat), **f32)
    yaw = float(rpy_from_quat(q)[2])
    return Transform.from_rpy_trans(
        torch.tensor([0.0, 0.0, yaw], **f32),
        torch.tensor([float(gps_map_xy[0]), float(gps_map_xy[1]), 0.0], **f32),
    )


def gps_world_correction(
    gps_utm_e: float,
    gps_utm_n: float,
    heading_quat: np.ndarray,   # (4,) xyzw from the heading IMU
    odom_base: Transform,       # T(odom <- base_link), the DR estimate
    world_utm_local: Transform, # T(world_utm <- world_local)
    device="cuda",
) -> Transform:
    """The publish_gps_path corrector (``sam_dead_reckoning/scripts/
    publish_gps_path.py:96-126``): from a UTM GPS fix + IMU heading and
    the current DR odom->base estimate, compute the world_local->world
    correction transform

        correction = T_utm_local⁻¹ · T_gps · T_odom_base⁻¹

    (the UTM-frame GPS pose pulled back into the local world frame, with
    the vehicle's own odometry factored out). Absolute-UTM translation
    math stays in host f64 per utm_points_to_map's rule — compose the
    rotation parts normally but carry translations in numpy. The heading
    rotation is built in float32 on ``device``, as the reference builds it
    on its device; the result is a float64 numpy Transform.
    """
    q = torch.as_tensor(np.asarray(heading_quat), dtype=torch.float32, device=device)
    rot_gps = _host_f64(Transform.from_quat_trans(q, torch.zeros(3, device=device)).rot)
    w_rot = _host_f64(world_utm_local.rot)
    w_trans = _host_f64(world_utm_local.trans)
    o_rot = _host_f64(odom_base.rot)
    o_trans = _host_f64(odom_base.trans)
    g_trans = np.array([gps_utm_e, gps_utm_n, 0.0], np.float64)

    # W⁻¹ · G
    rot_wg = w_rot.T @ rot_gps
    trans_wg = w_rot.T @ (g_trans - w_trans)
    # · O⁻¹
    rot = rot_wg @ o_rot.T
    trans = trans_wg - rot @ o_trans
    return Transform(rot=rot, trans=trans)


def yaw_to_heading_deg(yaw_rad) -> np.ndarray:
    """ENU yaw -> compass heading in degrees (``yaw_2_heading.py:22-26``:
    heading = 90 − yaw°, wrapped to [0, 360))."""
    deg = 90.0 - np.rad2deg(np.asarray(yaw_rad))
    return np.mod(deg, 360.0)


def spoof_heading_from_track(easting: np.ndarray, northing: np.ndarray,
                             min_step: float = 0.05) -> np.ndarray:
    """Heading spoofer for IMU-less tests (``spoof_gps_imu.py``): yaw from
    consecutive GPS fixes; holds the previous value for sub-threshold steps."""
    e = np.asarray(easting, np.float64)
    n = np.asarray(northing, np.float64)
    yaw = np.zeros(len(e))
    last = 0.0
    for i in range(1, len(e)):
        de, dn = e[i] - e[i - 1], n[i] - n[i - 1]
        if np.hypot(de, dn) >= min_step:
            last = np.arctan2(dn, de)
        yaw[i] = last
    return yaw


def override_covariances(
    orientation_cov_diag: Tuple[float, float, float] = (0.01, 0.01, 0.01),
    rate_cov_diag: Tuple[float, float, float] = (0.01, 0.01, 0.01),
) -> Tuple[np.ndarray, np.ndarray]:
    """The Yost-IMU republisher exists only to stamp sane covariances onto
    an IMU whose ROS node reports zeros (``republish_yost_odom.py:31-60``)."""
    return np.diag(orientation_cov_diag), np.diag(rate_cov_diag)


def latlon_markers_to_map(
    lats, lons, zone: int, utm_map: Transform, z: float = 0.0
) -> np.ndarray:
    """Waypoints / buoy fields given in lat/lon -> map-frame positions
    (``wp_vis_node.py:30-54``, ``algae_map.py:33-61``)."""
    e, n = geodesy.latlon_to_utm(np.asarray(lats), np.asarray(lons), zone, xp=np)
    pts_utm = np.stack([e, n, np.full_like(e, z)], -1)
    return utm_points_to_map(pts_utm, utm_map)  # absolute UTM stays f64
