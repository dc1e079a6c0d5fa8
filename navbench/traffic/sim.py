"""Frozen copy of the port's mission simulator (``io/sim.py``), the
benchmark's own: lawnmower survey ground truth, stamped sensor streams and
MBES landmark detections in the base frame, all numpy from one seed.
``navbench/tests/test_traffic.py`` holds its output to checksums recorded
from the port's generator when the copy was made, so a later change to the
port's simulator leaves the benchmark's traffic as it is.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


def _rotmat_from_rpy(rpy: np.ndarray) -> np.ndarray:
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    row0 = np.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1)
    row1 = np.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1)
    row2 = np.stack([-sp, cp * sr, cp * cr], -1)
    return np.stack([row0, row1, row2], -2)


def _quat_from_rpy(rpy: np.ndarray) -> np.ndarray:
    hr, hp, hy = rpy[..., 0] / 2, rpy[..., 1] / 2, rpy[..., 2] / 2
    cr, sr = np.cos(hr), np.sin(hr)
    cp, sp = np.cos(hp), np.sin(hp)
    cy, sy = np.cos(hy), np.sin(hy)
    return np.stack(
        [
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
            cr * cp * cy + sr * sp * sy,
        ],
        -1,
    )


@dataclasses.dataclass
class MissionSpec:
    duration_s: float = 120.0
    sim_hz: float = 100.0          # ground-truth integration rate
    speed_mps: float = 0.8
    yaw_rate_amp: float = 0.15     # lawnmower wiggle [rad/s]
    yaw_rate_period_s: float = 40.0
    depth_amp_m: float = 3.0       # dive profile amplitude
    depth_period_s: float = 60.0
    pitch_amp: float = 0.08
    roll_amp: float = 0.03
    num_landmarks: int = 24
    landmark_area_m: float = 80.0
    landmark_depth_m: float = -12.0
    mbes_hz: float = 5.0
    mbes_range_m: float = 25.0
    mbes_swath_rad: float = 1.0    # half-swath around straight-down/side
    imu_hz: float = 100.0
    dvl_hz: float = 10.0
    depth_hz: float = 10.0
    gps_hz: float = 1.0
    gps_surface_z: float = -0.5    # GPS only above this depth
    # noise stds (0 => ideal sensors)
    imu_rpy_std: float = 0.0
    imu_gyro_std: float = 0.0
    dvl_std: float = 0.0
    depth_std: float = 0.0
    gps_std: float = 0.0
    mbes_std: float = 0.0
    dvl_bias: tuple = (0.0, 0.0, 0.0)     # constant body-frame velocity bias
    dvl_dropout: Optional[tuple] = None   # (t_start, t_end) seconds
    seed: int = 0


@dataclasses.dataclass
class Mission:
    """Ground truth + raw stamped sensor streams for one mission."""

    spec: MissionSpec
    t: np.ndarray            # (S,) GT times
    pos: np.ndarray          # (S, 3) GT position, odom/map frame
    rpy: np.ndarray          # (S, 3) GT attitude
    vel_body: np.ndarray     # (S, 3) GT body velocity
    gyro: np.ndarray         # (S, 3) GT body rates (as rpy rates)
    landmarks: np.ndarray    # (L, 3) map-frame landmark positions
    streams: Dict[str, dict] # sensor name -> {"stamps": (M,), "values": (M,D)}

    def gt_at(self, times: np.ndarray) -> np.ndarray:
        """Interpolate GT 6-DOF pose at arbitrary times -> (T, 6)."""
        out = np.zeros((len(times), 6))
        for d in range(3):
            out[:, d] = np.interp(times, self.t, self.pos[:, d])
        # angles: interpolate via unwrap to avoid seam artifacts
        for d in range(3):
            unwrapped = np.unwrap(self.rpy[:, d])
            a = np.interp(times, self.t, unwrapped)
            out[:, 3 + d] = (a + np.pi) % (2 * np.pi) - np.pi
        return out


def simulate(spec: MissionSpec = MissionSpec()) -> Mission:
    rng = np.random.default_rng(spec.seed)
    n = int(spec.duration_s * spec.sim_hz) + 1
    t = np.arange(n) / spec.sim_hz
    dt = 1.0 / spec.sim_hz

    # --- ground-truth attitude ---------------------------------------------
    yaw_rate = spec.yaw_rate_amp * np.sin(2 * np.pi * t / spec.yaw_rate_period_s)
    yaw = np.cumsum(yaw_rate) * dt
    pitch = spec.pitch_amp * np.sin(2 * np.pi * t / spec.depth_period_s)
    roll = spec.roll_amp * np.sin(2 * np.pi * t / 15.0)
    rpy = np.stack([roll, pitch, yaw], -1)
    rpy_rates = np.gradient(rpy, dt, axis=0)

    # --- ground-truth velocity / position ----------------------------------
    w_z = -spec.depth_amp_m * (2 * np.pi / spec.depth_period_s) * np.cos(
        2 * np.pi * t / spec.depth_period_s
    ) * 0.2
    vel_body = np.stack(
        [np.full(n, spec.speed_mps), 0.02 * np.sin(2 * np.pi * t / 23.0), w_z], -1
    )
    R = _rotmat_from_rpy(rpy)
    vel_odom = np.einsum("tij,tj->ti", R, vel_body)
    pos = np.cumsum(vel_odom, axis=0) * dt
    pos[:, 2] -= 0.5  # start just below surface

    # --- landmarks ----------------------------------------------------------
    lm_xy = rng.uniform(-0.1, 1.0, size=(spec.num_landmarks, 2)) * spec.landmark_area_m
    lm_z = spec.landmark_depth_m + rng.uniform(-2.0, 2.0, spec.num_landmarks)
    landmarks = np.concatenate([lm_xy, lm_z[:, None]], -1)

    def sample(hz):
        m = int(spec.duration_s * hz)
        stamps = (np.arange(m) + 1.0) / hz
        idx = np.clip((stamps * spec.sim_hz).astype(int), 0, n - 1)
        return stamps, idx

    streams: Dict[str, dict] = {}

    # IMU: quaternion + body rates
    s_imu, i_imu = sample(spec.imu_hz)
    rpy_noisy = rpy[i_imu] + rng.normal(0, spec.imu_rpy_std, (len(i_imu), 3))
    gyro = rpy_rates[i_imu] + rng.normal(0, spec.imu_gyro_std, (len(i_imu), 3))
    streams["imu"] = {
        "stamps": s_imu,
        "values": np.concatenate([_quat_from_rpy(rpy_noisy), gyro], -1),  # (M, 7)
    }

    # DVL: body velocities (with optional dropout window)
    s_dvl, i_dvl = sample(spec.dvl_hz)
    keep = np.ones(len(s_dvl), bool)
    if spec.dvl_dropout is not None:
        a, b = spec.dvl_dropout
        keep &= ~((s_dvl >= a) & (s_dvl <= b))
    streams["dvl"] = {
        "stamps": s_dvl[keep],
        "values": vel_body[i_dvl][keep] + np.asarray(spec.dvl_bias)
        + rng.normal(0, spec.dvl_std, (keep.sum(), 3)),
    }

    # Depth (already converted from pressure; see utils.geodesy.pressure_to_depth)
    s_dep, i_dep = sample(spec.depth_hz)
    streams["depth"] = {
        "stamps": s_dep,
        "values": (pos[i_dep, 2] + rng.normal(0, spec.depth_std, len(i_dep)))[:, None],
    }

    # GPS: map-frame x/y fix, only when near surface
    s_gps, i_gps = sample(spec.gps_hz)
    surfaced = pos[i_gps, 2] > spec.gps_surface_z
    streams["gps"] = {
        "stamps": s_gps[surfaced],
        "values": pos[i_gps][surfaced][:, :2]
        + rng.normal(0, spec.gps_std, (int(surfaced.sum()), 2)),
    }

    # Control inputs (rpm, thrust-vector angle) — simple cruise profile
    s_ctl, _ = sample(10.0)
    streams["control"] = {
        "stamps": s_ctl,
        "values": np.stack([np.full(len(s_ctl), 400.0), np.zeros(len(s_ctl))], -1),
    }

    # MBES landmark detections in base frame (perception-layer output)
    s_mbes, i_mbes = sample(spec.mbes_hz)
    det_stamps, det_values, det_burst = [], [], []
    for b, (ts, ig) in enumerate(zip(s_mbes, i_mbes)):
        R_t = R[ig]
        rel = (landmarks - pos[ig]) @ R_t  # map -> base frame
        rng_ok = np.linalg.norm(rel, axis=-1) < spec.mbes_range_m
        bearing = np.arctan2(rel[:, 1], rel[:, 0])
        swath_ok = np.abs(np.abs(bearing) - np.pi / 2) < spec.mbes_swath_rad
        below_ok = rel[:, 2] < 0.0
        hits = rel[rng_ok & swath_ok & below_ok]
        for h in hits:
            det_stamps.append(ts)
            det_values.append(h + rng.normal(0, spec.mbes_std, 3))
            det_burst.append(b)
    streams["mbes_detections"] = {
        "stamps": np.asarray(det_stamps, dtype=np.float64),
        "values": (
            np.asarray(det_values, dtype=np.float64)
            if det_values
            else np.zeros((0, 3))
        ),
        "burst": np.asarray(det_burst, dtype=np.int64),
    }

    return Mission(
        spec=spec,
        t=t,
        pos=pos,
        rpy=rpy,
        vel_body=vel_body,
        gyro=rpy_rates,
        landmarks=landmarks,
        streams=streams,
    )
