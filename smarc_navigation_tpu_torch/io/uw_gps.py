"""Waterlinked underwater-GPS client + auxiliary dead-reckoning.

Rebuild of the ``uw_gps`` package (SURVEY.md §2.2):

* ``WaterlinkedClient`` — the REST polling client of
  ``uw_gps/scripts/uw_gps_node.py:20-54`` (endpoints
  ``/api/v1/position/acoustic/filtered``, ``/position/global``,
  ``/position/master``, ``/imu/calibrate``, ``/config/antenna``; PUT of the
  master position). Network access is injectable so missions replay from
  recorded fixes and tests run with a fake transport (this image has zero
  egress — the default transport raises a clear error if actually used).

* pure conversion helpers: master NED orientation -> ENU (``:85-109``),
  acoustic position (relative to master, NED) -> odom-frame position — the
  math of ``aux_dr_node.py:140-168``'s republish loop.

* ``aux_dr_track`` — the ExternalDR node (``aux_dr_node.py``): bootstrap
  utm->map and map->odom from the first fix + SBG heading (``:62-113``),
  then express every UW-GPS fix in the odom frame at the DR period.

Port of ``smarc_navigation_tpu/io/uw_gps.py``: host numpy, through the
port's ``models.sensors``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from ..models import sensors
from ..utils.geometry import Transform


def _no_network(url, payload=None):
    raise RuntimeError(
        f"no network transport configured for Waterlinked request {url!r}; "
        "inject transport= (tests) or replay recorded fixes"
    )


@dataclasses.dataclass
class WaterlinkedClient:
    """Minimal REST client; ``transport(url) -> dict | None`` injectable."""

    base_url: str = "https://demo.waterlinked.com"
    transport: Callable = _no_network
    put_transport: Callable = _no_network

    def get_antenna_position(self) -> Optional[dict]:
        return self.transport(f"{self.base_url}/api/v1/config/antenna")

    def get_acoustic_position(self) -> Optional[dict]:
        return self.transport(f"{self.base_url}/api/v1/position/acoustic/filtered")

    def get_global_position(self) -> Optional[dict]:
        return self.transport(f"{self.base_url}/api/v1/position/global")

    def get_master_position(self) -> Optional[dict]:
        return self.transport(f"{self.base_url}/api/v1/position/master")

    def get_master_imu(self) -> Optional[dict]:
        return self.transport(f"{self.base_url}/api/v1/imu/calibrate")

    def set_position_master(self, lat: float, lon: float, orientation: float):
        return self.put_transport(
            f"{self.base_url}/api/v1/external/master",
            dict(lat=lat, lon=lon, orientation=orientation),
        )


def master_enu_yaw(master_imu: dict) -> float:
    """Master-box NED yaw (degrees) -> ENU yaw (radians)
    (``uw_gps_node.py:85-109``: wrap, NED->ENU = π/2 − yaw)."""
    yaw_ned = np.deg2rad(master_imu["yaw"])
    yaw_ned = (yaw_ned + np.pi) % (2 * np.pi) - np.pi
    return float((np.pi / 2.0 - yaw_ned + np.pi) % (2 * np.pi) - np.pi)


def acoustic_to_map(
    acoustic: dict, master_utm_e: float, master_utm_n: float, master_yaw_enu: float,
    utm_map: Transform,
) -> np.ndarray:
    """Waterlinked acoustic fix (x east-ish, y north-ish, z depth, relative
    to the master box in its NED-ish frame) -> map-frame position."""
    c, s = np.cos(master_yaw_enu), np.sin(master_yaw_enu)
    # rotate the relative fix by the master heading into ENU
    dx = c * acoustic["x"] - s * acoustic["y"]
    dy = s * acoustic["x"] + c * acoustic["y"]
    p_utm = np.array([master_utm_e + dx, master_utm_n + dy, -abs(acoustic["z"])],
                     np.float64)
    # absolute UTM -> map entirely in host f64 (f32 at ~6.5e6 m quantizes
    # to ~0.4 m, bigger than the modeled GPS noise)
    return sensors.utm_points_to_map(p_utm, utm_map)[0]


def aux_dr_track(
    fix_stamps: np.ndarray,
    fixes_utm: np.ndarray,        # (M, 2) easting/northing of the vehicle
    sbg_heading_quat: np.ndarray,  # first SBG orientation (xyzw)
    dr_period: float = 0.1,
    duration_s: Optional[float] = None,
    device="cuda",
):
    """ExternalDR: bootstrap frames from the first fix, then resample the
    UW-GPS positions into the odom frame on the DR grid.

    Returns (t, odom_xy (T,2), utm_map: Transform (host float64),
    map_odom: Transform (float32 on ``device``)).
    """
    if len(fix_stamps) == 0:
        raise ValueError("aux DR needs at least one UW-GPS fix")
    utm_map = sensors.bootstrap_utm_map(fixes_utm[0, 0], fixes_utm[0, 1])
    map_odom = sensors.bootstrap_map_odom(np.zeros(2), sbg_heading_quat, device)

    t1 = duration_s if duration_s is not None else float(fix_stamps[-1])
    t = np.arange(0.0, t1 + 1e-9, dr_period)
    # latest-fix semantics, like every reference queue
    idx = np.clip(np.searchsorted(fix_stamps, t, side="right") - 1, 0, len(fix_stamps) - 1)
    # absolute UTM -> map subtraction in host f64; only the resulting local
    # offsets (small) ever leave float64
    fixes_map = sensors.utm_points_to_map(
        np.concatenate([np.asarray(fixes_utm, np.float64)[idx],
                        np.zeros((len(t), 1))], -1),
        utm_map,
    )
    rot = sensors._host_f64(map_odom.rot)
    trans = sensors._host_f64(map_odom.trans)
    odom_xy = ((fixes_map - trans) @ rot)[:, :2]
    return t, odom_xy, utm_map, map_odom
