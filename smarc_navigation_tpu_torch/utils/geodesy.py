"""Geodesy: UTM <-> lat/lon, NED <-> ENU, pressure -> depth (port of
``smarc_navigation_tpu/utils/geodesy.py``).

Replaces the reference's use of ``geodesy.utm`` (``gps_node.py:42-78``,
``aux_dr_node.py:62-113``) and the ``tf_lat_lon`` service node
(``tf_lat_lon/src/tf_lat_lon_node.cpp:36-102``). Every UTM function takes
``xp=``: ``numpy`` is the host float64 path, bit for bit the reference's
``xp=np``; ``torch`` (the default) is the device path on tensors.

UTM uses the WGS84 ellipsoid with Karney-style Krüger series (6th order),
accurate to well under a millimetre inside a zone.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .geometry import quat_from_rotmat, quat_from_rpy, rotmat_from_quat, rpy_from_quat

# WGS84
_A = 6378137.0
_F = 1.0 / 298.257223563
_K0 = 0.9996
_E2 = _F * (2.0 - _F)
_N = _F / (2.0 - _F)  # third flattening

# Krüger series alpha / beta coefficients in n (order 6)
_N2, _N3, _N4, _N5, _N6 = _N**2, _N**3, _N**4, _N**5, _N**6
_ALPHA = (
    _N / 2 - 2 * _N2 / 3 + 5 * _N3 / 16 + 41 * _N4 / 180 - 127 * _N5 / 288 + 7891 * _N6 / 37800,
    13 * _N2 / 48 - 3 * _N3 / 5 + 557 * _N4 / 1440 + 281 * _N5 / 630 - 1983433 * _N6 / 1935360,
    61 * _N3 / 240 - 103 * _N4 / 140 + 15061 * _N5 / 26880 + 167603 * _N6 / 181440,
    49561 * _N4 / 161280 - 179 * _N5 / 168 + 6601661 * _N6 / 7257600,
    34729 * _N5 / 80640 - 3418889 * _N6 / 1995840,
    212378941 * _N6 / 319334400,
)
_BETA = (
    _N / 2 - 2 * _N2 / 3 + 37 * _N3 / 96 - _N4 / 360 - 81 * _N5 / 512 + 96199 * _N6 / 604800,
    _N2 / 48 + _N3 / 15 - 437 * _N4 / 1440 + 46 * _N5 / 105 - 1118711 * _N6 / 3870720,
    17 * _N3 / 480 - 37 * _N4 / 840 - 209 * _N5 / 4480 + 5569 * _N6 / 90720,
    4397 * _N4 / 161280 - 11 * _N5 / 504 - 830251 * _N6 / 7257600,
    4583 * _N5 / 161280 - 108847 * _N6 / 3991680,
    20648693 * _N6 / 638668800,
)
# Rectifying radius
_A_HAT = _A / (1 + _N) * (1 + _N2 / 4 + _N4 / 64 + _N6 / 256)

_FALSE_EASTING = 500000.0
_FALSE_NORTHING_SOUTH = 10000000.0


class _TorchNamespace:
    """The array functions the UTM series call, on torch tensors; Python
    and numpy scalars (the series' constants) are computed in float64 on
    the host, as numpy computes them, and broadcast into the tensor math."""

    def __init__(self, device):
        self.device = device

    def asarray(self, x):
        if isinstance(x, torch.Tensor):
            return x
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=self.device)

    def __getattr__(self, name):
        tfn = getattr(torch, name)
        nfn = getattr(np, name)

        def fn(*args):
            if any(isinstance(a, torch.Tensor) for a in args):
                return tfn(*args)
            return float(nfn(*args))

        return fn


def _namespace(xp, device):
    return _TorchNamespace(device) if xp is torch else xp


def utm_zone(lat_deg: float, lon_deg: float) -> int:
    """UTM zone number for a lat/lon (standard zones, no Norway exceptions
    needed for SMARC's Baltic operating area — zone 33/34)."""
    return int((lon_deg + 180.0) // 6.0) + 1


def latlon_to_utm(lat_deg, lon_deg, zone: int, southern: bool = False, xp=torch, device="cuda"):
    """(lat, lon) degrees -> (easting, northing) metres in the given zone.

    Functional equivalent of ``geodesy::fromMsg`` / ``geodesy.utm.fromLatLong``
    as used at ``tf_lat_lon_node.cpp:36-46`` and ``gps_node.py:49-66``.
    Accepts arrays. ``xp=torch`` (the default) is the device path: tensors
    stay on their device and dtype, anything else becomes float32 on
    ``device``. Pass ``xp=numpy`` for host-side f64 (sub-mm) precision —
    absolute UTM coordinates (~6.5e6 m northing in the Baltic) exceed f32
    resolution, so timeline building converts on the host and ships only
    local map-frame offsets to the device.
    """
    xp = _namespace(xp, device)
    lat = xp.deg2rad(xp.asarray(lat_deg))
    lon = xp.deg2rad(xp.asarray(lon_deg))
    lon0 = xp.deg2rad(float((zone - 1) * 6 - 180 + 3))

    # Conformal latitude
    e = xp.sqrt(_E2)
    t = xp.tan(lat)
    sigma = xp.sinh(e * xp.arctanh(e * t / xp.sqrt(1 + t * t)))
    tp = t * xp.sqrt(1 + sigma * sigma) - sigma * xp.sqrt(1 + t * t)

    dlon = lon - lon0
    xi_p = xp.arctan2(tp, xp.cos(dlon))
    eta_p = xp.arcsinh(xp.sin(dlon) / xp.sqrt(tp * tp + xp.cos(dlon) ** 2))

    xi = xi_p
    eta = eta_p
    for j, a in enumerate(_ALPHA, start=1):
        xi = xi + a * xp.sin(2 * j * xi_p) * xp.cosh(2 * j * eta_p)
        eta = eta + a * xp.cos(2 * j * xi_p) * xp.sinh(2 * j * eta_p)

    easting = _FALSE_EASTING + _K0 * _A_HAT * eta
    northing = _K0 * _A_HAT * xi
    if southern:
        northing = northing + _FALSE_NORTHING_SOUTH
    return easting, northing


def utm_to_latlon(easting, northing, zone: int, southern: bool = False, xp=torch, device="cuda"):
    """(easting, northing) metres -> (lat, lon) degrees. Inverse series.

    Pass ``xp=numpy`` on the host for f64 precision; the float32 device
    path is metre-accurate only (see latlon_to_utm notes).
    """
    xp = _namespace(xp, device)
    easting = xp.asarray(easting)
    northing = xp.asarray(northing)
    if southern:
        northing = northing - _FALSE_NORTHING_SOUTH
    lon0 = xp.deg2rad(float((zone - 1) * 6 - 180 + 3))

    xi = northing / (_K0 * _A_HAT)
    eta = (easting - _FALSE_EASTING) / (_K0 * _A_HAT)

    xi_p = xi
    eta_p = eta
    for j, b in enumerate(_BETA, start=1):
        xi_p = xi_p - b * xp.sin(2 * j * xi) * xp.cosh(2 * j * eta)
        eta_p = eta_p - b * xp.cos(2 * j * xi) * xp.sinh(2 * j * eta)

    tp = xp.sin(xi_p) / xp.sqrt(xp.sinh(eta_p) ** 2 + xp.cos(xi_p) ** 2)
    lon = lon0 + xp.arctan2(xp.sinh(eta_p), xp.cos(xi_p))

    # Newton-iterate tau from tau' (Karney 2011 eq. 19-21; 4 iterations
    # reach machine precision from the tau'=tau start)
    e = xp.sqrt(_E2)
    t = tp
    for _ in range(4):
        sigma = xp.sinh(e * xp.arctanh(e * t / xp.sqrt(1 + t * t)))
        f = t * xp.sqrt(1 + sigma * sigma) - sigma * xp.sqrt(1 + t * t) - tp
        df = (
            (xp.sqrt((1 + sigma * sigma) * (1 + t * t)) - sigma * t)
            * (1 - _E2)
            * xp.sqrt(1 + t * t)
            / (1 + (1 - _E2) * t * t)
        )
        t = t - f / df
    lat = xp.arctan(t)
    return xp.rad2deg(lat), xp.rad2deg(lon)


# ---------------------------------------------------------------------------
# NED <-> ENU
# ---------------------------------------------------------------------------

def _ned_to_enu(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, -1.0]],
                        dtype=like.dtype, device=like.device)


def _switch_z(like: torch.Tensor) -> torch.Tensor:
    return torch.diag(torch.tensor([1.0, -1.0, -1.0], dtype=like.dtype, device=like.device))


def ned_to_enu_orientation(q_ned: torch.Tensor) -> torch.Tensor:
    """NED body orientation quaternion -> ENU, exactly the matrix sandwich of
    ``tf_lat_lon_node.cpp:48-73``: R_enu = M_ned2enu · R_ned · diag(1,-1,-1)."""
    R = rotmat_from_quat(q_ned)
    return quat_from_rotmat(_ned_to_enu(R) @ R @ _switch_z(R))


def sbg_to_enu_orientation(q_sbg: torch.Tensor) -> torch.Tensor:
    """SBG (NED) quaternion -> ROS ENU IMU quaternion, matching
    ``sbg_to_ros.py:19-35``: swap x/y, negate z, then add +pi/2 yaw."""
    q = torch.stack([q_sbg[..., 1], q_sbg[..., 0], -q_sbg[..., 2], q_sbg[..., 3]], dim=-1)
    rpy = rpy_from_quat(q)
    rpy = torch.cat([rpy[..., 0:2], rpy[..., 2:3] + math.pi / 2], dim=-1)
    return quat_from_rpy(rpy)


def sbg_to_enu_rates(gyro_ned: torch.Tensor) -> torch.Tensor:
    """SBG NED angular rates -> ENU (swap x/y, negate z), sbg_to_ros.py:40-42."""
    return torch.stack([gyro_ned[..., 1], gyro_ned[..., 0], -gyro_ned[..., 2]], dim=-1)


def latlon_odometry_to_map(
    lat_deg, lon_deg, q_ned: torch.Tensor, zone: int,
    map_origin_e: float, map_origin_n: float,
):
    """Lat/lon odometry -> local map-frame odometry: UTM conversion minus the
    utm->map origin, orientation NED->ENU — the ``convert_lat_lon_odom``
    service of ``tf_lat_lon_node.cpp:75-102``. The UTM conversion runs on
    ``q_ned``'s device.

    Returns (pos_map (...,3), q_enu (...,4))."""
    e, n = latlon_to_utm(lat_deg, lon_deg, zone, device=q_ned.device)
    pos = torch.stack([e - map_origin_e, n - map_origin_n, torch.zeros_like(e)], dim=-1)
    return pos, ned_to_enu_orientation(q_ned)


def pose_to_geopoint(pos_map, zone: int, map_origin_e: float, map_origin_n: float,
                     xp=torch, device="cuda"):
    """Map-frame position -> (lat, lon) — the 10 Hz tf->GeoPoint publisher of
    ``tf_lat_lon_node.cpp:190-208``."""
    ns = _namespace(xp, device)
    return utm_to_latlon(
        ns.asarray(pos_map[..., 0]) + map_origin_e,
        ns.asarray(pos_map[..., 1]) + map_origin_n,
        zone,
        xp=xp,
        device=device,
    )


# ---------------------------------------------------------------------------
# Pressure -> depth
# ---------------------------------------------------------------------------

PRESSURE_MIN_PA = 90000.0
PRESSURE_MAX_PA = 500000.0


def pressure_to_depth(pressure_pa: torch.Tensor):
    """Fluid pressure [Pa] -> signed depth [m] (negative down) + validity.

    depth = -10 (p/1e5 - 1); valid iff 0.9e5 < p < 5e5 Pa
    (``press_to_depth.py:44-60``).
    """
    depth = -10.0 * (pressure_pa / 100000.0 - 1.0)
    valid = (pressure_pa > PRESSURE_MIN_PA) & (pressure_pa < PRESSURE_MAX_PA)
    return depth, valid
