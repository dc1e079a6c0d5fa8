"""The rest of the port's geometry and linalg, its geodesy and its sensor
glue against the JAX package's, on the same numpy inputs.

Tolerances: float32 torch against jnp within 1e-6 absolute (1e-5 relative
for inverses and likelihoods: both evaluate the same expressions, the
libraries' sin, cos, sqrt and Cholesky differ in the last bits). The
``xp=numpy`` geodesy and the sensors' float64 host math are bitwise the
reference's. UTM round trips hold the reference test's own bounds
(``tests/test_geodesy.py``): 1e-11 degrees on the float64 host path, 2e-3
on the float32 device path.
"""

import numpy as np
import pytest
import torch

from smarc_navigation_tpu_torch.models import sensors
from smarc_navigation_tpu_torch.utils import geodesy
from smarc_navigation_tpu_torch.utils import geometry as G
from smarc_navigation_tpu_torch.utils import linalg

CPU = "cpu"


@pytest.fixture(scope="module")
def J():
    import jax.numpy as jnp

    from smarc_navigation_tpu.models import sensors as jsensors
    from smarc_navigation_tpu.utils import geodesy as jgeodesy
    from smarc_navigation_tpu.utils import geometry as jgeometry
    from smarc_navigation_tpu.utils import linalg as jlinalg

    class NS:
        pass

    ns = NS()
    ns.jnp, ns.geometry, ns.linalg, ns.geodesy, ns.sensors = (
        jnp, jgeometry, jlinalg, jgeodesy, jsensors)
    return ns


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _close(got, want, atol=1e-6, rtol=0.0):
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=atol, rtol=rtol)


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def test_quaternion_functions_match_jax(J):
    rng = np.random.default_rng(0)
    rpy = rng.uniform(-3.5, 3.5, (64, 3)).astype(np.float32)
    q1, q2 = _quats(rng, 64), _quats(rng, 64)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    jq = J.jnp.asarray
    _close(G.quat_from_rpy(_t(rpy)), J.geometry.quat_from_rpy(jq(rpy)))
    _close(G.quat_multiply(_t(q1), _t(q2)), J.geometry.quat_multiply(jq(q1), jq(q2)))
    _close(G.quat_conjugate(_t(q1)), J.geometry.quat_conjugate(jq(q1)))
    _close(G.quat_rotate(_t(q1), _t(v)), J.geometry.quat_rotate(jq(q1), jq(v)))
    # every branch of Shepperd's method: rotations of all kinds, and the
    # four pure half-turns (trace -1, each diagonal entry the largest once)
    R = np.concatenate([np.asarray(J.geometry.rotmat_from_rpy(jq(rpy))),
                        np.diag([1.0, -1.0, -1.0])[None], np.diag([-1.0, 1.0, -1.0])[None],
                        np.diag([-1.0, -1.0, 1.0])[None]]).astype(np.float32)
    _close(G.quat_from_rotmat(_t(R)), J.geometry.quat_from_rotmat(jq(R)))
    mu = rng.uniform(-10, 10, (16, 6)).astype(np.float32)
    _close(G.wrap_rpy(_t(mu)), J.geometry.wrap_rpy(jq(mu)), atol=2e-6)


def test_transform_and_frame_graph_match_jax(J):
    rng = np.random.default_rng(1)
    rpy = rng.uniform(-1, 1, (3, 3)).astype(np.float32)
    tr = rng.normal(size=(3, 3)).astype(np.float32)
    q = _quats(rng, 1)[0]
    v = rng.normal(size=(5, 3)).astype(np.float32)
    jq = J.jnp.asarray
    a = G.Transform.from_rpy_trans(_t(rpy[0]), _t(tr[0]))
    ja = J.geometry.Transform.from_rpy_trans(jq(rpy[0]), jq(tr[0]))
    _close(a.rotate(_t(v)), ja.rotate(jq(v)))
    b = G.Transform.from_quat_trans(_t(q), _t(tr[1]))
    jb = J.geometry.Transform.from_quat_trans(jq(q), jq(tr[1]))
    _close(b.rot, jb.rot)
    _close(b.trans, jb.trans)

    g, jg = G.FrameGraph(), J.geometry.FrameGraph()
    c = G.Transform.from_rpy_trans(_t(rpy[2]), _t(tr[2]))
    jc = J.geometry.Transform.from_rpy_trans(jq(rpy[2]), jq(tr[2]))
    for graph, edges in ((g, (a, b, c)), (jg, (ja, jb, jc))):
        graph.add("map", "base", edges[0])
        graph.add("base", "dvl", edges[1])
        graph.add("map", "odom", edges[2])
    for target, source in (("dvl", "odom"), ("map", "dvl"), ("odom", "odom")):
        got, want = g.get(target, source), jg.get(target, source)
        _close(got.rot, want.rot, atol=2e-6)
        _close(got.trans, want.trans, atol=2e-6)
        assert got.rot.device == a.rot.device and got.rot.dtype == torch.float32
    with pytest.raises(KeyError):
        g.get("map", "nowhere_else")
    with pytest.raises(ValueError, match="already has parent"):
        g.add("odom", "dvl", a)


# ---------------------------------------------------------------------------
# linalg
# ---------------------------------------------------------------------------

def _spd(rng, lead, n):
    A = rng.normal(size=lead + (n, n))
    return (A @ np.swapaxes(A, -1, -2) + n * np.eye(n)).astype(np.float32)


@pytest.mark.parametrize("n", [2, 3, 6])
def test_linalg_matches_jax(J, n):
    rng = np.random.default_rng(n)
    S = _spd(rng, (8,), n)
    nu = rng.normal(size=(8, n)).astype(np.float32)
    H = rng.normal(size=(8, 3, n)).astype(np.float32)
    jq = J.jnp.asarray
    _close(linalg.spd_solve(_t(S), _t(nu), jitter=1e-3),
           J.linalg.spd_solve(jq(S), jq(nu), jitter=1e-3), atol=0, rtol=1e-5)
    _close(linalg.spd_inverse(_t(S)), J.linalg.spd_inverse(jq(S)), atol=1e-7, rtol=1e-5)
    _close(linalg.mahalanobis(_t(nu), _t(S)), J.linalg.mahalanobis(jq(nu), jq(S)),
           atol=0, rtol=1e-5)
    _close(linalg.gaussian_likelihood(_t(nu), _t(S)),
           J.linalg.gaussian_likelihood(jq(nu), jq(S)), atol=0, rtol=1e-5)
    _close(linalg.quadratic_form(_t(H), _t(S)), J.linalg.quadratic_form(jq(H), jq(S)),
           atol=0, rtol=1e-5)
    _close(linalg.inv_small(_t(S)), J.linalg.inv_small(jq(S)), atol=1e-7, rtol=1e-5)


# ---------------------------------------------------------------------------
# geodesy
# ---------------------------------------------------------------------------

LATS = np.array([59.3498, 58.2, 60.0, 45.0, -33.9, 0.1])
LONS = np.array([18.0707, 17.5, 19.9, 16.0, 151.2, -0.1])


def test_geodesy_host_path_bitwise(J):
    for lat, lon in zip(LATS, LONS):
        zone = geodesy.utm_zone(lat, lon)
        assert zone == J.geodesy.utm_zone(lat, lon)
        south = lat < 0
        got = geodesy.latlon_to_utm(lat, lon, zone, southern=south, xp=np)
        want = J.geodesy.latlon_to_utm(lat, lon, zone, southern=south, xp=np)
        assert np.array_equal(np.asarray(got), np.asarray(want))
        back = geodesy.utm_to_latlon(*got, zone, southern=south, xp=np)
        assert np.array_equal(np.asarray(back),
                              np.asarray(J.geodesy.utm_to_latlon(*want, zone, southern=south,
                                                                 xp=np)))
        # the reference test's bound on the host round trip
        assert abs(float(back[0]) - lat) < 1e-11 and abs(float(back[1]) - lon) < 1e-11
    # batched arrays, and pose_to_geopoint's host path
    got = geodesy.latlon_to_utm(LATS[:3], LONS[:3], 34, xp=np)
    want = J.geodesy.latlon_to_utm(LATS[:3], LONS[:3], 34, xp=np)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    pos = np.array([[10.0, -20.0, 0.0], [0.5, 0.25, -3.0]])
    e0, n0 = 333411.0, 6582690.0
    assert all(np.array_equal(a, b) for a, b in zip(
        geodesy.pose_to_geopoint(pos, 34, e0, n0, xp=np),
        J.geodesy.pose_to_geopoint(pos, 34, e0, n0, xp=np)))


def test_geodesy_device_path(J):
    lat, lon = 59.3498, 18.0707
    e, n = geodesy.latlon_to_utm(lat, lon, 34, device=CPU)
    assert e.dtype == torch.float32 and e.device.type == "cpu"
    lat2, lon2 = geodesy.utm_to_latlon(e, n, 34, device=CPU)
    # the reference test's bound on the float32 device round trip
    assert abs(float(lat2) - lat) < 2e-3 and abs(float(lon2) - lon) < 2e-3
    # float32 against jnp: the same series in float32, the libraries' sin,
    # cos and tan a few ulps apart at ~6.6e6 m (float32 spacing 0.5 m)
    je, jn = J.geodesy.latlon_to_utm(lat, lon, 34)
    assert abs(float(e) - float(je)) <= 1.0 and abs(float(n) - float(jn)) <= 1.0
    lats = _t(LATS[:3].astype(np.float32))
    eb, nb = geodesy.latlon_to_utm(lats, _t(LONS[:3].astype(np.float32)), 34)
    assert eb.shape == (3,) and nb.shape == (3,)

    depth, valid = geodesy.pressure_to_depth(torch.tensor([100000.0, 117000.0, 50000.0,
                                                           600000.0]))
    jd, jv = J.geodesy.pressure_to_depth(J.jnp.array([100000.0, 117000.0, 50000.0, 600000.0]))
    _close(depth, jd)
    assert np.array_equal(_np(valid), np.asarray(jv))


def test_ned_enu_helpers_match_jax(J):
    rng = np.random.default_rng(3)
    q = _quats(rng, 32)
    g = rng.normal(size=(32, 3)).astype(np.float32)
    jq = J.jnp.asarray
    _close(geodesy.ned_to_enu_orientation(_t(q)), J.geodesy.ned_to_enu_orientation(jq(q)),
           atol=2e-6)
    _close(geodesy.sbg_to_enu_orientation(_t(q)), J.geodesy.sbg_to_enu_orientation(jq(q)),
           atol=2e-6)
    _close(geodesy.sbg_to_enu_rates(_t(g)), J.geodesy.sbg_to_enu_rates(jq(g)))

    zone = 34
    e0, n0 = J.geodesy.latlon_to_utm(59.35, 18.07, zone, xp=np)
    q0 = G.quat_from_rpy(torch.zeros(3))
    pos, q_enu = geodesy.latlon_odometry_to_map(59.35, 18.07, q0, zone, float(e0), float(n0))
    jpos, jq_enu = J.geodesy.latlon_odometry_to_map(
        59.35, 18.07, J.geometry.quat_from_rpy(J.jnp.zeros(3)), zone, float(e0), float(n0))
    assert pos.shape == (3,) and pos.device.type == "cpu"
    _close(pos, jpos, atol=1.0)         # float32 device path, as the reference test
    _close(q_enu, jq_enu)
    # north in NED is +90 degrees of yaw in ENU
    assert abs(float(G.rpy_from_quat(q_enu)[2]) - np.pi / 2) < 1e-5


# ---------------------------------------------------------------------------
# sensors
# ---------------------------------------------------------------------------

def test_sensors_host_math_bitwise(J):
    lats = np.array([59.35, 59.351, 59.352])
    lons = np.array([18.07, 18.071, 18.072])
    status = np.array([0, -1, 0])
    got = sensors.gps_to_utm_odometry(lats, lons, 34, status)
    want = J.sensors.gps_to_utm_odometry(lats, lons, 34, status)
    assert np.array_equal(got.easting, want.easting)
    assert np.array_equal(got.northing, want.northing)

    lat_w, lon_w = geodesy.utm_to_latlon(333410.0, 6582690.0, 34, xp=np)
    lat_e, lon_e = geodesy.utm_to_latlon(333412.0, 6582690.0, 34, xp=np)
    got = sensors.dual_antenna_fix(lat_w, lon_w, lat_e, lon_e, 34)
    want = J.sensors.dual_antenna_fix(lat_w, lon_w, lat_e, lon_e, 34)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)

    um, jum = (sensors.bootstrap_utm_map(333411.123456, 6582690.654321),
               J.sensors.bootstrap_utm_map(333411.123456, 6582690.654321))
    assert um.trans.dtype == np.float64
    assert np.array_equal(um.rot, jum.rot) and np.array_equal(um.trans, jum.trans)
    pts = np.array([[333412.0, 6582691.0, -2.0], [333400.5, 6582700.25, 0.0]])
    assert np.array_equal(sensors.utm_points_to_map(pts, um),
                          J.sensors.utm_points_to_map(pts, jum))
    assert np.array_equal(sensors.latlon_markers_to_map([59.35, 59.36], [18.07, 18.08], 34, um),
                          J.sensors.latlon_markers_to_map([59.35, 59.36], [18.07, 18.08], 34,
                                                          jum))
    yaw = np.linspace(-4, 4, 17)
    assert np.array_equal(sensors.yaw_to_heading_deg(yaw), J.sensors.yaw_to_heading_deg(yaw))
    e = np.array([0.0, 1.0, 2.0, 2.001, 2.0, 1.0])
    n = np.array([0.0, 0.0, 0.0, 0.0, 1.0, 2.0])
    assert np.array_equal(sensors.spoof_heading_from_track(e, n),
                          J.sensors.spoof_heading_from_track(e, n))
    for a, b in zip(sensors.override_covariances(), J.sensors.override_covariances()):
        assert np.array_equal(a, b)


def test_sensor_frames_match_jax(J):
    rng = np.random.default_rng(4)
    q = _quats(rng, 1)[0]
    mo = sensors.bootstrap_map_odom(np.array([5.0, -3.0]), q, device=CPU)
    jmo = J.sensors.bootstrap_map_odom(np.array([5.0, -3.0]), q)
    assert mo.rot.dtype == torch.float32 and mo.rot.device.type == "cpu"
    _close(mo.rot, jmo.rot)
    _close(mo.trans, jmo.trans)

    odom_base = G.Transform.from_rpy_trans(torch.tensor([0.01, -0.02, 0.7]),
                                           torch.tensor([3.0, 4.0, -1.0]))
    jodom_base = J.geometry.Transform.from_rpy_trans(J.jnp.asarray([0.01, -0.02, 0.7]),
                                                     J.jnp.asarray([3.0, 4.0, -1.0]))
    wl = sensors.bootstrap_utm_map(333000.0, 6582000.0)
    got = sensors.gps_world_correction(333010.0, 6582020.0, q, odom_base, wl, device=CPU)
    want = J.sensors.gps_world_correction(333010.0, 6582020.0, q, jodom_base, wl)
    assert got.rot.dtype == np.float64
    np.testing.assert_allclose(got.rot, want.rot, atol=1e-6)
    np.testing.assert_allclose(got.trans, want.trans, atol=1e-5)
