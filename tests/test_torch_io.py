"""The port's host and IO layer against the JAX package's, on the same
numpy inputs: recorded logs (``io.logs``), the map server, the rosbag
converter on duck-typed message stubs, the Waterlinked client with a fake
transport and the aux-DR track, metrics and observability.

Tolerances: the numpy copies are bitwise (logs and their timelines on
``data/sample_mission.npz``, map YAML parsing, the bag flatteners,
observability's numpy, ``aux_dr_track``); the torch metrics against jnp's
within 1e-5 relative (both in float32, the libraries' sqrt and reductions
a few ulps apart).
"""

import dataclasses
import json
import os
import sys
import types
import warnings

import numpy as np
import pytest
import torch

from smarc_navigation_tpu_torch.io import (bag_convert, logs, map_server, metrics,
                                           observability, sim, uw_gps)
from smarc_navigation_tpu_torch.models import sensors

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, "data", "sample_mission.npz")


def _flat(tl):
    """path -> numpy array over every leaf of a Timeline of either package."""
    d = {"ticks": np.asarray(tl.ticks)}
    for group in ("channels", "windows", "events"):
        for name, ch in getattr(tl, group).items():
            for f in dataclasses.fields(ch):
                d[f"{group}.{name}.{f.name}"] = np.asarray(getattr(ch, f.name))
    return d


def _assert_bitwise(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k], equal_nan=True), k


def _streams_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for name in a:
        assert a[name].keys() == b[name].keys(), name
        for k in a[name]:
            x, y = np.asarray(a[name][k]), np.asarray(b[name][k])
            assert x.dtype == y.dtype and np.array_equal(x, y), (name, k)


# ---------------------------------------------------------------------------
# logs
# ---------------------------------------------------------------------------

def test_sample_log_and_timeline_bitwise():
    from smarc_navigation_tpu.io import logs as jlogs

    streams, meta = logs.load_log(SAMPLE)
    jstreams, jmeta = jlogs.load_log(SAMPLE)
    assert meta == jmeta
    _streams_equal(streams, jstreams)
    for kw in (dict(channels=("odom",), events={"mbes": 8}),
               dict(channels=("odom", "gps", "depth"), windows={"dvl": 5},
                    events={"mbes": 4}, t0=2.0, t1=40.0)):
        stats, jstats = {}, {}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            tl = logs.log_to_timeline(streams, 10.0, stats=stats, **kw)
            jtl = jlogs.log_to_timeline(jstreams, 10.0, stats=jstats, **kw)
        _assert_bitwise(_flat(tl), _flat(jtl))
        assert stats == jstats
    # the numpy timeline goes to a device as tensors, the same bits
    tt = tl.to("cpu")
    assert isinstance(tt.ticks, torch.Tensor)
    assert np.array_equal(tt.events["mbes"].value.numpy(), tl.events["mbes"].value)


def test_log_roundtrip_csv_and_errors(tmp_path):
    from smarc_navigation_tpu.io import logs as jlogs
    from smarc_navigation_tpu.io import sim as jsim

    spec = dict(duration_s=6.0, num_landmarks=12, mbes_std=0.05, landmark_area_m=40.0,
                mbes_range_m=30.0, seed=2)
    streams = logs.mission_to_log(sim.simulate(sim.MissionSpec(**spec)),
                                  path=str(tmp_path / "a.npz"))
    jstreams = jlogs.mission_to_log(jsim.simulate(jsim.MissionSpec(**spec)),
                                    path=str(tmp_path / "b.npz"))
    _streams_equal(streams, jstreams)
    la, ma = logs.load_log(str(tmp_path / "a.npz"))
    lb, mb = jlogs.load_log(str(tmp_path / "b.npz"))
    _streams_equal(la, lb)
    assert ma == mb == {"schema_version": 1, "source": "io.sim", "seed": 2}
    # column-major values are transposed on save, as the reference does
    logs.save_log(str(tmp_path / "c.npz"), {"d": {"stamps": np.arange(4.0),
                                                  "values": np.ones((2, 4))}})
    assert logs.load_log(str(tmp_path / "c.npz"))[0]["d"]["values"].shape == (4, 2)
    with pytest.raises(ValueError, match="mismatch"):
        logs.save_log(str(tmp_path / "d.npz"), {"d": {"stamps": np.arange(4.0),
                                                      "values": np.ones((3, 5))}})

    path = str(tmp_path / "depth.csv")
    np.savetxt(path, np.column_stack([np.arange(5.0), -np.arange(5.0) * 0.1]), delimiter=",")
    got, want = logs.load_csv_stream(path), jlogs.load_csv_stream(path)
    assert all(np.array_equal(got[k], want[k]) for k in ("stamps", "values"))

    with pytest.raises(ValueError, match="max_per_tick"):
        logs.log_to_timeline({"mbes": {"stamps": np.arange(3.0), "values": np.zeros((3, 3)),
                                       "burst": np.zeros(3, np.int64)}}, freq_hz=10.0)
    with pytest.raises(KeyError, match="not in log"):
        logs.log_to_timeline({"odom": {"stamps": np.arange(3.0), "values": np.zeros((3, 6))}},
                             freq_hz=10.0, channels=("odom", "gps"))


# ---------------------------------------------------------------------------
# map server
# ---------------------------------------------------------------------------

def test_map_server_matches_reference(tmp_path):
    from smarc_navigation_tpu.io import map_server as jmap

    yml = tmp_path / "map.yaml"
    yml.write_text("""
world:
  - position: {x: 1.0, y: 2.0, z: -95.0}
  - position: {x: 3.0, y: 4.0, z: -80.0}
  - position: {x: 5.0, y: 6.5, z: -99.0}
""")
    lm = map_server.parse_map_yaml(str(yml), rocks_depth=-90.0)
    want = jmap.parse_map_yaml(str(yml), rocks_depth=-90.0)
    assert lm.dtype == want.dtype and np.array_equal(lm, want) and lm.shape == (2, 3)
    npz = str(tmp_path / "map.npz")
    map_server.save_map(npz, lm)
    for a, b in zip(map_server.load_map(npz), jmap.load_map(npz)):
        assert np.array_equal(a, b)
    pts = np.array([[0.0, 0.0, -95.0], [1.0, 1.0, -10.0]])
    assert np.array_equal(map_server.filter_by_depth(pts, -90.0),
                          jmap.filter_by_depth(pts, -90.0))


# ---------------------------------------------------------------------------
# bag converter (duck-typed stubs)
# ---------------------------------------------------------------------------

def _ns(**kw):
    return types.SimpleNamespace(**kw)


def _v3(x, y, z):
    return _ns(x=float(x), y=float(y), z=float(z))


def _odom_msg(sec, nsec, pos):
    return _ns(header=_ns(stamp=_ns(secs=sec, nsecs=nsec)),
               pose=_ns(pose=_ns(position=_v3(*pos),
                                 orientation=_ns(x=0.0, y=0.1, z=0.2, w=0.97))),
               twist=_ns(twist=_ns(linear=_v3(0.5, 0.0, 0.01), angular=_v3(0.0, 0.0, 0.1))))


class _BagTime:
    def __init__(self, t):
        self.t = t

    def to_sec(self):
        return self.t


def test_bag_convert_matches_reference(monkeypatch, tmp_path):
    from smarc_navigation_tpu.io import bag_convert as jbag

    imu = _ns(orientation=_ns(x=0.0, y=0.0, z=0.7, w=0.7),
              angular_velocity=_v3(0.01, 0.02, 0.03), linear_acceleration=_v3(0, 0, -9.8))
    tw = _ns(twist=_ns(twist=_ns(linear=_v3(1, 2, 3), angular=_v3(0, 0, 0.5))))
    depth = _ns(pose=_ns(pose=_ns(position=_v3(0, 0, -2.5))))
    navsat = _ns(latitude=59.35, longitude=18.07, status=_ns(status=1))
    pa = _ns(poses=[_ns(position=_v3(1, 2, 3)), _ns(position=_v3(4, 5, 6))])
    odom = _odom_msg(10, 500_000_000, (1.0, 2.0, -3.0))
    for fn, msg in (("flatten_odometry", odom), ("flatten_imu", imu),
                    ("flatten_twist", tw), ("flatten_pose_z", depth),
                    ("flatten_navsat", navsat), ("flatten_pose_array", pa)):
        assert getattr(bag_convert, fn)(msg) == getattr(jbag, fn)(msg), fn
    for msg, bt in ((odom, None), (_ns(), _BagTime(3.25)),
                    (_ns(header=_ns(stamp=_ns(sec=4, nanosec=250))), None),
                    (_ns(header=_ns(stamp=_ns(secs=0, nsecs=0))), _BagTime(7.5))):
        assert bag_convert.stamp_seconds(msg, bt) == jbag.stamp_seconds(msg, bt)
    with pytest.raises(ValueError, match="no usable stamp"):
        bag_convert.stamp_seconds(_ns())

    msgs = [("/odom", odom, _BagTime(99.0)), ("/rocks", pa, _BagTime(10.8)),
            ("/rocks", pa, _BagTime(11.8)), ("/gps", navsat, _BagTime(10.6)),
            ("/other", _ns(), _BagTime(12.0))]

    class FakeBag:
        def __init__(self, path, mode="r"):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def read_messages(self, topics=None):
            for topic, msg, t in msgs:
                if topics is None or topic in topics:
                    yield topic, msg, t

    roles = {"/odom": "odom", "/rocks": "detections", "/gps": "gps"}
    with monkeypatch.context() as mp:
        mp.setitem(sys.modules, "rosbag", None)
        with pytest.raises(RuntimeError, match="rosbag is not installed"):
            bag_convert.convert("x.bag", str(tmp_path / "x.npz"), roles)
    mod = types.ModuleType("rosbag")
    mod.Bag = FakeBag
    monkeypatch.setitem(sys.modules, "rosbag", mod)
    counts = bag_convert.convert("m.bag", str(tmp_path / "port.npz"), roles)
    jcounts = jbag.convert("m.bag", str(tmp_path / "ref.npz"), roles)
    assert counts == jcounts == {"odom": 1, "mbes": 4, "gps": 1}
    got, gmeta = logs.load_log(str(tmp_path / "port.npz"))
    want, wmeta = logs.load_log(str(tmp_path / "ref.npz"))
    _streams_equal(got, want)
    assert gmeta == wmeta
    bag_convert.main(["m.bag", str(tmp_path / "cli.npz"), "--odom", "/odom"])
    assert logs.load_log(str(tmp_path / "cli.npz"))[0]["odom"]["values"].shape == (1, 13)


# ---------------------------------------------------------------------------
# Waterlinked client and aux DR
# ---------------------------------------------------------------------------

def test_uw_gps_matches_reference():
    from smarc_navigation_tpu.io import uw_gps as juw
    from smarc_navigation_tpu.models import sensors as jsensors

    with pytest.raises(RuntimeError, match="no network transport"):
        uw_gps.WaterlinkedClient().get_acoustic_position()
    seen = []

    def transport(url, payload=None):
        seen.append((url, payload))
        return {"url": url}

    c = uw_gps.WaterlinkedClient(transport=transport, put_transport=transport)
    for fn in ("get_antenna_position", "get_acoustic_position", "get_global_position",
               "get_master_position", "get_master_imu"):
        assert getattr(c, fn)()["url"].startswith(c.base_url)
    c.set_position_master(59.3, 18.0, 90.0)
    assert seen[-1] == (f"{c.base_url}/api/v1/external/master",
                        dict(lat=59.3, lon=18.0, orientation=90.0))
    jc = juw.WaterlinkedClient(transport=lambda url, payload=None: {"url": url})
    assert c.get_master_imu() == jc.get_master_imu()

    for yaw in (-370.0, -90.0, 0.0, 45.5, 181.0, 720.0):
        assert uw_gps.master_enu_yaw({"yaw": yaw}) == juw.master_enu_yaw({"yaw": yaw})
    um = sensors.bootstrap_utm_map(333411.123456, 6582690.654321)
    jum = jsensors.bootstrap_utm_map(333411.123456, 6582690.654321)
    for fix in ({"x": 3.0, "y": -1.5, "z": 5.0}, {"x": 1e-3, "y": 0.0, "z": -2.0}):
        got = uw_gps.acoustic_to_map(fix, 333411.5, 6582690.25, 0.7, um)
        want = juw.acoustic_to_map(fix, 333411.5, 6582690.25, 0.7, jum)
        assert np.array_equal(got, want)

    rng = np.random.default_rng(0)
    for heading in (0.0, 0.3, -2.1):
        stamps = np.sort(rng.uniform(0, 8, 9))
        fixes = np.stack([333411.0 + np.cumsum(rng.uniform(0, 0.5, 9)),
                          6582690.0 + np.cumsum(rng.uniform(-0.3, 0.3, 9))], -1)
        q = np.array([0.0, 0.0, np.sin(heading / 2), np.cos(heading / 2)])
        t, xy, um, mo = uw_gps.aux_dr_track(stamps, fixes, q, dr_period=0.5, device="cpu")
        jt, jxy, jum, jmo = juw.aux_dr_track(stamps, fixes, q, dr_period=0.5)
        assert np.array_equal(t, jt) and np.array_equal(xy, jxy), heading
        assert np.array_equal(um.trans, jum.trans)
        assert np.array_equal(mo.rot.numpy(), np.asarray(jmo.rot))
    with pytest.raises(ValueError, match="at least one"):
        uw_gps.aux_dr_track(np.zeros(0), np.zeros((0, 2)), q, device="cpu")


# ---------------------------------------------------------------------------
# metrics and observability
# ---------------------------------------------------------------------------

def _tracks(n=101, seed=0):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 10, n)
    gt = np.stack([t, np.sin(t), -1 + 0 * t, 0.1 * np.cos(t), 0 * t, 3.0 * t], -1)
    est = gt + rng.normal(scale=0.05, size=gt.shape)
    return t, est, gt


def test_metrics_match_jax():
    import jax.numpy as jnp

    from smarc_navigation_tpu.io import metrics as jmetrics

    t, est, gt = _tracks()
    e32, g32 = est.astype(np.float32), gt.astype(np.float32)
    te, tg = torch.from_numpy(e32), torch.from_numpy(g32)
    je, jg = jnp.asarray(e32), jnp.asarray(g32)
    got, want = metrics.summarize(te, tg), jmetrics.summarize(je, jg)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-7), k
    for fn, args in (("rmse", (te, tg)), ("position_errors", (te[:, :3], tg[:, :3])),
                     ("per_axis_error", (te, tg)), ("path_length", (te[:, :3],)),
                     ("final_error", (te[:, :3], tg[:, :3]))):
        np.testing.assert_allclose(getattr(metrics, fn)(*args).numpy(),
                                   np.asarray(getattr(jmetrics, fn)(
                                       *(jnp.asarray(a.numpy()) for a in args))),
                                   rtol=1e-5, atol=1e-7, err_msg=fn)
    np.testing.assert_allclose(metrics.rmse(te[:, 3:], tg[:, 3:], angular=True).numpy(),
                               np.asarray(jmetrics.rmse(je[:, 3:], jg[:, 3:], angular=True)),
                               rtol=1e-5)

    rng = np.random.default_rng(1)
    A = rng.normal(size=(20, 3, 3))
    S = (A @ np.swapaxes(A, 1, 2) + 3 * np.eye(3)).astype(np.float32)
    nu = rng.normal(size=(20, 3)).astype(np.float32)
    mask = rng.uniform(size=20) > 0.3
    np.testing.assert_allclose(metrics.nees(torch.from_numpy(nu), torch.from_numpy(S)).numpy(),
                               np.asarray(jmetrics.nees(jnp.asarray(nu), jnp.asarray(S))),
                               rtol=1e-5)
    np.testing.assert_allclose(
        metrics.nis(torch.from_numpy(nu), torch.from_numpy(S), torch.from_numpy(mask)).numpy(),
        np.asarray(jmetrics.nis(jnp.asarray(nu), jnp.asarray(S), jnp.asarray(mask))), rtol=1e-5)


def test_observability_matches_reference(tmp_path):
    from smarc_navigation_tpu.io import observability as jobs

    t, est, gt = _tracks(201, seed=2)
    tw = np.random.default_rng(3).normal(size=(201, 6))
    alt = np.linspace(5, 6, 201)
    for a, b in ((observability.flatten_odometry(est, twist=tw, altitude=alt),
                  jobs.flatten_odometry(est, twist=tw, altitude=alt)),
                 (observability.tf_listener_scalars(t, est, 1.5, altitude=alt),
                  jobs.tf_listener_scalars(t, est, 1.5, altitude=alt))):
        assert a.keys() == b.keys()
        assert all(np.array_equal(a[k], b[k]) for k in a)
    assert np.array_equal(observability.twist_from_track(t, est),
                          jobs.twist_from_track(t, est))
    tracks = {"est": est, "other": est[:, [1, 0, 2, 3, 4, 5]]}
    assert observability.error_dashboard(t, tracks, gt) == jobs.error_dashboard(t, tracks, gt)

    rep = observability.run_report(est, gt, extra={"n": 3}, path=str(tmp_path / "r.json"),
                                   device="cpu")
    want = jobs.run_report(est, gt, extra={"n": 3})
    assert rep.keys() == want.keys() and rep["n"] == 3
    for k in rep:
        assert rep[k] == pytest.approx(want[k], rel=1e-5), k
    assert json.load(open(tmp_path / "r.json")) == rep


def test_error_dashboard_without_matplotlib(monkeypatch, tmp_path):
    """The one divergence on purpose: without matplotlib, a dashboard asked
    for is skipped with one warning naming the package; the stats come back
    all the same."""
    t, est, gt = _tracks()
    want = observability.error_dashboard(t, {"est": est}, gt)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setattr(observability, "_warned_no_matplotlib", False)
    png = str(tmp_path / "dash.png")
    with pytest.warns(UserWarning, match="matplotlib is not installed"):
        got = observability.error_dashboard(t, {"est": est}, gt, path=png)
    assert got == want and not os.path.exists(png)
    with warnings.catch_warnings():
        warnings.simplefilter("error")           # warned once: silent after
        observability.error_dashboard(t, {"est": est}, gt, path=png)
