"""The port stands alone: it runs with JAX and flax blocked (the SLAM fleet
replay in both covariance semantics, the fleet assignment, the PF kernel
path, the combined mission, the EKF-localization fleet, the 15-state
dual-EKF fleet, dead reckoning, sonar, the raycast fleet and the SLAM + PF
fleet, at a tiny size on the CPU), and its numpy host code (simulator,
timeline construction, fleet batching, the PF, combined, localization,
15-state, dead-reckoning and raycast workloads; recorded logs, geodesy's
host path, the sensor glue, observability's numpy, the aux-DR track)
produces arrays bitwise equal to the reference package's (the 15-state
timeline's attitude and control columns, computed in float32 by each
framework, to 1e-6). The host and IO layer, the mission CLI and the
multi-device layer (the mesh, the distributed resample, the
particle-sharded PF and the mission-sharded SLAM fleet) run with JAX
blocked too, and the native runtime's C++ source is the reference's, byte
for byte."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX = r"""
import sys
for name in ("jax", "jaxlib", "flax", "smarc_navigation_tpu"):
    sys.modules[name] = None          # any import of these now raises
import dataclasses
import torch
import smarc_navigation_tpu_torch
from smarc_navigation_tpu_torch.configs import PFConfig
from smarc_navigation_tpu_torch.io import workloads
from smarc_navigation_tpu_torch.models import ekf_slam
from smarc_navigation_tpu_torch.models import particle_filter as pf
from smarc_navigation_tpu_torch.parallel import fleet

assert torch.backends.cuda.matmul.allow_tf32 is False
cfg = dataclasses.replace(workloads.combined_slam_cfg(), max_landmarks=16)
tl = workloads.slam_fleet_timelines(cfg, 0.4, 2).to("cpu")
assert tl.ticks.shape == (2, 5), tl.ticks.shape
final, out = ekf_slam.run_fleet(tl, ekf_slam.make_params(cfg, device="cpu"), cfg)
assert out["mu"].shape == (5, 2, 6) and bool(torch.isfinite(final.Sigma).all())
tl_s, tl_p = workloads.combined_workload(cfg, 3.0)
pcfg = PFConfig(particle_count=1024)
fin, pout = pf.run_fast_segmented(tl_p.to("cpu"), pf.make_params(pcfg, device="cpu"), pcfg)
assert pout["mean"].shape == (31, 6) and bool(torch.isfinite(fin.particles).all())
val = fleet.run_combined(tl_s.to("cpu"), tl_p.to("cpu"), ekf_slam.make_params(cfg, device="cpu"), cfg,
                         pf.make_params(pcfg, device="cpu"), pcfg, 1024)
assert bool(torch.isfinite(val)), val
fm, om = ekf_slam.run_fleet(tl, ekf_slam.make_params(cfg, device="cpu"), cfg,
                            update_mode="marginal")
assert om["mu"].shape == (5, 2, 6) and bool(torch.isfinite(fm.Sigma).all())
from smarc_navigation_tpu_torch.ops import slam_da_kernels
ctr = slam_da_kernels.hungarian_lanes(torch.tensor([[[1.0, 2.0], [0.0, 5.0], [3.0, 0.5]]]))
assert ctr.tolist() == [[1, 2]], ctr
from smarc_navigation_tpu_torch.configs import EKFLocConfig
from smarc_navigation_tpu_torch.models import ekf_15state, ekf_localization
import warnings
with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    ltl, lms = workloads.loc_fleet_timelines(EKFLocConfig(), 0.3, 2)
lcfg = EKFLocConfig()
lf, lo = ekf_localization.run_fleet(ltl.to("cpu"), ekf_localization.make_params(lms, lcfg, device="cpu"), lcfg)
assert lo["mu"].shape == (16, 2, 6) and lo["matches"].shape == (16, 2, 8)
assert bool(torch.isfinite(lf.Sigma).all())
ecfg = ekf_15state.Ekf15Config(frequency=50.0)
etl = workloads.ekf15_fleet_timelines(ecfg, 0.3, 2).to("cpu")
(_, el), (_, eg), mo = ekf_15state.run_dual_fleet(etl, etl, ecfg)
assert el["x"].shape == (16, 2, 15) and mo.trans.shape == (16, 2, 3)
assert bool(torch.isfinite(mo.trans).all() and torch.isfinite(eg["p_diag"]).all())
from smarc_navigation_tpu_torch.models import dead_reckoning as dr
from smarc_navigation_tpu_torch.ops import oned_kf, sonar
dtl = workloads.sam_dr_fleet_timelines(0.5, 2).to("cpu")
assert dr.run_sam_dr_vectorized(dtl).shape == (2, 26, 9) and dr.run_sam_dr(dtl).shape == (2, 26, 9)
assert oned_kf.smooth(torch.ones(4, 3))[1].shape == (4, 3)
img = torch.zeros(32, 32)
img[8:16, 10:18] = 1.0
_c, _a, bm = sonar.detect_blobs(img, min_area=16)
assert int(bm.sum()) == 1
rcfg, spec, gt, lms, lmm = workloads.raycast_fleet_inputs(2, 3)
rfin, (rmu, rna) = fleet.run_raycast_fleet(torch.as_tensor(gt), torch.as_tensor(lms),
                                           torch.as_tensor(lmm), rcfg,
                                           ekf_slam.make_params(rcfg, device="cpu"), spec,
                                           use_da_kernel=True)
assert rmu.shape == (2, 3, 6) and rna.shape == (2, 3) and bool(torch.isfinite(rfin.Sigma).all())
ftl = workloads.slam_fleet_timelines(cfg, 0.2, 2).to("cpu")
ff, fo = fleet.run_fleet(ftl, cfg, ekf_slam.make_params(cfg, device="cpu"), PFConfig(particle_count=16),
                         pf.make_params(PFConfig(particle_count=16), device="cpu"), 16,
                         pf_scheme="systematic")
assert fo["pf"]["mean"].shape == (3, 2, 6) and bool(torch.isfinite(ff.pf.particles).all())
from smarc_navigation_tpu_torch.ops import resampling
from smarc_navigation_tpu_torch.parallel import mesh, resample_dist
pm = mesh.make_mesh(mission=2, particle=2, devices=[torch.device("cpu")] * 4)
pr, wr = torch.randn(6, 8192), torch.rand(8192)
wr = wr / wr.sum()
assert torch.equal(resample_dist.systematic_resample_gather_dist(pr, wr, 0.3, pm),
                   pr[:, resampling.systematic_resample(0.3, wr).long()])
p4 = PFConfig(particle_count=4096)
g0, o0 = pf.run_fast_segmented(tl_p.to("cpu"), pf.make_params(p4, device="cpu"), p4)
g1, o1 = pf.run_fast_segmented(tl_p.to("cpu"), pf.make_params(p4, device="cpu"), p4, pmesh=pm)
assert torch.equal(g0.particles, g1.particles) and torch.equal(o0["mean"], o1["mean"])
fm1, om1 = ekf_slam.run_fleet(tl, ekf_slam.make_params(cfg, device="cpu"), cfg, device_mesh=pm)
assert torch.equal(om1["mu"], out["mu"])
loaded = sorted(m for m, v in sys.modules.items() if v is not None and
                m.split(".")[0] in ("jax", "jaxlib", "flax", "smarc_navigation_tpu"))
assert not loaded, loaded
print("ran", out["mu"].shape[0], "ticks; n_active", final.n_active.tolist())
"""


_NO_JAX_CLI = r"""
import sys
for name in ("jax", "jaxlib", "flax", "smarc_navigation_tpu"):
    sys.modules[name] = None          # any import of these now raises
import os, shutil, tempfile
import numpy as np
from smarc_navigation_tpu_torch import native, run
from smarc_navigation_tpu_torch.io import (bag_convert, logs, map_server, metrics,
                                           observability, replay, uw_gps)
from smarc_navigation_tpu_torch.models import sensors
from smarc_navigation_tpu_torch.utils import geodesy, geometry, linalg
streams, meta = logs.load_log("data/sample_mission.npz")
base = min(s["stamps"][0] for s in streams.values())
cut = {n: {k: v[s["stamps"] < base + 5.0 + 1e-9] for k, v in s.items()}
       for n, s in streams.items()}
tmp = tempfile.mkdtemp()
logs.save_log(os.path.join(tmp, "cut.npz"), cut, meta=meta)
rep = run.main(["replay", "--log", os.path.join(tmp, "cut.npz"), "--out", tmp, "--device", "cpu"])
shutil.rmtree(tmp)
assert rep["ticks"] == 51 and np.isfinite(rep["rmse_pos"]), rep
loaded = sorted(m for m, v in sys.modules.items() if v is not None and
                m.split(".")[0] in ("jax", "jaxlib", "flax", "smarc_navigation_tpu"))
assert not loaded, loaded
print("replayed", rep["ticks"], "ticks")
"""


def test_host_layer_and_cli_run_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_CLI], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "replayed 51 ticks" in proc.stdout


def test_native_source_is_the_reference_copy():
    with open(os.path.join(REPO, "native", "smarcnav_native.cc"), "rb") as f:
        want = f.read()
    with open(os.path.join(REPO, "smarc_navigation_tpu_torch", "csrc", "smarcnav_native.cc"),
              "rb") as f:
        assert f.read() == want


def test_port_runs_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "ran 5 ticks" in proc.stdout


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


@pytest.mark.parametrize("seed", [0, 5])
def test_host_code_bitwise_equal_to_reference(seed):
    from smarc_navigation_tpu.io import sim as jsim
    from smarc_navigation_tpu.io import workloads as jworkloads
    from smarc_navigation_tpu_torch.io import sim, workloads

    spec = dict(duration_s=20.0, num_landmarks=20, mbes_std=0.05,
                dvl_dropout=(3.0, 5.0), gps_surface_z=-1.0, gps_std=0.3, seed=seed)
    m, jm = sim.simulate(sim.MissionSpec(**spec)), jsim.simulate(jsim.MissionSpec(**spec))
    for f in ("t", "pos", "rpy", "vel_body", "gyro", "landmarks"):
        assert np.array_equal(getattr(m, f), getattr(jm, f)), f
    for name, stream in m.streams.items():
        for k, v in stream.items():
            assert np.array_equal(v, jm.streams[name][k]), (name, k)
    ticks = np.linspace(0.0, 20.0, 77)
    assert np.array_equal(m.gt_at(ticks), jm.gt_at(ticks))

    cfg = workloads.combined_slam_cfg()
    tl = workloads.slam_fleet_timelines(cfg, 12.0, 3 + seed)
    jtl = jworkloads.slam_fleet_timelines(cfg, 12.0, 3 + seed)
    _assert_bitwise(_flat(tl), _flat(jtl))

    # the combined mission's SLAM and PF timelines (pf_timeline inside)
    for a, b in zip(workloads.combined_workload(cfg, 12.0, pf_seed=seed),
                    jworkloads.combined_workload(cfg, 12.0, pf_seed=seed)):
        _assert_bitwise(_flat(a), _flat(b))

    # the host and IO layer's numpy: the mission as a recorded log and its
    # timeline, observability's series, geodesy's host path, the sensor
    # glue and the aux-DR track on the mission's own fixes
    from smarc_navigation_tpu.io import logs as jlogs
    from smarc_navigation_tpu.io import observability as jobs
    from smarc_navigation_tpu.io import uw_gps as juw
    from smarc_navigation_tpu.models import sensors as jsensors
    from smarc_navigation_tpu.utils import geodesy as jgeodesy
    from smarc_navigation_tpu_torch.io import logs, observability, uw_gps
    from smarc_navigation_tpu_torch.models import sensors
    from smarc_navigation_tpu_torch.utils import geodesy

    streams, jstreams = logs.mission_to_log(m), jlogs.mission_to_log(jm)
    assert streams.keys() == jstreams.keys()
    for name in streams:
        for k in streams[name]:
            assert np.array_equal(streams[name][k], jstreams[name][k]), (name, k)
    kw = dict(freq_hz=10.0, channels=("imu", "gps"), windows={"dvl": 5},
              events={"mbes_detections": 8})
    _assert_bitwise(_flat(logs.log_to_timeline(streams, **kw)),
                    _flat(jlogs.log_to_timeline(jstreams, **kw)))
    gt = m.gt_at(ticks)
    for a, b in ((observability.tf_listener_scalars(ticks, gt),
                  jobs.tf_listener_scalars(ticks, gt)),
                 (observability.error_dashboard(ticks, {"gt": gt + 0.1}, gt),
                  jobs.error_dashboard(ticks, {"gt": gt + 0.1}, gt))):
        assert a.keys() == b.keys()
        assert all(np.array_equal(a[k], b[k]) for k in a)
    lat, lon = geodesy.utm_to_latlon(333411.0 + gt[:, 0], 6582690.0 + gt[:, 1], 34, xp=np)
    jlat, jlon = jgeodesy.utm_to_latlon(333411.0 + gt[:, 0], 6582690.0 + gt[:, 1], 34, xp=np)
    assert np.array_equal(lat, jlat) and np.array_equal(lon, jlon)
    odo, jodo = (sensors.gps_to_utm_odometry(lat, lon, 34),
                 jsensors.gps_to_utm_odometry(lat, lon, 34))
    assert np.array_equal(odo.easting, jodo.easting)
    assert np.array_equal(odo.northing, jodo.northing)
    fixes = np.stack([odo.easting, odo.northing], -1)
    q = m.streams["imu"]["values"][0, 0:4]
    got = uw_gps.aux_dr_track(ticks, fixes, q, device="cpu")
    want = juw.aux_dr_track(ticks, fixes, q)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_filter_fleet_builders_match_reference():
    """The localization and 15-state fleet builders against the same
    missions built by the reference package (as ``bench.py`` builds them)."""
    import warnings

    from smarc_navigation_tpu.configs import EKFLocConfig as JLocConfig
    from smarc_navigation_tpu.io import sim as jsim
    from smarc_navigation_tpu.models import ekf_15state as j15
    from smarc_navigation_tpu.models import ekf_localization as jloc
    from smarc_navigation_tpu.parallel import fleet as jfleet
    from smarc_navigation_tpu_torch.configs import EKFLocConfig
    from smarc_navigation_tpu_torch.io import sim, workloads
    from smarc_navigation_tpu_torch.models import ekf_15state, ekf_localization

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tl, lms = workloads.loc_fleet_timelines(EKFLocConfig(), 8.0, 3)
        jm = jsim.simulate(jsim.MissionSpec(duration_s=8.0, num_landmarks=16, dvl_std=0.05,
                                            mbes_std=0.05, seed=7))
        jtl = jfleet.batch_timelines([jloc.loc_timeline(jm, JLocConfig())] * 3)
        m = sim.simulate(sim.MissionSpec(duration_s=8.0, num_landmarks=20, mbes_std=0.05,
                                         seed=2))
        one, jone = (ekf_localization.loc_timeline(m, EKFLocConfig()),
                     jloc.loc_timeline(jsim.simulate(jsim.MissionSpec(
                         duration_s=8.0, num_landmarks=20, mbes_std=0.05, seed=2)),
                         JLocConfig()))
    _assert_bitwise(_flat(tl), _flat(jtl))
    assert np.array_equal(lms, jm.landmarks)
    _assert_bitwise(_flat(one), _flat(jone))

    cfg = ekf_15state.Ekf15Config(frequency=50.0)
    got = _flat(workloads.ekf15_fleet_timelines(cfg, 6.0, 3))
    jm15 = jsim.simulate(jsim.MissionSpec(duration_s=6.0, seed=5))
    want = _flat(jfleet.batch_timelines(
        [j15.ekf15_timeline(jm15, j15.Ekf15Config(frequency=50.0), include_gps=True)] * 3))
    float32_cols = ("channels.sbg.value", "channels.stim.value", "channels.cmd_vel.value")
    _assert_bitwise({k: v for k, v in got.items() if k not in float32_cols},
                    {k: v for k, v in want.items() if k not in float32_cols})
    for k in float32_cols:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)


def test_dr_and_raycast_builders_match_reference():
    """The SAM dead-reckoning fleet and the raycast fleet's inputs against
    the reference's numpy, built as ``bench.py`` builds them
    (``bench.py:427-430`` and ``:622-645``)."""
    from smarc_navigation_tpu.io import sim as jsim
    from smarc_navigation_tpu.models import dead_reckoning as jdr
    from smarc_navigation_tpu.ops import raycast as jraycast
    from smarc_navigation_tpu.parallel import fleet as jfleet
    from smarc_navigation_tpu_torch.io import workloads

    jm = jsim.simulate(jsim.MissionSpec(duration_s=3.0, seed=9))
    _assert_bitwise(_flat(workloads.sam_dr_fleet_timelines(3.0, 3)),
                    _flat(jfleet.batch_timelines([jdr.sam_timeline(jm)] * 3)))

    cfg, spec, gt, lms, lmm = workloads.raycast_fleet_inputs(5, 31)
    rng = np.random.default_rng(0)
    base_m = jsim.simulate(jsim.MissionSpec(duration_s=30.0, seed=1))
    want_lms = np.asarray(rng.uniform([0, -20, -16], [40, 20, -12], (5, 16, 3)), np.float32)
    ticks = np.arange(31) / cfg.system_freq
    want_gt = np.tile(base_m.gt_at(ticks).astype(np.float32), (5, 1, 1))
    for got, want in ((gt, want_gt), (lms, want_lms), (lmm, np.ones((5, 16), bool))):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert tuple(spec) == tuple(jraycast.MBESSpec(num_beams=64, floor_z=-16.0, rock_radius=1.2,
                                                   swath_rad=2.4, max_range=40.0))
    assert (cfg.max_landmarks, cfg.max_obs, cfg.mhl_dist_mbes, cfg.q_mbes_diag, cfg.r_diag) == (
        32, 8, 1.0, (0.1, 0.1, 0.1), (1e-3,) * 6)


def test_batch_timelines_checks_every_timeline():
    from smarc_navigation_tpu_torch.ops.timeline import build_timeline
    from smarc_navigation_tpu_torch.parallel import fleet

    def tl(T, K=4, name="mbes"):
        ticks = np.arange(T) / 10.0
        return build_timeline(
            0.0, (T - 1) / 10.0, 10.0, channels={"odom": (ticks, np.zeros((T, 6)))},
            events={name: (ticks[:2], np.ones((2, 3)), np.arange(2), K)})

    batched = fleet.batch_timelines([tl(8), tl(8), tl(8)])
    assert batched.ticks.shape == (3, 8)
    assert batched.events["mbes"].value.shape == (3, 8, 4, 3)
    # a mismatch in the SECOND (or any later) timeline is caught, not only
    # in the first
    for bad in (tl(9), tl(8, K=5), tl(8, name="fls")):
        with pytest.raises(ValueError, match="timeline 2"):
            fleet.batch_timelines([tl(8), tl(8), bad])
