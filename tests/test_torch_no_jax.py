"""The port stands alone: it runs with JAX and flax blocked (the SLAM fleet
replay in both covariance semantics, the fleet assignment, the PF kernel
path and the combined mission, at a tiny size on the CPU), and its numpy host code (simulator, timeline construction, fleet batching,
the PF and combined workloads) produces arrays bitwise equal to the
reference package's."""

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
loaded = sorted(m for m, v in sys.modules.items() if v is not None and
                m.split(".")[0] in ("jax", "jaxlib", "flax", "smarc_navigation_tpu"))
assert not loaded, loaded
print("ran", out["mu"].shape[0], "ticks; n_active", final.n_active.tolist())
"""


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
