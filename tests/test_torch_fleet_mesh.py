"""The port's mission-sharded fleets (``device_mesh=`` of
``ekf_slam.run_fleet``, ``fleet.run_raycast_fleet`` and ``fleet.run_fleet``)
against their unsharded runs and against the JAX package's.

On the CPU a mesh is ``make_mesh(..., devices=[cpu] * k)``: each mission
shard replays its missions in this process. Tolerances and why: every
sharded replay is BITWISE its unsharded run (missions are independent and
each mission's arithmetic does not depend on how many missions share its
batch; the particle-sharded PF's draws are keyed on the global particle
index and its resample is order-pinned). Against the JAX package: the SLAM
fleet at ``tests/test_torch_ekf_slam.py``'s tolerances (associations and
n_active exact, poses 1e-3), its JAX side the unsharded kernel fleet in
interpret mode (the sharded one hangs there, ``tests/test_slam_fleet.py``);
the SLAM + PF fleet's SLAM ``mu`` against the JAX dry run's sharded fleet
(``__graft_entry__._dryrun_impl``, mesh (4, 2), 2 missions per mission
shard, 2 x 2048 particles) at its own 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

from smarc_navigation_tpu_torch.configs import EKFSlamConfig, PFConfig
from smarc_navigation_tpu_torch.io import sim
from smarc_navigation_tpu_torch.io.workloads import raycast_fleet_inputs
from smarc_navigation_tpu_torch.models import ekf_slam as S
from smarc_navigation_tpu_torch.models import particle_filter as pf
from smarc_navigation_tpu_torch.ops import timeline as ptl
from smarc_navigation_tpu_torch.parallel import fleet, mesh
from smarc_navigation_tpu_torch.parallel import resample_dist as RD
from smarc_navigation_tpu_torch.utils.geometry import quat_from_rpy_np

CPU = torch.device("cpu")
# tests/test_torch_ekf_slam.py's fleet config (MBES only here)
CFG = dataclasses.replace(EKFSlamConfig(), max_landmarks=8, max_obs=4, mhl_dist_mbes=1.0,
                          q_mbes_diag=(0.1,) * 3, q_fls_diag=(4.0, 4.0), r_diag=(1e-3,) * 6)
DURATION = 3.0
POSE_ATOL = 1e-3


def _cpu_mesh(mission=1, particle=1):
    return mesh.make_mesh(mission=mission, particle=particle,
                          devices=[CPU] * (mission * particle))


def _leaves_equal(a, b):
    la, lb = mesh._leaves(a), mesh._leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _raw_mission(seed):
    """One simulated mission's odometry and MBES detections (numpy), for
    both packages' timeline builders."""
    m = sim.simulate(sim.MissionSpec(duration_s=DURATION, num_landmarks=12, mbes_std=0.05,
                                     landmark_area_m=50.0, mbes_range_m=30.0,
                                     gps_surface_z=-100.0, seed=seed))
    ticks = np.arange(0, DURATION + 1e-9, 1.0 / CFG.system_freq)
    gt = m.gt_at(ticks)
    k = np.clip((ticks * m.spec.sim_hz).astype(int), 0, len(m.t) - 1)
    odom13 = np.concatenate(
        [gt[:, 0:3], quat_from_rpy_np(gt[:, 3:6]), m.vel_body[k], m.gyro[k]], axis=1)
    det = m.streams["mbes_detections"]
    return dict(t0=0.0, t1=DURATION, freq_hz=CFG.system_freq,
                channels={"odom": (ticks, odom13)},
                events={"mbes": (det["stamps"], det["values"], det["burst"], CFG.max_obs)})


@pytest.fixture(scope="module")
def slam_case():
    raws = [_raw_mission(s) for s in (1, 2)]
    tl = fleet.batch_timelines([ptl.build_timeline(**raws[b % 2]) for b in range(4)]).to("cpu")
    return raws, tl, S.make_params(CFG, device="cpu")


@pytest.mark.parametrize("mode", ["auto", "marginal"])
def test_slam_run_fleet_mission_mesh_bitwise(slam_case, mode):
    _, tl, params = slam_case
    ref = S.run_fleet(tl, params, CFG, update_mode=mode)
    got = S.run_fleet(tl, params, CFG, update_mode=mode, device_mesh=_cpu_mesh(mission=4))
    assert _leaves_equal(got, ref)
    # a (2, 2) mesh: mission shards of two missions, run once per row
    got2 = S.run_fleet(tl, params, CFG, update_mode=mode, device_mesh=_cpu_mesh(2, 2))
    assert _leaves_equal(got2, ref)
    assert int(ref[1]["n_active"][-1].min()) > 0


def test_slam_run_fleet_mission_mesh_matches_jax(slam_case):
    """The sharded fleet against the JAX package's unsharded kernel fleet
    (interpret mode) on the same two missions (the port's four are them
    twice)."""
    import jax
    from jax.experimental.pallas import tpu as pltpu

    from smarc_navigation_tpu.models import ekf_slam as JS
    from smarc_navigation_tpu.ops.timeline import build_timeline
    from smarc_navigation_tpu.parallel import fleet as jfleet

    raws, tl, params = slam_case
    with pltpu.force_tpu_interpret_mode():
        jfinal, jout = JS.run_fleet(jfleet.batch_timelines([build_timeline(**r) for r in raws]),
                                    JS.make_params(CFG), CFG)
        jax.block_until_ready(jout)
    final, out = S.run_fleet(tl, params, CFG, device_mesh=_cpu_mesh(mission=4))
    for b in range(4):
        for key in ("matched_mbes", "n_active"):
            np.testing.assert_array_equal(out[key][:, b].numpy(), np.asarray(jout[key])[:, b % 2],
                                          err_msg=key)
        np.testing.assert_allclose(out["mu"][:, b].numpy(), np.asarray(jout["mu"])[:, b % 2],
                                   atol=POSE_ATOL)
        np.testing.assert_array_equal(final.active[b].numpy(), np.asarray(jfinal.active)[b % 2])


@pytest.mark.parametrize("use_da_kernel", [True, False])
def test_raycast_fleet_mission_mesh_bitwise(use_da_kernel):
    rcfg, spec, gt, lms, lmm = raycast_fleet_inputs(8, 10)
    args = (torch.as_tensor(gt), torch.as_tensor(lms), torch.as_tensor(lmm), rcfg,
            S.make_params(rcfg, device="cpu"), spec)
    ref = fleet.run_raycast_fleet(*args, use_da_kernel=use_da_kernel)
    got = fleet.run_raycast_fleet(*args, device_mesh=_cpu_mesh(mission=4),
                                  use_da_kernel=use_da_kernel)
    assert _leaves_equal(got, ref)
    assert int(ref[1][1][:, -1].sum()) > 0      # the fleet maps rocks


# ---------------------------------------------------------------------------
# the SLAM + PF fleet over (mission, particle): __graft_entry__'s dry run
# ---------------------------------------------------------------------------

B_DRY, N_DRY = 8, 2 * 2048
# __graft_entry__._slam_setup(8, 4)
DRY_CFG = dataclasses.replace(EKFSlamConfig(), max_landmarks=8, max_obs=4, mhl_dist_mbes=1.0,
                              q_mbes_diag=(0.1,) * 3, r_diag=(1e-3,) * 6)


def _tiny_raw(T=4, seed=0):
    """``__graft_entry__._tiny_timeline``'s inputs, for the port's builder."""
    rng = np.random.default_rng(seed)
    stamps = np.arange(1, T + 1) / DRY_CFG.system_freq
    odom13 = np.concatenate([rng.normal(0, 0.1, (T, 3)), np.tile([0, 0, 0, 1.0], (T, 1)),
                             rng.normal(0, 0.1, (T, 6))], axis=1)
    det = stamps[:T // 2]
    return dict(t0=0.0, t1=T / DRY_CFG.system_freq, freq_hz=DRY_CFG.system_freq,
                channels={"odom": (stamps, odom13), "gps": (stamps, odom13[:, :2]),
                          "diving": (stamps, np.zeros((T, 1)))},
                events={"mbes": (det, rng.normal(0, 5.0, (len(det), 3)), np.arange(len(det)),
                                 DRY_CFG.max_obs)})


@pytest.fixture(scope="module")
def dry_jax():
    """The JAX dry run's particle-sharded fleet (``__graft_entry__.py:
    123-152``): mesh (4, 2), two missions per mission shard, 2 x 2048
    particles, its own tiny timelines."""
    import jax

    import __graft_entry__ as g
    from smarc_navigation_tpu.configs import PFConfig as JPFConfig
    from smarc_navigation_tpu.models import particle_filter as JPF
    from smarc_navigation_tpu.parallel import fleet as jfleet
    from smarc_navigation_tpu.parallel import mesh as jmesh

    cfg, params, _ = g._slam_setup(max_landmarks=8, max_obs=4)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(DRY_CFG)
    jcfg = JPFConfig(particle_count=N_DRY)
    batched = jfleet.batch_timelines([g._tiny_timeline(cfg, T=4, seed=i) for i in range(B_DRY)])
    final, out = jax.jit(lambda t: jfleet.run_fleet(
        t, cfg, params, jcfg, JPF.make_params(jcfg), N_DRY,
        device_mesh=jmesh.make_mesh(mission=4, particle=2)))(batched)
    return np.asarray(final.slam.mu), np.asarray(out["pf"]["mean"])


def test_slam_pf_fleet_mission_particle_mesh(dry_jax):
    tl = fleet.batch_timelines([ptl.build_timeline(**_tiny_raw(seed=i))
                                for i in range(B_DRY)]).to("cpu")
    pcfg = PFConfig(particle_count=N_DRY)
    sp, pp = S.make_params(DRY_CFG, device="cpu"), pf.make_params(pcfg, device="cpu")
    ref = fleet.run_fleet(tl, DRY_CFG, sp, pcfg, pp, N_DRY, pf_scheme="systematic")
    RD.exact_fallbacks = 0
    got = fleet.run_fleet(tl, DRY_CFG, sp, pcfg, pp, N_DRY,
                          device_mesh=_cpu_mesh(mission=4, particle=2))
    assert _leaves_equal(got, ref)
    assert got[0].pf.particles.shape == (B_DRY, 6, N_DRY)
    assert bool(got[1]["pf"]["updated"].any()) and RD.exact_fallbacks == 0
    np.testing.assert_allclose(got[0].slam.mu.numpy(), dry_jax[0], rtol=1e-5, atol=1e-5)
    assert bool(torch.isfinite(got[1]["pf"]["mean"]).all())
    # fleet_step on the same mesh: one tick, bitwise the unsharded step
    state = fleet.init_fleet(B_DRY, N_DRY, DRY_CFG, pp, pcfg)
    tick = tl.map(lambda x: x[:, 0])
    one = fleet.fleet_step(DRY_CFG, sp, pcfg, pp, state, tick, pf_scheme="systematic")
    shd = fleet.fleet_step(DRY_CFG, sp, pcfg, pp, state, tick, pf_scheme="systematic",
                           pf_pmesh=_cpu_mesh(mission=4, particle=2))
    assert _leaves_equal(shd, one)
