"""The slice as a whole: the port's ``ekf_slam.run_fleet`` and ``run`` against
the JAX package's on the same timelines.

The fleet is two simulated missions with MBES detections plus FLS pixel
detections of the same landmarks through a tilted, offset sonar mount, so
one replay drives both DA kernel forms (MBES with the in-kernel predict and
the band, FLS without the predict), the fleet update with and without the
predict, new-landmark adds and re-observations. The JAX fleet runs its
Pallas kernels in TPU-interpret mode, once, in a module fixture.

Tolerances: association decisions (matched_*) and n_active are exact. Pose
tracks agree to 1e-3 over the 31 ticks: the kernels' componentwise Jacobians
and factor-form update round differently from the port's jacfwd/einsum
dense path (observed ~5e-6); the reference's own fleet-vs-dense test allows
1e-2 over 60 ticks.
"""

import dataclasses

import numpy as np
import pytest
import torch

from smarc_navigation_tpu_torch.configs import EKFSlamConfig
from smarc_navigation_tpu_torch.io import sim
from smarc_navigation_tpu_torch.models import ekf_slam as S
from smarc_navigation_tpu_torch.ops import timeline as ptl
from smarc_navigation_tpu_torch.parallel import fleet
from smarc_navigation_tpu_torch.utils.geometry import (
    Transform, quat_from_rpy_np, rotmat_from_rpy)

CFG = dataclasses.replace(
    EKFSlamConfig(), max_landmarks=8, max_obs=4, mhl_dist_mbes=1.0,
    q_mbes_diag=(0.1,) * 3, q_fls_diag=(4.0, 4.0), r_diag=(1e-3,) * 6)
DURATION = 3.0
MOUNT = ([0.0, 0.08, 0.0], [0.4, 0.0, -0.2])      # base->FLS rpy, translation
POSE_ATOL = 1e-3


def _port_params():
    tf = Transform(rot=rotmat_from_rpy(torch.tensor(MOUNT[0])),
                   trans=torch.tensor(MOUNT[1]))
    return S.make_params(CFG, tf_base_fls=tf, device="cpu")


def _raw_mission(seed, params):
    """Channel and event inputs of one mission (numpy), fed to both
    packages' timeline builders."""
    rng = np.random.default_rng(100 + seed)
    m = sim.simulate(sim.MissionSpec(
        duration_s=DURATION, num_landmarks=12, mbes_std=0.05,
        landmark_area_m=50.0, mbes_range_m=30.0, gps_surface_z=-100.0,
        seed=seed))
    ticks = np.arange(0, DURATION + 1e-9, 1.0 / CFG.system_freq)
    gt = m.gt_at(ticks)
    k = np.clip((ticks * m.spec.sim_hz).astype(int), 0, len(m.t) - 1)
    odom13 = np.concatenate(
        [gt[:, 0:3], quat_from_rpy_np(gt[:, 3:6]), m.vel_body[k], m.gyro[k]], axis=1)
    det = m.streams["mbes_detections"]
    # FLS: pixel detections of the landmarks within 25 m ahead, every 3rd tick
    f_st, f_v, f_b = [], [], []
    for i in range(0, len(ticks), 3):
        pose = torch.tensor(gt[i], dtype=torch.float32)
        for lm in m.landmarks:
            base = S.h_mbes(pose, torch.tensor(lm, dtype=torch.float32), params)
            if base[0] > 2.0 and torch.linalg.norm(base) < 25.0:
                z = S.h_fls(pose, torch.tensor(lm, dtype=torch.float32), params).numpy()
                f_st.append(ticks[i] + 1e-3)
                f_v.append([*(z + rng.normal(0, 0.5, 2)), 0.0])
                f_b.append(i)
    return dict(
        t0=0.0, t1=DURATION, freq_hz=CFG.system_freq,
        channels={"odom": (ticks, odom13)},
        events={"mbes": (det["stamps"], det["values"], det["burst"], CFG.max_obs),
                "fls": (np.asarray(f_st), np.asarray(f_v).reshape(-1, 3),
                        np.asarray(f_b), CFG.max_obs)})


@pytest.fixture(scope="module")
def case():
    """Timelines, the port's fleet run, and the JAX fleet and dense runs."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from smarc_navigation_tpu.models import ekf_slam as JS
    from smarc_navigation_tpu.ops.timeline import build_timeline
    from smarc_navigation_tpu.parallel import fleet as jfleet
    from smarc_navigation_tpu.utils.geometry import Transform as JTransform

    params = _port_params()
    raws = [_raw_mission(s, params) for s in (1, 2)]
    tls = [ptl.build_timeline(**r) for r in raws]
    jtls = [build_timeline(**r) for r in raws]
    jparams = JS.make_params(CFG, tf_base_fls=JTransform(
        rot=jnp.asarray(rotmat_from_rpy(torch.tensor(MOUNT[0])).numpy()),
        trans=jnp.asarray(np.asarray(MOUNT[1], np.float32))))
    with pltpu.force_tpu_interpret_mode():
        jfinal, jout = JS.run_fleet(jfleet.batch_timelines(jtls), jparams, CFG)
        jax.block_until_ready(jout)
    jrun = JS.run(jtls[0], jparams, CFG, update_mode="full")
    final, out = S.run_fleet(fleet.batch_timelines(tls).to("cpu"), params, CFG)
    return dict(params=params, tls=tls, final=final, out=out,
                jfinal=jfinal, jout={k: np.asarray(v) for k, v in jout.items()},
                jrun=(jrun[0], {k: np.asarray(v) for k, v in jrun[1].items()}))


def test_run_fleet_matches_jax(case):
    out, jout = case["out"], case["jout"]
    assert set(out) == set(jout)
    for key in ("matched_mbes", "matched_fls", "n_active"):
        np.testing.assert_array_equal(out[key].numpy(), jout[key], err_msg=key)
    np.testing.assert_allclose(out["mu"].numpy(), jout["mu"], atol=POSE_ATOL)
    np.testing.assert_array_equal(case["final"].active.numpy(),
                                  np.asarray(case["jfinal"].active))
    # landmark positions: FLS pixels barely observe elevation, so rounding
    # differences grow along z there (observed 4e-3 m); 1e-2 m
    np.testing.assert_allclose(case["final"].mu.numpy(), np.asarray(case["jfinal"].mu),
                               atol=1e-2)
    # both sensors really mapped and re-observed landmarks
    for key in ("matched_mbes", "matched_fls"):
        assert (out[key].numpy() >= 0).sum() > 4, key
    assert int(case["final"].n_active.min()) >= 2


@pytest.mark.parametrize("update_mode", ["full", "kernel"])
def test_run_matches_jax_dense(case, update_mode):
    """Single-mission ``run`` on mission 0: the dense full path, and the
    kernel branch (slots precomputed, the K3 contract — its plain version on
    the CPU), both against the JAX dense path."""
    tl = case["tls"][0]
    final, out = S.run(tl.to("cpu"), case["params"], CFG, update_mode=update_mode)
    jfinal, jout = case["jrun"]
    for key in ("matched_mbes", "matched_fls", "n_active"):
        np.testing.assert_array_equal(out[key].numpy(), jout[key], err_msg=key)
    np.testing.assert_allclose(out["mu"].numpy(), jout["mu"], atol=POSE_ATOL)
    np.testing.assert_allclose(out["sigma_diag6"].numpy(), jout["sigma_diag6"],
                               rtol=1e-3, atol=1e-6)
    # Σ along the FLS-weakly-observed landmark elevations differs up to ~8e-4
    # relative (same rounding growth as the landmark positions)
    jS = np.asarray(jfinal.Sigma)
    np.testing.assert_allclose(final.Sigma.numpy(), jS, rtol=2e-3,
                               atol=1e-4 * np.abs(jS).max())


def test_pallas_mode_is_the_kernel_mode(case):
    """``update_mode="pallas"``, the reference's name of the single-mission
    update-kernel path, is ``"kernel"``: ``da_commit`` (through ``step``),
    ``run`` and ``run_fleet`` give exactly what ``"kernel"`` gives; an
    unknown mode still raises."""
    params, tl = case["params"], case["tls"][0].to("cpu")
    runs = {mode: S.run(tl, params, CFG, update_mode=mode) for mode in ("kernel", "pallas")}
    fleet_p = S.run_fleet(fleet.batch_timelines([case["tls"][0]]).to("cpu"), params, CFG,
                          update_mode="pallas")
    (fk, ok), (fp, op) = runs["kernel"], runs["pallas"]
    assert set(ok) == set(op) == set(fleet_p[1])
    for key in ok:
        assert torch.equal(ok[key], op[key]), key
        assert torch.equal(ok[key], fleet_p[1][key][:, 0]), key
    for a, b, c in zip(fk, fp, fleet_p[0]):
        assert torch.equal(a, b) and torch.equal(a, c[0])
    # one tick with an MBES burst, from the replay's final state
    k = int(np.flatnonzero(tl.events["mbes"].mask.any(1).numpy())[-1])
    tick = tl.slice_tick(k)
    sk, outk = S.step(CFG, params, fk, tick, update_mode="kernel")
    sp, outp = S.step(CFG, params, fk, tick, update_mode="pallas")
    assert int((outk["matched_mbes"] >= 0).sum()) > 0
    assert all(torch.equal(a, b) for a, b in zip(sk, sp))
    assert all(torch.equal(outk[key], outp[key]) for key in outk)
    with pytest.raises(ValueError, match="update_mode"):
        S.step(CFG, params, fk, tick, update_mode="lowrank")


def test_run_fleet_mission_equals_run(case):
    """The fleet replay of a mission is the single-mission replay."""
    tl = case["tls"][1]
    _, out = S.run(tl.to("cpu"), case["params"], CFG, update_mode="full")
    for key in ("matched_mbes", "matched_fls", "n_active"):
        np.testing.assert_array_equal(case["out"][key][:, 1].numpy(), out[key].numpy())
    np.testing.assert_allclose(case["out"]["mu"][:, 1].numpy(), out["mu"].numpy(),
                               atol=POSE_ATOL)


def test_run_fleet_invalid_odometry_is_a_noop():
    """A mission whose odometry has not arrived yet keeps its state exactly
    (identity a8, zero R̃, masked detections)."""
    params = S.make_params(CFG, device="cpu")
    raw = _raw_mission(3, params)
    ticks = raw["channels"]["odom"][0]
    raw["channels"]["odom"] = (ticks[5:], raw["channels"]["odom"][1][5:])
    tl = fleet.batch_timelines([ptl.build_timeline(**raw)]).to("cpu")
    assert not bool(tl.channels["odom"].valid[0, :5].any())
    final, out = S.run_fleet(tl.map(lambda x: x[:, :5]), params, CFG)
    s0 = S.init_state(CFG, device="cpu")
    assert torch.equal(final.mu[0], s0.mu) and torch.equal(final.Sigma[0], s0.Sigma)
    assert (out["matched_mbes"] == -1).all()


def test_unported_modes_raise():
    """A mission mesh that does not split the fleet evenly is refused (the
    reference's check), and so is an unknown covariance mode."""
    from smarc_navigation_tpu_torch.parallel import mesh

    tl = fleet.batch_timelines([ptl.build_timeline(**_raw_mission(1, _port_params()))])
    with pytest.raises(ValueError, match="not divisible by mission axis"):
        S.run_fleet(tl.to("cpu"), _port_params(), CFG,
                    device_mesh=mesh.make_mesh(mission=2, devices=[torch.device("cpu")] * 2))
    with pytest.raises(ValueError, match="update_mode"):
        S.run_fleet(tl.to("cpu"), _port_params(), CFG, update_mode="lowrank")
