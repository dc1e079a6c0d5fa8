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

The online step's pass on CUDA state (K1 + K2 on B=1 views) is held to
``data_associate_update``'s kernel mode on the CPU, and on the card (tests
marked ``cuda``) to the CPU's kernel mode over a recorded log.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from smarc_navigation_tpu_torch.configs import EKFSlamConfig
from smarc_navigation_tpu_torch.io import sim
from smarc_navigation_tpu_torch.models import ekf_slam as S
from smarc_navigation_tpu_torch.ops import timeline as ptl
from smarc_navigation_tpu_torch.parallel import fleet
from smarc_navigation_tpu_torch.utils.geometry import (
    Transform, odom_pose, quat_from_rpy_np, rotmat_from_rpy)

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


# ``_update_path``'s whole table: the path of each update_mode by caller,
# device and solver; None: the mode raises ValueError
PATH_COLUMNS = [                                          # (cuda, solver, fleet)
    (False, None, False), (True, None, False),            # da_commit
    (False, "device", False), (False, "host", False),     # step on CPU state
    (True, "device", False), (True, "host", False),       # step on CUDA state
    (False, None, True), (True, None, True),              # run_fleet
]
PATH_TABLE = {
    "auto": ["full", "kernel", "full", "full", "lanes", "kernel", "fleet", "fleet"],
    "full": ["full"] * 6 + ["fleet"] * 2,
    "kernel": ["kernel"] * 4 + ["lanes", "kernel"] + ["kernel"] * 2,
    "pallas": ["kernel"] * 4 + ["lanes", "kernel"] + ["kernel"] * 2,
    "marginal": ["marginal"] * 6 + ["fleet_marginal"] * 2,
    "marginal_dense": [None] * 6 + ["marginal"] * 2,
    "lowrank": [None] * 8,
}


@pytest.mark.parametrize("mode", sorted(PATH_TABLE))
def test_update_path_maps_every_mode_in_one_place(mode):
    """``_update_path``, the one function that maps ``update_mode`` for
    ``da_commit``, ``step`` and ``run_fleet``: its path for every caller,
    device and solver, and ``ValueError`` where the caller has no such
    mode."""
    for (cuda, solver, on_fleet), want in zip(PATH_COLUMNS, PATH_TABLE[mode]):
        where = (cuda, solver, on_fleet)
        if want is None:
            with pytest.raises(ValueError, match="update_mode"):
                S._update_path(mode, cuda, solver, on_fleet)
        else:
            assert S._update_path(mode, cuda, solver, on_fleet) == want, where


# ---------------------------------------------------------------------------
# the online step's pass on CUDA state: K1 + K2 on B=1 views
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mission", [0, 1])
@pytest.mark.parametrize("sensor", ["mbes", "fls"])
def test_step_lanes_pass_is_the_kernel_mode(case, mission, sensor):
    """``step``'s pass on CUDA state (``_lanes_step_pass``: K1 + K2 on B=1
    views), here on the kernels' plain versions, against
    ``data_associate_update``'s kernel mode on the same predicted state at
    every tick with detections: the same associations, activations and
    landmark count, the same shapes and dtypes, states within the
    fleet-vs-run tolerance."""
    params, tl = case["params"], case["tls"][mission].to("cpu")
    spec = {"mbes": S.MBES, "fls": S.FLS}[sensor]
    st = S.init_state(CFG, device="cpu")
    passes = matches = 0
    for k in range(tl.num_ticks):
        tick = tl.slice_tick(k)
        ev = tick.events[sensor]
        if bool(ev.mask.any()):
            pred = S.predict(st, odom_pose(tick.channels["odom"].value), params)
            got, m_got = S._lanes_step_pass(pred, ev.value, ev.mask, params, CFG, spec)
            want, m_want = S.data_associate_update(pred, ev.value, ev.mask, params, CFG, spec,
                                                   update_mode="kernel")
            assert m_got.dtype == m_want.dtype and torch.equal(m_got, m_want), k
            for a, b in zip(got, want):
                assert a.shape == b.shape and a.dtype == b.dtype
            assert torch.equal(got.active, want.active) and torch.equal(got.n_active, want.n_active)
            assert torch.equal(got.mu_auv_odom, want.mu_auv_odom)
            np.testing.assert_allclose(got.mu.numpy(), want.mu.numpy(), atol=POSE_ATOL)
            np.testing.assert_allclose(got.Sigma.numpy(), want.Sigma.numpy(),
                                       atol=POSE_ATOL * float(want.Sigma.abs().max()))
            passes += 1
            matches += int((m_got >= 0).sum())
        st, _ = S.step(CFG, params, st, tick, update_mode="kernel")
    assert passes >= 10 and matches > passes, (passes, matches)


@pytest.mark.parametrize("solver, update_mode", [
    ("device", "auto"), ("device", "kernel"), ("device", "pallas"), ("device", "full"),
    ("device", "marginal"), ("host", "auto"), ("host", "kernel"),
])
def test_step_on_cpu_state_keeps_the_torch_pass(case, monkeypatch, solver, update_mode):
    """On CPU state every mode and solver keeps ``data_associate_update``'s
    pass: ``da_lanes`` is never called, and each tick is bit for bit the
    predict, that pass per sensor with detections and the odometry gate."""
    from smarc_navigation_tpu_torch.ops import slam_da_kernels

    calls = []
    da_lanes = slam_da_kernels.da_lanes
    monkeypatch.setattr(slam_da_kernels, "da_lanes",
                        lambda *a, **k: calls.append(1) or da_lanes(*a, **k))
    params, tl = case["params"], case["tls"][0].to("cpu")
    st = ref = S.init_state(CFG, device="cpu")
    for k in range(tl.num_ticks):
        tick = tl.slice_tick(k)
        st, out = S.step(CFG, params, st, tick, solver, update_mode)
        odom = tick.channels["odom"]
        new = S.predict(ref, odom_pose(odom.value), params)
        for name, spec in (("mbes", S.MBES), ("fls", S.FLS)):
            ev = tick.events[name]
            matched = torch.full(ev.mask.shape, -1, dtype=torch.int32)
            if bool(ev.mask.any()):
                new, matched = S.data_associate_update(new, ev.value, ev.mask, params, CFG,
                                                       spec, solver, update_mode)
            assert torch.equal(out["matched_" + name], matched), (k, name)
        ref = S.SlamState(*(torch.where(odom.valid, a, b) for a, b in zip(new, ref)))
        assert all(torch.equal(a, b) for a, b in zip(st, ref)), k
    assert not calls
    assert int(st.n_active) >= 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


LOG_TICKS = 300     # the sample log's first 30 s


def _lolo_log(dev):
    """``run.py replay``'s configuration and parameters on ``dev``, and its
    default log's first LOG_TICKS ticks as a timeline on the CPU."""
    from smarc_navigation_tpu_torch.io import logs

    cfg = dataclasses.replace(EKFSlamConfig(), max_landmarks=64, max_obs=8, mhl_dist_mbes=1.0,
                              q_mbes_diag=(0.1,) * 3, r_diag=(1e-3,) * 6)
    streams, _ = logs.load_log(str(Path(__file__).resolve().parents[1] / "data"
                                   / "sample_mission.npz"))
    tl = logs.log_to_timeline(streams, freq_hz=cfg.system_freq, channels=("odom",),
                              events={"mbes": cfg.max_obs})
    tl = tl.map(lambda x: torch.as_tensor(x[:LOG_TICKS]))
    return cfg, S.make_params(cfg, device=dev), tl


def _launches():
    from smarc_navigation_tpu_torch.ops import slam_da_kernels, slam_kernels

    return {f.__name__: f.launches for f in (
        slam_da_kernels.da_lanes, slam_kernels.sequential_update_fleet,
        slam_kernels.symmetric_downdate, slam_kernels.sequential_update)}


def _delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in _launches().items()}


@pytest.mark.cuda
def test_card_run_is_the_cpu_kernel_mode(cuda, monkeypatch):
    """``run`` of a LoLo log on CUDA state (each pass K1 + K2 at B=1)
    against the same log through the CPU's kernel mode: matched_mbes and
    n_active exactly, states within tolerance; K1, K2 and K12 launch once
    per tick with detections, K3 never, and the torch JV is never called."""
    from smarc_navigation_tpu_torch.ops import assignment

    cfg, params, tl = _lolo_log(cuda)
    n_burst = int(tl.events["mbes"].mask.any(-1).sum())
    assert n_burst >= 50
    calls = []
    hungarian = assignment.hungarian
    monkeypatch.setattr(assignment, "hungarian",
                        lambda *a, **k: calls.append(1) or hungarian(*a, **k))
    n0 = _launches()
    final, out = S.run(tl.to(cuda), params, cfg)
    torch.cuda.synchronize()
    assert _delta(n0) == {"da_lanes": n_burst, "sequential_update_fleet": n_burst,
                          "symmetric_downdate": n_burst, "sequential_update": 0}
    assert not calls
    cpu_final, cpu_out = S.run(tl, S.make_params(cfg, device="cpu"), cfg, update_mode="kernel")
    for key in ("matched_mbes", "n_active"):
        assert out[key].dtype == cpu_out[key].dtype
        assert torch.equal(out[key].cpu(), cpu_out[key]), key
    np.testing.assert_allclose(out["mu"].cpu().numpy(), cpu_out["mu"].numpy(), atol=POSE_ATOL)
    np.testing.assert_allclose(out["sigma_diag6"].cpu().numpy(), cpu_out["sigma_diag6"].numpy(),
                               rtol=1e-3, atol=1e-6)
    S_cpu = cpu_final.Sigma.numpy()
    np.testing.assert_allclose(final.Sigma.cpu().numpy(), S_cpu, rtol=2e-3,
                               atol=1e-4 * np.abs(S_cpu).max())
    assert int(final.n_active) >= 5


@pytest.mark.cuda
@pytest.mark.parametrize("solver, update_mode, k3", [
    ("host", "auto", True), ("device", "full", False), ("device", "marginal", False)])
def test_card_step_off_the_kernel_mode_keeps_the_torch_pass(cuda, solver, update_mode, k3):
    """On CUDA state the host solver and the dense modes keep
    ``data_associate_update``'s pass: no K1 or K2 launch; K3 only where the
    mode resolves to the kernel branch."""
    cfg, params, tl = _lolo_log(cuda)
    tl = tl.map(lambda x: x[:60]).to(cuda)
    n_burst = int(tl.events["mbes"].mask.any(-1).sum())
    assert n_burst >= 10
    n0 = _launches()
    S.run(tl, params, cfg, solver=solver, update_mode=update_mode)
    torch.cuda.synchronize()
    assert _delta(n0) == {"da_lanes": 0, "sequential_update_fleet": 0,
                          "symmetric_downdate": n_burst if k3 else 0,
                          "sequential_update": n_burst if k3 else 0}


# kernels of one eager fleet tick of CFG with both sensors (B=2), counted
# by torch.profiler on an H100 before the fleet pass was split for the step
FLEET_TICK_KERNELS = 135


@pytest.mark.cuda
def test_card_fleet_launches_per_tick(cuda):
    """The fleet pass, split into its K1 and K2 halves for the step, still
    launches in a fleet tick K1, K2 and K12 once per sensor pass and, in
    all, the kernels it launched before the split."""
    params = S.SlamParams(*(x.to(cuda) for x in _port_params()))
    tls = [ptl.build_timeline(**_raw_mission(s, _port_params())) for s in (1, 2)]
    inp, names = S._loop_inputs(fleet.batch_timelines(tls).to(cuda), params, CFG)
    params, s0, consts, c12 = S._loop_setup(inp, names)
    B, L = inp["valid"].shape[1], CFG.max_landmarks
    state = S.SlamState(*(x.expand((B,) + x.shape).contiguous() for x in s0))
    band = inp["band0"].expand(B, 24, L).contiguous()

    def tick(t, state, band):
        return S._full_tick(state, band, inp["odom_pose"][t], inp["valid"][t],
                            S._tick_events(inp, names, t), params, CFG, consts, c12)[:2]

    state, band = tick(0, state, band)      # first use: builds and loads the kernels
    torch.cuda.synchronize()
    n0 = _launches()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for t in (1, 2, 3):
            state, band = tick(t, state, band)
        torch.cuda.synchronize()
    assert _delta(n0) == {"da_lanes": 6, "sequential_update_fleet": 6,
                          "symmetric_downdate": 6, "sequential_update": 0}
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.key.startswith(("Memcpy", "Memset")))
    assert kernels == 3 * FLEET_TICK_KERNELS, kernels / 3
