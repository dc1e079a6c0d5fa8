"""The mission fleets of ``parallel/fleet.py`` and
``particle_filter.fleet_update_resample`` against the JAX package's.

On the CPU (tier-1):
- the closed-loop raycast fleet at ``tests/test_slam_fleet.py``'s raycast
  shape (B=2, T=40, L=16, M=4, 32 beams, 8 rocks): the kernel path (the
  kernels' plain versions) against the reference's ``run_raycast_fleet(
  use_da_kernel=True)`` with its Pallas kernels in TPU-interpret mode, and
  the dense path against the reference's dense path. ``n_active`` exact;
  poses within 1e-2, the reference's own kernel-vs-dense bound (observed
  ~3e-6), Σ within 1e-4;
- the SLAM + PF fleet at ``tests/test_fleet.py``'s shape (3 missions,
  T=4, 32 particles) with every PF noise std zero (JAX's random streams
  cannot be reproduced): SLAM associations and n_active exact, poses and
  the PF mean within 1e-4, in both PF schemes;
- the fleet's batched PF functions against the single-bank ones, bitwise,
  in every scheme; its draws keyed per mission; ``fleet_step`` against
  ``run_fleet`` with the noise on (the same draws: 1e-5);
- ``fleet_update_resample`` on the reference's own uniforms (drawn from its
  keys as it draws them) and zero jitter: the resampled banks, hence the
  ancestors, exact;
- the converter of the reference's fleet state.

On the card (``cuda``): the graphed raycast replay against its eager loop,
bitwise, with K1, K2 and K12 launched once per tick; the dense path against
the kernel path; K1 and K2 at the benchmark's B=1024 against their plain
versions; the graphed SLAM + PF replay against its eager loop and against
the CPU. This file imports JAX only inside its CPU tests' fixtures, so the
card runs it with ``--noconftest``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from smarc_navigation_tpu_torch.configs import EKFSlamConfig, PFConfig
from smarc_navigation_tpu_torch.models import ekf_slam as S
from smarc_navigation_tpu_torch.models import particle_filter as pf
from smarc_navigation_tpu_torch.ops import pf_kernels, raycast
from smarc_navigation_tpu_torch.ops import slam_da_kernels as k1
from smarc_navigation_tpu_torch.ops import slam_kernels as k2
from smarc_navigation_tpu_torch.ops.timeline import build_timeline
from smarc_navigation_tpu_torch.parallel import fleet
from smarc_navigation_tpu_torch.utils import graphs

RC_CFG = dataclasses.replace(EKFSlamConfig(), max_landmarks=16, max_obs=4, mhl_dist_mbes=1.0,
                             q_mbes_diag=(0.1,) * 3, r_diag=(1e-3,) * 6)
RC_SPEC = dict(num_beams=32, floor_z=-16.0, rock_radius=1.2, swath_rad=2.4, max_range=40.0)
FL_CFG = dataclasses.replace(EKFSlamConfig(), max_landmarks=8, max_obs=4, mhl_dist_mbes=1.0,
                             q_mbes_diag=(0.1,) * 3, r_diag=(1e-3,) * 6)
ZERO_PF = dict(particle_count=32, init_cov=(0.0,) * 6, motion_cov=(0.0,) * 6,
               res_noise_cov=(0.0,) * 6)


def _raycast_case(B=2, T=40, seed=0):
    """``tests/test_slam_fleet.py``'s raycast inputs (numpy): the seed-1
    mission's first T poses tiled to B, 8 rocks per mission."""
    from smarc_navigation_tpu_torch.io import sim

    rng = np.random.default_rng(seed)
    m = sim.simulate(sim.MissionSpec(duration_s=10.0, seed=1))
    gt = np.tile(m.gt_at(np.arange(T) / RC_CFG.system_freq).astype(np.float32), (B, 1, 1))
    lms = rng.uniform([0, -20, -16], [40, 20, -12], (B, 8, 3)).astype(np.float32)
    return gt, lms, np.ones((B, 8), bool)


@pytest.fixture(scope="module")
def raycast_jax():
    """The reference's kernel path (interpret mode) and dense path on the
    raycast case."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from smarc_navigation_tpu.models import ekf_slam as JS
    from smarc_navigation_tpu.ops import raycast as jr
    from smarc_navigation_tpu.parallel.fleet import run_raycast_fleet

    gt, lms, lmm = _raycast_case()
    args = (jnp.asarray(gt), jnp.asarray(lms), jnp.asarray(lmm), RC_CFG, JS.make_params(RC_CFG),
            jr.MBESSpec(**RC_SPEC))
    with pltpu.force_tpu_interpret_mode():
        fin_k, (mu_k, na_k) = run_raycast_fleet(*args, use_da_kernel=True)
    fin_d, (mu_d, na_d) = run_raycast_fleet(*args, use_da_kernel=False)
    return {"kernel": (fin_k, np.asarray(mu_k), np.asarray(na_k)),
            "dense": (fin_d, np.asarray(mu_d), np.asarray(na_d))}


def _port_raycast(use_da_kernel, device="cpu", **kw):
    gt, lms, lmm = _raycast_case(**kw)
    return fleet.run_raycast_fleet(
        torch.as_tensor(gt, device=device), torch.as_tensor(lms, device=device),
        torch.as_tensor(lmm, device=device), RC_CFG, S.make_params(RC_CFG, device=device),
        raycast.MBESSpec(**RC_SPEC), use_da_kernel=use_da_kernel)


@pytest.mark.parametrize("path", ["kernel", "dense"])
def test_raycast_fleet_matches_jax(raycast_jax, path):
    fin, (mu, na) = _port_raycast(path == "kernel")
    jfin, jmu, jna = raycast_jax[path]
    assert mu.shape == (2, 40, 6) and na.shape == (2, 40)
    np.testing.assert_array_equal(na.numpy(), jna)
    assert int(na[:, -1].sum()) > 0          # the case maps rocks
    np.testing.assert_allclose(mu.numpy(), jmu, rtol=0, atol=1e-2)
    np.testing.assert_allclose(fin.Sigma.numpy(), np.asarray(jfin.Sigma), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(fin.active.numpy(), np.asarray(jfin.active))


def test_raycast_fleet_default_on_cpu_is_the_dense_path():
    got = _port_raycast(None, B=1, T=12)
    want = _port_raycast(False, B=1, T=12)
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
    assert torch.equal(got[1][0], want[1][0]) and torch.equal(got[1][1], want[1][1])


def test_multi_device_arguments_raise():
    """The multi-device arguments refuse what the reference refuses: a
    mission mesh that does not split the fleet, and particle sharding with
    another scheme than the systematic one."""
    from smarc_navigation_tpu_torch.parallel import mesh

    cpu2 = [torch.device("cpu")] * 2
    gt, lms, lmm = (torch.as_tensor(x) for x in _raycast_case(B=1, T=2))
    with pytest.raises(ValueError, match="not divisible by mission axis"):
        fleet.run_raycast_fleet(gt, lms, lmm, RC_CFG, S.make_params(RC_CFG, device="cpu"),
                                device_mesh=mesh.make_mesh(mission=2, devices=cpu2))
    params = pf.make_params(PFConfig(**ZERO_PF), device="cpu")
    state = fleet.init_fleet(2, 8, FL_CFG, params, PFConfig(**ZERO_PF))
    pm = mesh.make_mesh(particle=2, devices=cpu2)
    with pytest.raises(ValueError, match="systematic"):
        pf.fleet_update_resample(state.pf, torch.zeros(2, 2), params, pmesh=pm, scheme="residual")
    with pytest.raises(ValueError, match="systematic"):
        fleet.fleet_step(FL_CFG, None, PFConfig(**ZERO_PF), params, state, None,
                         pf_pmesh=pm)


# ---------------------------------------------------------------------------
# the SLAM + PF fleet
# ---------------------------------------------------------------------------

def _tiny_raw(T=4, seed=0):
    """``__graft_entry__._tiny_timeline``'s inputs (odometry, GPS, diving,
    MBES events), for both packages' builders."""
    rng = np.random.default_rng(seed)
    stamps = np.arange(1, T + 1) / FL_CFG.system_freq
    odom13 = np.concatenate([rng.normal(0, 0.1, (T, 3)), np.tile([0, 0, 0, 1.0], (T, 1)),
                             rng.normal(0, 0.1, (T, 6))], axis=1)
    det = stamps[:T // 2]
    return dict(t0=0.0, t1=T / FL_CFG.system_freq, freq_hz=FL_CFG.system_freq,
                channels={"odom": (stamps, odom13), "gps": (stamps, odom13[:, :2]),
                          "diving": (stamps, np.zeros((T, 1)))},
                events={"mbes": (det, rng.normal(0, 5.0, (len(det), 3)), np.arange(len(det)),
                                 FL_CFG.max_obs)})


@pytest.fixture(scope="module")
def fleet_jax():
    import jax

    from smarc_navigation_tpu.configs import PFConfig as JPFConfig
    from smarc_navigation_tpu.models import ekf_slam as JS
    from smarc_navigation_tpu.models import particle_filter as JPF
    from smarc_navigation_tpu.ops.timeline import build_timeline as jbuild
    from smarc_navigation_tpu.parallel import fleet as jfleet

    jtl = jfleet.batch_timelines([jbuild(**_tiny_raw(seed=i)) for i in range(3)])
    jcfg = JPFConfig(**ZERO_PF)
    runs = {}
    for scheme in ("residual", "systematic"):
        final, out = jax.jit(lambda t, s=scheme: jfleet.run_fleet(
            t, FL_CFG, JS.make_params(FL_CFG), jcfg, JPF.make_params(jcfg), 32,
            pf_scheme=s))(jtl)
        runs[scheme] = (final, jax.tree_util.tree_map(np.asarray, out))
    return runs


def _port_fleet_timeline():
    return fleet.batch_timelines([build_timeline(**_tiny_raw(seed=i)) for i in range(3)]).to("cpu")


@pytest.mark.parametrize("scheme", ["residual", "systematic"])
def test_slam_pf_fleet_matches_jax(fleet_jax, scheme):
    jfinal, jout = fleet_jax[scheme]
    cfg = PFConfig(**ZERO_PF)
    final, out = fleet.run_fleet(_port_fleet_timeline(), FL_CFG, S.make_params(FL_CFG, device="cpu"),
                                 cfg, pf.make_params(cfg, device="cpu"), 32, pf_scheme=scheme)
    assert final.pf.particles.shape == (3, 6, 32) and final.pf.key.shape == (3,)
    assert set(out) == {"slam", "pf"}
    for part in ("slam", "pf"):
        assert set(out[part]) == set(jout[part]), part
        for k, v in out[part].items():
            want = jout[part][k]
            assert tuple(v.shape) == want.shape, (part, k)
            if k in ("n_active", "matched_mbes", "updated"):
                np.testing.assert_array_equal(v.numpy(), want, err_msg=f"{part} {k}")
            else:
                np.testing.assert_allclose(v.numpy(), want, rtol=0, atol=1e-4,
                                           err_msg=f"{part} {k}")
    np.testing.assert_allclose(final.pf.particles.numpy(), np.asarray(jfinal.pf.particles),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(final.slam.Sigma.numpy(), np.asarray(jfinal.slam.Sigma),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("n", [32, 4096])
def test_fleet_update_resample_on_the_references_uniforms(n):
    """Distinct particles, the reference's per-mission resample uniforms
    (its keys split as it splits them), zero jitter: the banks, hence the
    ancestors, exact. N=4096 takes the blocked CDF."""
    import jax
    import jax.numpy as jnp

    from smarc_navigation_tpu.configs import PFConfig as JPFConfig
    from smarc_navigation_tpu.models import particle_filter as JPF

    B = 3
    rng = np.random.default_rng(n)
    parts = rng.normal(0, 2.0, (B, 6, n)).astype(np.float32)
    gps = rng.normal(0, 1.0, (B, 2)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    jcfg = JPFConfig(particle_count=n, res_noise_cov=(0.0,) * 6)
    jstate = JPF.PFState(particles=jnp.asarray(parts), key=keys, t_prev=jnp.zeros(B))
    want = np.asarray(JPF.fleet_update_resample(jstate, jnp.asarray(gps),
                                                JPF.make_params(jcfg)).particles)
    k_res = jax.vmap(lambda k: jax.random.split(k, 3))(keys)[:, 1]
    u = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (), jnp.float32))(k_res))

    params = pf.make_params(PFConfig(particle_count=n, res_noise_cov=(0.0,) * 6), device="cpu")
    state = pf.FleetPFState(particles=torch.as_tensor(parts), key=pf.fleet_keys(B, 0, "cpu"),
                            t_prev=torch.zeros(B))
    got = pf.fleet_update_resample(state, torch.as_tensor(gps), params, u=torch.as_tensor(u),
                                   noise=torch.zeros(B, 6, n))
    np.testing.assert_array_equal(got.particles.numpy(), want)
    # the jitter drawn under the missions' keys: reproducible from the same
    # keys, independent across missions, with the configured spread
    sd = (0.5, 0.5, 0.0, 0.0, 0.0, 0.1)
    params = pf.make_params(PFConfig(particle_count=n, res_noise_cov=tuple(s * s for s in sd)),
                            device="cpu")
    same = torch.zeros(B, 6, n)
    a, b = (pf.fleet_update_resample(state._replace(particles=same, key=pf.fleet_keys(B, 3, "cpu")),
                                     torch.as_tensor(gps), params).particles for _ in range(2))
    assert torch.equal(a, b) and not torch.equal(a[0], a[1])
    if n >= 4096:
        np.testing.assert_allclose(a.std(dim=2).mean(0).numpy(), sd, rtol=0, atol=0.03)


@pytest.mark.parametrize("scheme", ["systematic", "residual", "stratified", "multinomial"])
def test_fleet_pf_steps_each_bank_as_alone(scheme):
    """The fleet's batched PF functions against the single-bank ones (held
    to the reference in ``test_torch_pf.py``) mission by mission, bitwise:
    ``fleet_update_resample`` on fed uniforms and jitter, ``fleet_predict``
    on the normals its keys draw, only where the odometry is fresh."""
    B, n = 3, 4096
    rng = np.random.default_rng(11)
    cfg = PFConfig(particle_count=n, res_noise_cov=(0.25, 0.25, 0, 0, 0, 1e-3),
                   motion_cov=(0.04, 0.04, 0, 0, 0, 1e-3))
    params = pf.make_params(cfg, device="cpu")
    state = pf.FleetPFState(particles=torch.as_tensor(rng.normal(0, 2.0, (B, 6, n)), dtype=torch.float32),
                            key=pf.fleet_keys(B, 4, "cpu"), t_prev=torch.tensor([0.0, 0.1, 0.3]))
    gps = torch.as_tensor(rng.normal(0, 1.0, (B, 2)), dtype=torch.float32)
    u = torch.as_tensor(rng.random(B if scheme == "systematic" else (B, n)), dtype=torch.float32)
    noise = torch.as_tensor(rng.normal(0, 1.0, (B, 6, n)), dtype=torch.float32)
    got = pf.fleet_update_resample(state, gps, params, u=u, noise=noise, scheme=scheme)
    for b in range(B):
        one = pf.PFState(particles=state.particles[b], generator=None, t_prev=state.t_prev[b])
        want = pf.update_resample(one, gps[b], params, scheme, u=u[b], noise=noise[b])
        assert torch.equal(got.particles[b], want.particles), b
    assert not torch.equal(got.key, state.key)

    odom = torch.as_tensor(rng.normal(0, 0.3, (B, 13)), dtype=torch.float32)
    ticks, fresh = torch.tensor([0.5, 0.5, 0.2]), torch.tensor([True, False, True])
    pred = pf.fleet_predict(state, odom, ticks, fresh, params)
    n3 = pf.fleet_normals(pf_kernels.split_keys(state.key, 2)[:, 1], n, 3)
    for b in range(B):
        one = pf.PFState(particles=state.particles[b], generator=None, t_prev=state.t_prev[b])
        want = (pf.predict(one, odom[b], torch.clamp(ticks[b] - state.t_prev[b], min=0.0), params,
                           n3=n3[b]).particles if fresh[b] else state.particles[b])
        assert torch.equal(pred.particles[b], want), b
    assert torch.equal(pred.key[1], state.key[1]) and not torch.equal(pred.key[0], state.key[0])
    assert torch.equal(pred.t_prev, torch.tensor([0.5, 0.1, 0.2]))


def test_fleet_draws_are_keyed_per_mission():
    """The fleet's draws come from the counter-based generator under each
    mission's key: reproducible from the seed, distinct across missions and
    seeds, standard normal, with every child key apart from its parent."""
    keys = pf.fleet_keys(64, 9, "cpu")
    assert keys.dtype == torch.int64 and int(keys.min()) >= 0 and int(keys.max()) < 2 ** 32
    assert len(set(keys.tolist())) == 64 and torch.equal(keys, pf.fleet_keys(64, 9, "cpu"))
    assert not torch.equal(keys, pf.fleet_keys(64, 10, "cpu"))
    kids = pf_kernels.split_keys(keys, 3)
    assert len(set(kids.flatten().tolist()) | set(keys.tolist())) == 4 * 64
    z = pf.fleet_normals(keys, 8192, 6)
    assert z.shape == (64, 6, 8192)
    assert abs(float(z.mean())) < 0.01 and abs(float(z.std()) - 1.0) < 0.01
    corr = np.corrcoef(z[:, 0].numpy())               # missions draw apart
    assert np.abs(corr - np.eye(64)).max() < 0.06
    cfg = PFConfig(particle_count=4096)
    params = pf.make_params(cfg, device="cpu")
    a, b = (fleet.init_fleet(4, 4096, FL_CFG, params, cfg, seed=2).pf for _ in range(2))
    assert torch.equal(a.particles, b.particles) and torch.equal(a.key, b.key)
    np.testing.assert_allclose(a.particles.std(dim=2).mean(0).numpy(),
                               np.sqrt(cfg.init_cov), rtol=0.05)


@pytest.mark.parametrize("scheme", ["residual", "systematic"])
def test_fleet_step_is_a_tick_of_run_fleet(scheme):
    """``fleet_step`` tick by tick from ``init_fleet`` against the replay
    ``run_fleet``, with the PF noise on: the same keys draw the same noise,
    so the particles agree to f32 rounding (the SLAM band is re-read from Σ
    each step rather than carried), associations and updates exactly."""
    cfg = PFConfig(particle_count=64)
    sp, pp = S.make_params(FL_CFG, device="cpu"), pf.make_params(cfg, device="cpu")
    tl = _port_fleet_timeline()
    final, out = fleet.run_fleet(tl, FL_CFG, sp, cfg, pp, 64, seed=6, pf_scheme=scheme)
    state = fleet.init_fleet(3, 64, FL_CFG, pp, cfg, seed=6)
    for t in range(tl.ticks.shape[1]):
        state, o = fleet.fleet_step(FL_CFG, sp, cfg, pp, state, tl.map(lambda x: x[:, t]),
                                    pf_scheme=scheme)
        assert torch.equal(o["slam"]["matched_mbes"], out["slam"]["matched_mbes"][t])
        assert torch.equal(o["pf"]["updated"], out["pf"]["updated"][t])
        np.testing.assert_allclose(o["pf"]["mean"].numpy(), out["pf"]["mean"][t].numpy(),
                                   rtol=0, atol=1e-5)
    assert int(out["pf"]["updated"].sum()) > 0
    np.testing.assert_allclose(state.pf.particles.numpy(), final.pf.particles.numpy(),
                               rtol=0, atol=1e-5)
    assert torch.equal(state.pf.key, final.pf.key)
    np.testing.assert_allclose(state.slam.Sigma.numpy(), final.slam.Sigma.numpy(), rtol=0,
                               atol=1e-5)


def test_init_fleet_and_converter():
    """Each mission's bank from its own seed (reproducible, distinct); the
    reference's initial fleet state carried across as numpy."""
    from smarc_navigation_tpu.configs import PFConfig as JPFConfig
    from smarc_navigation_tpu.models import particle_filter as JPF
    from smarc_navigation_tpu.parallel import fleet as jfleet
    from smarc_navigation_tpu_torch.convert import fleet_state_from_numpy

    cfg = PFConfig(particle_count=64)
    params = pf.make_params(cfg, device="cpu")
    a = fleet.init_fleet(4, 64, FL_CFG, params, cfg, seed=5)
    b = fleet.init_fleet(4, 64, FL_CFG, params, cfg, seed=5)
    assert torch.equal(a.pf.particles, b.pf.particles)
    assert not torch.equal(a.pf.particles[0], a.pf.particles[1])
    assert a.slam.Sigma.shape == (4, 6 + 3 * FL_CFG.max_landmarks, 6 + 3 * FL_CFG.max_landmarks)

    jstate = jfleet.init_fleet(4, 64, FL_CFG, JPF.make_params(JPFConfig(particle_count=64)),
                               JPFConfig(particle_count=64), seed=5)
    d = {part: {k: np.asarray(v) for k, v in getattr(jstate, part)._asdict().items()}
         for part in ("slam", "pf")}
    got = fleet_state_from_numpy(d, "cpu")
    for k, v in got.slam._asdict().items():
        np.testing.assert_array_equal(v.numpy(), d["slam"][k].astype(v.numpy().dtype), err_msg=k)
    assert got.slam.n_active.dtype == torch.int32 and got.slam.active.dtype == torch.bool
    np.testing.assert_array_equal(got.pf.particles.numpy(), d["pf"]["particles"])
    assert got.pf.t_prev.shape == (4,) and torch.equal(got.pf.key, pf.fleet_keys(4, 0, "cpu"))
    # one systematic fleet tick from the converted state runs on the port
    tl = _port_fleet_timeline().map(lambda x: x[:, 0])
    tl4 = tl.map(lambda x: torch.cat([x, x[:1]]))
    st, out = fleet.fleet_step(FL_CFG, S.make_params(FL_CFG, device="cpu"), cfg, params, got,
                               tl4, pf_scheme="systematic")
    assert out["pf"]["mean"].shape == (4, 6) and bool(torch.isfinite(st.pf.particles).all())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _same(a, b) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))
    return torch.equal(a, b)


def _flat(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _flat(x[k])]
    return [t for v in x for t in _flat(v)]


@pytest.mark.cuda
def test_raycast_graph_is_the_eager_loop_on_card():
    """The capture, a replay and a cache hit on another rock field, each
    bitwise its eager loop, each counting K1, K2 and K12 once per tick."""
    _need_cuda()
    graphs.clear()
    T = 30
    counters = [k1.da_lanes, k2.sequential_update_fleet, k2.symmetric_downdate]

    def call(graph, seed=0):
        gt, lms, lmm = (torch.as_tensor(x, device="cuda") for x in _raycast_case(B=8, T=T,
                                                                                 seed=seed))
        before = [f.launches for f in counters]
        out = fleet.run_raycast_fleet(gt, lms, lmm, RC_CFG, S.make_params(RC_CFG, device="cuda"),
                                      raycast.MBESSpec(**RC_SPEC), graph=graph)
        torch.cuda.synchronize()
        assert [f.launches - n for f, n in zip(counters, before)] == [T] * 3
        return out

    eager = call(False)
    for i in range(2):
        got = call(True)
        assert all(_same(a, b) for a, b in zip(_flat(got), _flat(eager))), f"call {i}"
    size, caps = graphs.size(), graphs.captures
    eager2 = call(False, seed=5)
    hit = call(True, seed=5)
    assert graphs.size() == size and graphs.captures == caps
    assert all(_same(a, b) for a, b in zip(_flat(hit), _flat(eager2)))
    assert int(eager[1][1][:, -1].sum()) > 0
    graphs.clear()


@pytest.mark.cuda
def test_raycast_dense_path_matches_the_kernel_path_on_card():
    _need_cuda()
    fin_k, (mu_k, na_k) = _port_raycast(None, device="cuda", B=4, T=40)
    fin_d, (mu_d, na_d) = _port_raycast(False, device="cuda", B=4, T=40)
    assert torch.equal(na_k, na_d)
    assert float((mu_k - mu_d).abs().max()) <= 1e-2
    fin_c, (mu_c, na_c) = _port_raycast(True, device="cpu", B=4, T=40)
    assert torch.equal(na_k.cpu(), na_c)
    assert float((mu_k.cpu() - mu_c).abs().max()) <= 1e-2


@pytest.mark.cuda
def test_k1_and_k2_at_the_benchmark_fleet_width_on_card():
    """K1 and K2 (phase 1 + K12) at B=1024, L=32, M=8 on the raycast
    fleet's state after 40 ticks, against their plain versions: discrete
    outputs exact, floats within 1e-4 of each output's scale; K2's Σ
    exactly symmetric, its band Σ's own entries."""
    _need_cuda()
    from smarc_navigation_tpu_torch.io.workloads import raycast_fleet_inputs

    cfg, spec, gt, lms, lmm = raycast_fleet_inputs(1024, 41)
    dev = "cuda"
    gt, lms, lmm = (torch.as_tensor(x, device=dev) for x in (gt, lms, lmm))
    params = S.make_params(cfg, device=dev)
    st, _ = fleet.run_raycast_fleet(gt[:, :40], lms, lmm, cfg, params, spec, graph=False)
    pose = gt[:, 40].contiguous()
    pts, mask = raycast.ping_detections(pose, lms, lmm, spec, cfg.max_obs)
    pred, _ = S._fleet_predict(st, pose, torch.ones(1024, dtype=torch.bool, device=dev), params,
                               predict_sigma=True)
    band = S.initial_band(pred.Sigma, cfg.max_landmarks).contiguous()
    c = S.pass_consts(params, cfg, S.MBES)
    B, L = 1024, cfg.max_landmarks
    args = (pred.mu[:, 0:6].contiguous(), pred.n_active, pred.active,
            pred.mu[:, 6:].reshape(B, L, 3).contiguous(), pred.Sigma, pts.contiguous(),
            mask.contiguous(), c.q_diag, c.lam, c.outlier, c.mh_dist, c.new_cov)
    got = k1.da_lanes(*args, band=band)
    want = k1.da_lanes_reference(*args, band=band)
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype in (torch.int32, torch.bool):
            assert torch.equal(g, w), f"K1 output {i}"
        else:
            m = mask if i in (1, 2, 3) else torch.ones_like(mask)
            scale = max(1.0, float(w[m].abs().max())) if bool(m.any()) else 1.0
            assert float((g[m] - w[m]).abs().max() if bool(m.any()) else 0.0) <= 1e-4 * scale
    assert int(got[5].sum()) > 0                # updates to apply
    ctr, H_sel, SinvH, nu_sel, cand, do, add, slot = got
    k2_args = (pred.Sigma, pred.mu, H_sel, SinvH, nu_sel, (6 + 3 * slot).contiguous(), do, add,
               c.new_cov, cand, None, band)
    strm = k2.sequential_update_fleet(*k2_args)
    plain = k2.sequential_update_fleet_reference(*k2_args)
    for g, w in zip(strm, plain):
        assert float((g - w).abs().max()) <= 1e-4 * max(1.0, float(w.abs().max()))
    assert torch.equal(strm[0], strm[0].transpose(1, 2))
    assert torch.equal(strm[2], S.initial_band(strm[0], L))


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["residual", "systematic"])
def test_slam_pf_fleet_graph_and_cpu_on_card(scheme):
    """The SLAM + PF replay on the card: the capture and a cache hit on
    other timelines each bitwise its eager loop, K1 and K2 once per tick;
    against the CPU with the same seed, the draws are the same bits, so
    associations and updates agree exactly and the PF means to f32
    rounding, up to a resample boundary moved by one ulp of a weight."""
    _need_cuda()
    graphs.clear()
    cfg = PFConfig(particle_count=1024)
    tl = _port_fleet_timeline()
    T = tl.ticks.shape[1]
    counters = [k1.da_lanes, k2.sequential_update_fleet]

    def call(graph, seed=1, d="cuda"):
        before = [f.launches for f in counters]
        out = fleet.run_fleet(tl.to(d), FL_CFG, S.make_params(FL_CFG, device=d), cfg,
                              pf.make_params(cfg, device=d), 1024, seed=seed, pf_scheme=scheme,
                              graph=graph)
        if d == "cuda":
            torch.cuda.synchronize()
            assert [f.launches - n for f, n in zip(counters, before)] == [T] * 2
        return out

    eager = call(False)
    got = call(True)
    assert all(_same(a, b) for a, b in zip(_flat(got), _flat(eager)))
    caps = graphs.captures
    hit, eager2 = call(True, seed=2), call(False, seed=2)
    assert graphs.captures == caps
    assert all(_same(a, b) for a, b in zip(_flat(hit), _flat(eager2)))
    cpu = call(False, d="cpu")
    for part, k in (("slam", "matched_mbes"), ("slam", "n_active"), ("pf", "updated")):
        assert torch.equal(eager[1][part][k].cpu(), cpu[1][part][k]), k
    assert torch.equal(eager[0].pf.key.cpu(), cpu[0].pf.key)
    assert float((eager[1]["pf"]["mean"].cpu() - cpu[1]["pf"]["mean"]).abs().max()) <= 1e-2
    graphs.clear()
