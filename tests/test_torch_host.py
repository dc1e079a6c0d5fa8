"""The port's small building blocks against the JAX package's, on the same
numpy inputs: geometry, linalg, the exact JV ``hungarian`` (also against
scipy), the single-mission predict and DA stage, and the numpy -> port
state conversion.

Tolerances: float32 elementwise math agrees to 1e-6 (rotations,
quaternion round trips, closed-form inverses at 1e-5 relative: the
reference and the port evaluate the same expressions, the libraries' sin,
cos and atan2 differ in the last bits). Assignments are exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from smarc_navigation_tpu_torch import convert
from smarc_navigation_tpu_torch.configs import EKFSlamConfig
from smarc_navigation_tpu_torch.models import ekf_slam as S
from smarc_navigation_tpu_torch.ops.assignment import assignment_cost, hungarian
from smarc_navigation_tpu_torch.utils import geometry as G
from smarc_navigation_tpu_torch.utils import linalg

CFG = dataclasses.replace(EKFSlamConfig(), max_landmarks=8, max_obs=4,
                          mhl_dist_mbes=1.0, q_mbes_diag=(0.1,) * 3)


@pytest.fixture(scope="module")
def J():
    import jax.numpy as jnp

    from smarc_navigation_tpu.models import ekf_slam
    from smarc_navigation_tpu.ops import assignment
    from smarc_navigation_tpu.utils import geometry, linalg as jlinalg

    class NS:
        pass

    ns = NS()
    ns.jnp, ns.slam, ns.assignment, ns.geometry, ns.linalg = (
        jnp, ekf_slam, assignment, geometry, jlinalg)
    return ns


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_geometry_matches_jax(J):
    rng = np.random.default_rng(0)
    rpy = rng.uniform(-3.5, 3.5, (64, 3)).astype(np.float32)
    ang = rng.uniform(-20, 20, 256).astype(np.float32)
    np.testing.assert_allclose(G.wrap_angle(_t(ang)).numpy(),
                               np.asarray(J.geometry.wrap_angle(J.jnp.asarray(ang))),
                               atol=2e-6)
    R = G.rotmat_from_rpy(_t(rpy)).numpy()
    np.testing.assert_allclose(R, np.asarray(J.geometry.rotmat_from_rpy(J.jnp.asarray(rpy))),
                               atol=1e-6)
    q = G.quat_from_rpy_np(rpy.astype(np.float64))
    assert np.array_equal(q, J.geometry.quat_from_rpy_np(rpy.astype(np.float64)))
    q32 = q.astype(np.float32)
    np.testing.assert_allclose(G.rpy_from_quat(_t(q32)).numpy(),
                               np.asarray(J.geometry.rpy_from_quat(J.jnp.asarray(q32))),
                               atol=1e-5)
    a, b = rng.normal(size=(2, 6)).astype(np.float32)
    ta, tb = G.Transform.from_pose(_t(a)), G.Transform.from_pose(_t(b))
    ja = J.geometry.Transform.from_pose(J.jnp.asarray(a))
    jb = J.geometry.Transform.from_pose(J.jnp.asarray(b))
    tc, jc = ta.compose(tb.inverse()), ja.compose(jb.inverse())
    v = rng.normal(size=3).astype(np.float32)
    np.testing.assert_allclose(tc.apply(_t(v)).numpy(), np.asarray(jc.apply(J.jnp.asarray(v))),
                               atol=1e-5)


def test_linalg_matches_jax(J):
    rng = np.random.default_rng(1)
    for n in (2, 3):
        A = rng.normal(size=(32, n, n))
        Spd = (A @ A.transpose(0, 2, 1) + np.eye(n)).astype(np.float32)
        np.testing.assert_allclose(linalg.inv_small(_t(Spd)).numpy(),
                                   np.asarray(J.linalg.inv_small(J.jnp.asarray(Spd))),
                                   rtol=1e-5, atol=1e-6)
    for dof in (2, 3):
        assert linalg.chi2_quantile(0.9, dof) == J.linalg.chi2_quantile(0.9, dof)


def _slam_like_cost(rng, R, C, ties):
    cost = np.full((R, C), 10000.0, np.float32)
    k = int(rng.integers(C, 3 * C))
    vals = (rng.integers(0, 4, k) if ties else rng.uniform(0, 10, k)).astype(np.float32)
    cost[rng.integers(0, R - C, k), rng.integers(0, C, k)] = vals
    cost[R - C + np.arange(C), np.arange(C)] = 1.0   # each column's candidate row
    return cost


@pytest.mark.parametrize("seed,ties", [(0, False), (1, False), (2, True), (3, True)])
def test_hungarian_matches_jax_and_scipy(J, seed, ties):
    """Same col_to_row as the reference's JV (ties included: integer costs
    make equal slacks common, and the lowest row must win in both), and the
    optimal cost scipy finds."""
    from scipy.optimize import linear_sum_assignment

    rng = np.random.default_rng(seed)
    for R, C in ((12, 4), (24, 8), (7, 7)):
        cost = _slam_like_cost(rng, R, C, ties) if R > C else \
            rng.integers(0, 3, (R, C)).astype(np.float32)
        got = hungarian(_t(cost))
        assert got.dtype == torch.int32
        want = np.asarray(J.assignment.hungarian(J.jnp.asarray(cost)))
        np.testing.assert_array_equal(got.numpy(), want)
        rows, cols = linear_sum_assignment(cost.astype(np.float64))
        assert float(assignment_cost(_t(cost), got)) == pytest.approx(
            float(cost[rows, cols].sum()))


def test_predict_and_da_stage_match_jax(J):
    """The single-mission predict (closed-form motion Jacobian) and the DA
    stage (jacfwd Jacobians, candidates, the gated cost table)."""
    rng = np.random.default_rng(4)
    L, D = CFG.max_landmarks, 6 + 3 * CFG.max_landmarks
    na = 5
    mu = np.zeros(D, np.float32)
    mu[0:6] = np.r_[rng.normal(0, 2, 3), rng.uniform(-0.3, 0.3, 3)]
    lms = mu[0:3] + rng.uniform([-8, -8, -12], [8, 8, -8], (na, 3))
    mu[6:6 + 3 * na] = lms.reshape(-1)
    A = rng.normal(0, 0.1, (6 + 3 * na,) * 2)
    Sig = np.zeros((D, D), np.float32)
    Sig[:6 + 3 * na, :6 + 3 * na] = A @ A.T + 0.05 * np.eye(6 + 3 * na)
    active = np.arange(L) < na
    state = dict(mu=mu, Sigma=Sig, active=active, n_active=np.int32(na),
                 mu_auv_odom=mu[0:3] - 0.3)
    st = convert.slam_state_from_numpy(state, "cpu")
    jst = J.slam.SlamState(**{k: J.jnp.asarray(v) for k, v in state.items()})
    params = S.make_params(CFG, device="cpu")
    jparams = J.slam.make_params(CFG)
    assert all(np.allclose(getattr(params, k).numpy(), np.asarray(getattr(jparams, k)))
               for k in S.SlamParams._fields)

    odom = np.r_[mu[0:3] + 0.4, rng.uniform(-0.3, 0.3, 3)].astype(np.float32)
    p = S.predict(st, _t(odom), params)
    jp = J.slam.predict(jst, J.jnp.asarray(odom), jparams)
    for k in ("mu", "Sigma", "mu_auv_odom"):
        np.testing.assert_allclose(getattr(p, k).numpy(), np.asarray(getattr(jp, k)),
                                   rtol=1e-5, atol=1e-6, err_msg=k)

    z = np.stack([np.asarray(J.slam.h_mbes(jp.mu[0:6], J.jnp.asarray(lms[i]), jparams))
                  for i in (0, 2)] + [np.array([20.0, 5.0, -9.0]), np.zeros(3)])
    z = (z + rng.normal(0, 0.02, z.shape)).astype(np.float32)
    mask = np.array([True, True, True, False])
    cost, staged = S.da_stage(p, _t(z), _t(mask), params, CFG, S.MBES)
    jcost, jstaged = J.slam.da_stage(jp, J.jnp.asarray(z), J.jnp.asarray(mask),
                                     jparams, CFG, J.slam.MBES)
    np.testing.assert_allclose(cost.numpy(), np.asarray(jcost), rtol=1e-4, atol=1e-5)
    for g, w in zip(staged, jstaged):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)
    assert (cost.numpy()[:na, :3] < 10000).sum() >= 2   # re-observations gate in


def test_convert_roundtrip(J):
    jparams = J.slam.make_params(CFG)
    params = convert.slam_params_from_numpy(
        {k: np.asarray(v) for k, v in jparams._asdict().items()}, "cpu")
    for k in S.SlamParams._fields:
        assert np.array_equal(getattr(params, k).numpy(), np.asarray(getattr(jparams, k)))
    # a start pose and known-map beacons (pre-activated slots with the
    # beacon prior), and beyond the bank's capacity
    rng = np.random.default_rng(6)
    mu0 = rng.normal(size=6).astype(np.float32)
    for n_beacons in (0, 3, CFG.max_landmarks + 2):
        beacons = rng.normal(0, 20, (n_beacons, 3)).astype(np.float32)
        jstate = J.slam.init_state(CFG, mu0=mu0, beacons=beacons)
        st = convert.slam_state_from_numpy(
            {k: np.asarray(v) for k, v in jstate._asdict().items()}, "cpu")
        ref = S.init_state(CFG, mu0=mu0, beacons=beacons, device="cpu")
        for k in S.SlamState._fields:
            assert torch.equal(getattr(st, k), getattr(ref, k)), (n_beacons, k)


def test_slam_host_helpers_match_jax(J):
    """``slam_timeline`` (bitwise, numpy), ``map_to_odom_correction`` and
    ``landmarks_map`` against the reference's."""
    from smarc_navigation_tpu.io import sim as jsim
    from smarc_navigation_tpu_torch.io import sim

    spec = dict(duration_s=4.0, num_landmarks=6, mbes_std=0.05, landmark_area_m=30.0,
                mbes_range_m=30.0)
    m, jm = sim.simulate(sim.MissionSpec(**spec)), jsim.simulate(jsim.MissionSpec(**spec))
    ticks = np.arange(0, 4.0 + 1e-9, 0.1)
    odom = m.gt_at(ticks).astype(np.float32)
    tl = S.slam_timeline(m, odom, ticks, CFG)
    jtl = J.slam.slam_timeline(jm, odom, ticks, CFG)
    for a, b in ((tl.ticks, jtl.ticks), (tl.channels["odom"].value, jtl.channels["odom"].value),
                 (tl.events["mbes"].value, jtl.events["mbes"].value),
                 (tl.events["mbes"].mask, jtl.events["mbes"].mask)):
        assert np.array_equal(np.asarray(a), np.asarray(b))

    rng = np.random.default_rng(2)
    mu_pose = rng.normal(0, 1, 6).astype(np.float32)
    odom_pose = rng.normal(0, 1, 6).astype(np.float32)
    got = S.map_to_odom_correction(_t(mu_pose), _t(odom_pose))
    want = J.slam.map_to_odom_correction(J.jnp.asarray(mu_pose), J.jnp.asarray(odom_pose))
    np.testing.assert_allclose(got.rot.numpy(), np.asarray(want.rot), atol=1e-6)
    np.testing.assert_allclose(got.trans.numpy(), np.asarray(want.trans), atol=1e-5)

    st = S.init_state(CFG, beacons=rng.normal(0, 5, (3, 3)), device="cpu")
    lm, active = S.landmarks_map(st, CFG)
    jlm, jactive = J.slam.landmarks_map(J.slam.init_state(CFG, beacons=lm[:3].numpy()), CFG)
    assert np.array_equal(lm.numpy(), np.asarray(jlm))
    assert np.array_equal(active.numpy(), np.asarray(jactive))
