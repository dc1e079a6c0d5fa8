"""The marginal-writeback SLAM path of the port (the reference's own
covariance semantics, ``ekf_slam_core.cpp:351-371``) against the JAX
package's, on the same numpy inputs.

K4 (``sequential_update_marginal_fleet``) and K1's pose-rows form are held
against the JAX kernels on direct random inputs; the fleet
``run_fleet(update_mode="marginal")`` against the JAX fleet and against the
port's per-mission dense ``run(update_mode="marginal")``; an FLS (pixel)
marginal fleet against the per-mission dense path. On the CPU the port's
wrappers take their plain versions; the JAX side runs its Pallas kernels in
TPU-interpret mode. The ``cuda`` tests hold each CUDA kernel against its
plain version on the card and skip where there is none.

Tolerances: discrete outputs (associations, do/add/slot, n_active) are
exact. K4's floats agree to 1e-5 of each output's scale: the 9×9 products
are summed in another order than XLA's (observed ~1e-7 relative). Fleet pose
tracks agree to 1e-2 and the reconstructed Σ's pose rows and landmark blocks
to 2e-2 (the bounds of the reference's own fleet-vs-dense marginal test,
``tests/test_slam_marginal.py``): the marginal semantics leave stale
cross-covariances, so rounding differences are not damped as in the full
update.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from smarc_navigation_tpu_torch import convert
from smarc_navigation_tpu_torch.configs import EKFSlamConfig
from smarc_navigation_tpu_torch.io import sim
from smarc_navigation_tpu_torch.models import ekf_slam as S
from smarc_navigation_tpu_torch.ops import slam_da_kernels as tda
from smarc_navigation_tpu_torch.ops import slam_kernels as tsk
from smarc_navigation_tpu_torch.ops import timeline as ptl
from smarc_navigation_tpu_torch.parallel import fleet
from smarc_navigation_tpu_torch.utils.geometry import quat_from_rpy_np

from test_torch_slam_kernels import (_assert_da_equal, _band_consumed, _close,
                                     _da_args, _fleet_inputs, _to_jax, _to_torch)

L, M = 16, 4
D = 6 + 3 * L
CFG = dataclasses.replace(
    EKFSlamConfig(), max_landmarks=L, max_obs=M, mhl_dist_mbes=1.0,
    q_mbes_diag=(0.1,) * 3, r_diag=(1e-3,) * 6)
DURATION = 6.0
POSE_ATOL = 1e-2
SIGMA_ATOL = 2e-2


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from smarc_navigation_tpu.models import ekf_slam as JS
    from smarc_navigation_tpu.ops import slam_da_kernels, slam_kernels
    from smarc_navigation_tpu.ops.timeline import build_timeline
    from smarc_navigation_tpu.parallel import fleet as jfleet

    return SimpleNamespace(jax=jax, jnp=jnp, pltpu=pltpu, JS=JS, da=slam_da_kernels,
                           sk=slam_kernels, build_timeline=build_timeline, fleet=jfleet)


# ---------------------------------------------------------------------------
# K4 on direct inputs
# ---------------------------------------------------------------------------

def _marginal_inputs(seed, B, dim, M=M, add_last=False):
    """A marginal-semantics fleet state (pose rows + band of a random SPD Σ
    whose added slots are still empty) and a random update sequence. With
    ``add_last`` every mission's last update adds a landmark in slot L-1."""
    rng = np.random.default_rng(seed)
    A = rng.normal(0, 0.2, (B, D, D))
    Sigma = (np.einsum("bij,bkj->bik", A, A) + np.eye(D)[None]).astype(np.float32)
    mu = rng.normal(0, 1, (B, D)).astype(np.float32)
    H = rng.normal(0, 0.3, (B, M, dim, 9)).astype(np.float32)
    Sinv = rng.uniform(0.1, 0.4, (B, M))[:, :, None, None] * np.eye(dim)
    SinvH = np.einsum("bmij,bmjk->bmik", Sinv, H).astype(np.float32)
    nu = rng.normal(0, 0.3, (B, M, dim)).astype(np.float32)
    slots = np.stack([rng.permutation(L)[:M] for _ in range(B)])
    lm_ix = (6 + 3 * slots).astype(np.int32)
    do = rng.random((B, M)) < 0.8
    add = (rng.random((B, M)) < 0.4) & do
    do[0, 0], add[0, 1], do[0, 1] = False, True, True
    if add_last:
        for b in range(B):
            k = int(np.nonzero(slots[b] == L - 1)[0][0]) if (slots[b] == L - 1).any() else M - 1
            slots[b, k], slots[b, M - 1] = slots[b, M - 1], L - 1
        lm_ix = (6 + 3 * slots).astype(np.int32)
        do[:, M - 1] = add[:, M - 1] = True
    for b in range(B):                          # an added slot starts empty
        for j in np.nonzero(add[b])[0]:
            s = lm_ix[b, j]
            Sigma[b, s:s + 3, :] = 0.0
            Sigma[b, :, s:s + 3] = 0.0
            mu[b, s:s + 3] = 0.0
    mu[:, 3:6] = rng.uniform(-3.0, 3.0, (B, 3))  # attitudes near the ±π seam too
    rows = np.zeros((B, 8, D), np.float32)
    rows[:, 0:6] = Sigma[:, 0:6]
    band = S.initial_band(torch.from_numpy(Sigma), L).numpy()
    cand = rng.normal(0, 5.0, (B, M, 3)).astype(np.float32)
    g = rng.normal(0, 0.05, (B, 3, 3)).astype(np.float32)
    a8 = np.zeros((B, 8, 16), np.float32)
    a8[:, :8, :8] = np.eye(8)
    a8[:, 0:3, 3:6] = g
    a8[:, 0:6, 8:14] = np.eye(6) * 1e-3
    a8[-1] = 0.0
    a8[-1, :8, :8] = np.eye(8)                   # invalid odometry: exact no-op
    new_cov = np.array([2.0, 1.5, 1.0], np.float32)
    return [rows, mu, H, SinvH, nu, lm_ix, do, add, new_cov, cand, band], a8


def _assert_marginal_close(got, want):
    P, mu, band = (np.asarray(x, np.float64) for x in got)
    Pw, muw, bandw = (np.asarray(x, np.float64) for x in want)
    _close(P[:, 0:6], Pw[:, 0:6], rtol=0, what="P")
    # attitudes compared modulo 2π (an ulp may move one across the seam)
    dmu = mu - muw
    dmu[:, 3:6] = np.remainder(dmu[:, 3:6] + np.pi, 2 * np.pi) - np.pi
    assert np.abs(dmu).max() <= 1e-5 * max(1.0, np.abs(muw).max()), np.abs(dmu).max()
    _close(_band_consumed(band), _band_consumed(bandw), rtol=0, what="band")


@pytest.mark.parametrize("dim,with_a8", [(3, True), (3, False), (2, True), (2, False)])
def test_marginal_update_plain_matches_jax(jx, dim, with_a8):
    args, a8 = _marginal_inputs(40 + dim, 2, dim)
    extra = [a8] if with_a8 else []
    got = tsk.sequential_update_marginal_fleet(*[_to_torch(a) for a in args + extra])
    with jx.pltpu.force_tpu_interpret_mode():
        want = jx.sk.sequential_update_marginal_fleet(*[_to_jax(jx, a) for a in args + extra])
    _assert_marginal_close([g.numpy() for g in got], [np.asarray(w) for w in want])
    # the updates landed: pose rows moved, added landmarks got their candidates
    assert not np.allclose(got[0].numpy()[:, 0:6], args[0][:, 0:6])
    s = args[5][0, 1]                            # mission 0's update 1 is an add
    assert not np.allclose(got[1].numpy()[0, s:s + 3], 0.0)


def test_marginal_update_identity_predict_is_a_noop():
    """An identity a8 with zero R̃ leaves the pose rows bit for bit (the
    invalid-odometry gate), and no update leaves the state as it was."""
    args, a8 = _marginal_inputs(5, 2, 3)
    t = [_to_torch(a) for a in args]
    t[6] = torch.zeros_like(t[6])               # do: nothing
    t[7] = torch.zeros_like(t[7])
    a8i = torch.zeros(2, 8, 16)
    a8i[:, :8, :8] = torch.eye(8)
    P, mu, band = tsk.sequential_update_marginal_fleet(*t, a8i)
    assert torch.equal(P, t[0]) and torch.equal(mu, t[1]) and torch.equal(band, t[10])


def _pose_rows_case(params):
    x = _fleet_inputs(11, 3, "mbes", params)
    args, kw = _da_args(x, "mbes", params, True, True)
    rows = np.zeros((3, 8, D), np.float32)
    rows[:, 0:6] = x["Sigma"][:, 0:6]
    args[4] = None
    kw["pose_rows"] = rows
    return x, args, kw


def test_da_lanes_pose_rows_plain_matches_jax(jx):
    params = S.make_params(CFG, device="cpu")
    x, args, kw = _pose_rows_case(params)
    got = tda.da_lanes(*[_to_torch(a) for a in args],
                       **{k: _to_torch(v) for k, v in kw.items()})
    with jx.pltpu.force_tpu_interpret_mode():
        want = jx.da.da_lanes(*[_to_jax(jx, a) for a in args],
                              **{k: _to_jax(jx, v) for k, v in kw.items()})
    _assert_da_equal([g.numpy() for g in got], [np.asarray(w) for w in want], x["z_mask"])
    # the same stage read from the full Σ gives the same decisions
    full_args, full_kw = _da_args(x, "mbes", params, True, True)
    ref = tda.da_lanes(*[_to_torch(a) for a in full_args],
                       **{k: _to_torch(v) for k, v in full_kw.items()})
    _assert_da_equal([g.numpy() for g in got], [r.numpy() for r in ref], x["z_mask"])
    with pytest.raises(ValueError, match="band"):
        tda.da_lanes(*[_to_torch(a) for a in args],
                     **{k: _to_torch(v) for k, v in dict(kw, band=None).items()})


# ---------------------------------------------------------------------------
# the fleet: port vs JAX vs the per-mission dense marginal path
# ---------------------------------------------------------------------------

def _raw_mission(seed):
    """Channel and event inputs of one MBES mission (numpy), fed to both
    packages' timeline builders."""
    m = sim.simulate(sim.MissionSpec(
        duration_s=DURATION, num_landmarks=12, mbes_std=0.05, landmark_area_m=50.0,
        mbes_range_m=30.0, gps_surface_z=-100.0, seed=seed))
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
def case(jx):
    raws = [_raw_mission(s) for s in (1, 2)]
    tl = fleet.batch_timelines([ptl.build_timeline(**r) for r in raws]).to("cpu")
    params = S.make_params(CFG, device="cpu")
    jparams = jx.JS.make_params(CFG)
    with jx.pltpu.force_tpu_interpret_mode():
        jfinal, jout = jx.JS.run_fleet(
            jx.fleet.batch_timelines([jx.build_timeline(**r) for r in raws]), jparams, CFG,
            update_mode="marginal")
        jx.jax.block_until_ready(jout)
    final, out = S.run_fleet(tl, params, CFG, update_mode="marginal")
    return dict(tl=tl, params=params, final=final, out=out,
                jfinal=jfinal, jout={k: np.asarray(v) for k, v in jout.items()})


def _assert_sigma_blocks_close(Sf, Sd):
    np.testing.assert_allclose(Sf[0:6, :], Sd[0:6, :], atol=SIGMA_ATOL)
    for l in range(L):
        s = slice(6 + 3 * l, 9 + 3 * l)
        np.testing.assert_allclose(Sf[s, s], Sd[s, s], atol=SIGMA_ATOL)


def test_run_fleet_marginal_matches_jax(case):
    out, jout = case["out"], case["jout"]
    assert set(out) == set(jout)
    for key in ("matched_mbes", "n_active"):
        np.testing.assert_array_equal(out[key].numpy(), jout[key], err_msg=key)
    np.testing.assert_allclose(out["mu"].numpy(), jout["mu"], atol=POSE_ATOL)
    for b in range(2):
        _assert_sigma_blocks_close(case["final"].Sigma[b].numpy(),
                                   np.asarray(case["jfinal"].Sigma[b]))
    assert (out["matched_mbes"].numpy() >= 0).sum() > 10
    assert int(case["final"].n_active.min()) >= 2


def test_run_fleet_marginal_matches_per_mission_run(case):
    """The fleet replay of each mission is the dense per-mission marginal
    ``run`` (reached through ``run_fleet(update_mode="marginal_dense")``)."""
    final_d, out_d = S.run_fleet(case["tl"], case["params"], CFG, update_mode="marginal_dense")
    for key in ("matched_mbes", "n_active"):
        np.testing.assert_array_equal(case["out"][key].numpy(), out_d[key].numpy(), err_msg=key)
    np.testing.assert_allclose(case["out"]["mu"].numpy(), out_d["mu"].numpy(), atol=POSE_ATOL)
    for b in range(2):
        _assert_sigma_blocks_close(case["final"].Sigma[b].numpy(), final_d.Sigma[b].numpy())


def test_marginal_cross_landmark_blocks_stay_zero(case):
    """The invariant the fleet carry is built on: on the dense marginal path
    every cross-landmark block of Σ is exactly zero."""
    final, _ = S.run(case["tl"].map(lambda x: x[0]), case["params"], CFG,
                     update_mode="marginal")
    Sig = final.Sigma.numpy()
    assert int(final.n_active) >= 2
    for i in range(L):
        for j in range(L):
            if i != j:
                blk = Sig[6 + 3 * i:9 + 3 * i, 6 + 3 * j:9 + 3 * j]
                assert np.all(blk == 0.0), (i, j, blk)


def test_marginal_state_roundtrip(case):
    """``sigma_from_rows_band`` and ``marginal_state_from_numpy``: the
    carry rebuilt from numpy reconstructs the same covariance."""
    Sig = case["final"].Sigma
    rows = torch.zeros(2, 8, D)
    rows[:, 0:6] = Sig[:, 0:6]
    band = S.initial_band(Sig, L)
    f = case["final"]
    ms = convert.marginal_state_from_numpy(
        dict(mu=f.mu.numpy(), rows=rows.numpy(), band=band.numpy(), active=f.active.numpy(),
             n_active=f.n_active.numpy().astype(np.int64), mu_auv_odom=f.mu_auv_odom.numpy()),
        "cpu")
    assert ms.n_active.dtype == torch.int32 and ms.active.dtype == torch.bool
    assert torch.equal(S.sigma_from_rows_band(ms.rows, ms.band, L), Sig)


# ---------------------------------------------------------------------------
# FLS marginal fleet vs the per-mission dense marginal path
# ---------------------------------------------------------------------------

FLS_CFG = dataclasses.replace(
    EKFSlamConfig(), max_landmarks=8, max_obs=4, mhl_dist_fls=3.0,
    q_fls_diag=(4.0, 4.0), r_diag=(1e-3,) * 6)


def _fls_timeline(seed, T=40):
    """A straight FLS survey past a landmark field (the reference
    benchmark's FLS workload, smaller): pixel detections through an
    identity extrinsic, computed in numpy."""
    scale = 400.0 / 17.0
    freq = FLS_CFG.system_freq
    rng = np.random.default_rng(500 + seed)
    lms = np.column_stack([rng.uniform(5.0, 5.0 + 0.15 * T, 10),
                           rng.uniform(-6.0, 6.0, 10), rng.uniform(-2.5, -1.0, 10)])
    ticks = (np.arange(T) + 1) / freq
    poses = np.zeros((T, 6))
    poses[:, 0] = 0.15 * np.arange(T)
    poses[:, 2] = -1.5
    poses[:, 5] = 0.15 * np.sin(0.05 * np.arange(T))
    cy, sy = np.cos(poses[:, 5]), np.sin(poses[:, 5])
    d = lms[None, :, :] - poses[:, None, 0:3]
    v0 = cy[:, None] * d[:, :, 0] + sy[:, None] * d[:, :, 1]
    v1 = -sy[:, None] * d[:, :, 0] + cy[:, None] * d[:, :, 1]
    v2 = d[:, :, 2]
    vis = (v0 > 0.5) & (np.hypot(v0, v2) < 12.0)
    px0 = scale * np.hypot(v0, v2) + rng.normal(0, 0.5, v0.shape)
    px1 = -scale * v1 + rng.normal(0, 0.5, v0.shape)
    kk, nn = np.nonzero(vis)
    return ptl.build_timeline(
        0.0, T / freq, freq, channels={"odom": (ticks, poses.astype(np.float32))},
        events={"fls": (ticks[kk], np.column_stack([px0[kk, nn], px1[kk, nn],
                                                    np.zeros(len(kk))]).astype(np.float32),
                        kk, FLS_CFG.max_obs)})


def test_run_fleet_marginal_fls_matches_per_mission_run():
    tl = fleet.batch_timelines([_fls_timeline(s) for s in (1, 2)]).to("cpu")
    params = S.make_params(FLS_CFG, device="cpu")
    final_f, out_f = S.run_fleet(tl, params, FLS_CFG, update_mode="marginal")
    final_d, out_d = S.run_fleet(tl, params, FLS_CFG, update_mode="marginal_dense")
    for key in ("matched_fls", "n_active"):
        np.testing.assert_array_equal(out_f[key].numpy(), out_d[key].numpy(), err_msg=key)
    np.testing.assert_allclose(out_f["mu"].numpy(), out_d["mu"].numpy(), atol=POSE_ATOL)
    assert (out_f["matched_fls"].numpy() >= 0).sum() > 10
    assert int(final_f.n_active.min()) >= 3
    for b in range(2):
        Sf, Sd = final_f.Sigma[b].numpy(), final_d.Sigma[b].numpy()
        np.testing.assert_allclose(Sf[0:6, :], Sd[0:6, :], atol=SIGMA_ATOL)
        for l in range(FLS_CFG.max_landmarks):
            s = slice(6 + 3 * l, 9 + 3 * l)
            np.testing.assert_allclose(Sf[s, s], Sd[s, s], atol=SIGMA_ATOL)


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _assert_untouched_exact(got, args):
    """What no applied update touches comes back bit for bit: P's padding
    rows 6:8, the band slots and the μ entries of untouched landmarks (K4
    spreads these copies over blocks apart from the update chain)."""
    P, mu, band = (np.asarray(x) for x in got)
    rows, mu0, lm_ix, do, band0 = args[0], args[1], args[5], args[6], args[10]
    np.testing.assert_array_equal(P[:, 6:8], rows[:, 6:8])
    for b in range(rows.shape[0]):
        touched = {int(l) for l, d in zip(lm_ix[b], do[b]) if d}
        keep = [s for s in range(band0.shape[2]) if 6 + 3 * s not in touched]
        np.testing.assert_array_equal(band[b][:, keep], band0[b][:, keep])
        cols = [6 + 3 * s + a for s in keep for a in range(3)]
        np.testing.assert_array_equal(mu[b, cols], mu0[b, cols])


# Besides the four forms: every update applied, none applied, an add in the
# last slot, M=16 (EKFSlamConfig()'s max_obs) and B=1.
MARGINAL_KERNEL_CASES = [pytest.param(d, a, None, id=f"{d}-{a}")
                         for d, a in [(3, True), (3, False), (2, True), (2, False)]] + [
    pytest.param(3, True, v, id=f"3-True-{v}") for v in ("all", "none", "add_last", "M16", "B1")] + [
    pytest.param(2, False, "add_last", id="2-False-add_last")]


@pytest.mark.cuda
@pytest.mark.parametrize("dim,with_a8,variant", MARGINAL_KERNEL_CASES)
def test_marginal_update_kernel_matches_plain(cuda, dim, with_a8, variant):
    args, a8 = _marginal_inputs(60 + dim, 1 if variant == "B1" else 5, dim,
                                M=16 if variant == "M16" else M, add_last=variant == "add_last")
    args[0][:, 6:8] = np.linspace(-1.0, 1.0, args[0][:, 6:8].size).reshape(-1, 2, D)  # padding to copy
    if variant == "all":
        args[6][:] = True
    elif variant == "none":
        args[6][:] = False
        args[7][:] = False
    t = [_to_torch(a, cuda) for a in args + ([a8] if with_a8 else [])]
    n0 = tsk.sequential_update_marginal_fleet.launches
    got = tsk.sequential_update_marginal_fleet(*t)
    torch.cuda.synchronize()
    assert tsk.sequential_update_marginal_fleet.launches == n0 + 1
    want = tsk.sequential_update_marginal_fleet_reference(*t)
    got = [g.cpu().numpy() for g in got]
    _assert_marginal_close(got, [w.cpu().numpy() for w in want])
    _assert_untouched_exact(got, args)
    if variant == "none" and not with_a8:
        for g, a in zip(got, (args[0], args[1], args[10])):
            np.testing.assert_array_equal(g, a)


@pytest.mark.cuda
def test_da_lanes_pose_rows_kernel_matches_plain(cuda):
    x, args, kw = _pose_rows_case(S.make_params(CFG, device="cpu"))
    targs = [_to_torch(a, cuda) for a in args]
    tkw = {k: _to_torch(v, cuda) for k, v in kw.items()}
    got = tda.da_lanes(*targs, **tkw)
    torch.cuda.synchronize()
    want = tda.da_lanes_reference(*targs, **tkw)
    _assert_da_equal([g.cpu().numpy() for g in got], [w.cpu().numpy() for w in want],
                     x["z_mask"])
