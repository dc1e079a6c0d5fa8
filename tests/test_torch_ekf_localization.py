"""The EKF-localization port (``models/ekf_localization``, K9 in
``ops/loc_kernels``, ``ops/bezier`` and the small linear algebra) against
the JAX package's, on the same numpy inputs made from a seed.

On the CPU the port's K9 wrapper takes its plain version; the JAX side runs
its Pallas kernel in TPU-interpret mode, as the JAX package's own tests do.
The ``cuda`` tests hold the CUDA kernel against its plain version on the
card and skip where there is none.

Tolerances: associations (matches) are exact everywhere. K9's plain version
transcribes the TPU kernel in its operation order, so one tick agrees with
the JAX kernel to 1e-5 of each output's scale (the libm ulps of sin, cos,
tan and log differ between the two frameworks). The fleet replays agree to
1e-4 in μ and diag Σ after 301 ticks (those ulps, carried through the
filter). The dense paths agree to 1e-4 in μ: both use AD Jacobians and
einsum contractions whose summation order differs by framework. The Bézier
weights and the cofactor inverse agree to 1e-6 (relative 1e-6 for the
Cholesky solve). The port's fleet against its own dense path is held at
the reference's own bound (2e-3, ``tests/test_loc_kernels.py``).
"""

import dataclasses
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from smarc_navigation_tpu_torch import convert
from smarc_navigation_tpu_torch.configs import EKFLocConfig
from smarc_navigation_tpu_torch.io import sim
from smarc_navigation_tpu_torch.models import ekf_localization as loc
from smarc_navigation_tpu_torch.ops import bezier, loc_kernels
from smarc_navigation_tpu_torch.ops import timeline as ptl
from smarc_navigation_tpu_torch.parallel import fleet
from smarc_navigation_tpu_torch.utils import linalg

# the JAX kernel tests' tuning (stable on generic missions)
CFG = dataclasses.replace(
    EKFLocConfig(), stone_offset=0.0,
    r_diag=(1e-4,) * 3 + (1e-6,) * 3, q_diag=(0.25,) * 3)
# the JAX kernel tests' fleet shape (6 s at 50 Hz, B=2, 12 landmarks in 64
# slots), on a denser landmark field so that most detections associate
SPEC = dict(duration_s=6.0, num_landmarks=12, dvl_std=0.05, mbes_std=0.05,
            landmark_area_m=20.0, mbes_range_m=30.0)


@pytest.fixture(scope="module")
def jx():
    """The JAX reference, imported here so that the ``cuda`` tests of this
    file also run where only PyTorch is installed."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from smarc_navigation_tpu.models import ekf_localization as JL
    from smarc_navigation_tpu.ops import bezier as jbezier
    from smarc_navigation_tpu.ops import loc_kernels as jlk
    from smarc_navigation_tpu.parallel import fleet as jfleet
    from smarc_navigation_tpu.utils import linalg as jlinalg

    return SimpleNamespace(jax=jax, jnp=jnp, pltpu=pltpu, JL=JL, bezier=jbezier,
                           lk=jlk, fleet=jfleet, linalg=jlinalg)


def _close(got, want, atol_scale, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol_scale * scale, err_msg=what)


def port_timeline(jtl):
    """A timeline built by the JAX package, as the port's numpy-leaved
    Timeline (the same arrays)."""
    def group(d, cls):
        return {k: cls(**{f.name: np.asarray(getattr(ch, f.name))
                          for f in dataclasses.fields(cls)}) for k, ch in d.items()}

    return ptl.Timeline(ticks=np.asarray(jtl.ticks), dt=jtl.dt,
                        channels=group(jtl.channels, ptl.Channel),
                        windows=group(jtl.windows, ptl.WindowChannel),
                        events=group(jtl.events, ptl.EventChannel))


def _quiet(fn, *args):
    """fn(*args) with the timeline builder's saturation warnings silenced
    (bursts beyond max_obs are dropped, as in the reference workloads)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args)


def _missions(jx, seeds=(7, 8)):
    """JAX-built timelines of the fleet missions, and the last mission's
    landmarks (the map every mission is replayed against)."""
    tls, m = [], None
    for seed in seeds:
        m = sim.simulate(sim.MissionSpec(**SPEC, seed=seed))
        tls.append(_quiet(jx.JL.loc_timeline, m, CFG))
    return tls, m.landmarks


# ---------------------------------------------------------------------------
# small pieces
# ---------------------------------------------------------------------------

def test_bezier_matches_jax(jx):
    rng = np.random.default_rng(0)
    B, W, D = 64, 5, 3
    stamps = np.sort(rng.uniform(0, 1, (B, W)), axis=1).astype(np.float32)
    stamps[:4] = stamps[:4, :1]                      # degenerate windows
    t = (stamps[:, -1] + rng.uniform(0, 0.2, B)).astype(np.float32)
    vals = rng.normal(0, 1, (B, W, D)).astype(np.float32)
    w = bezier.bernstein_weights(torch.from_numpy(stamps), torch.from_numpy(t))
    jw = jx.bezier.bernstein_weights(jx.jnp.asarray(stamps), jx.jnp.asarray(t))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(w[:4].numpy(), np.tile([0, 0, 0, 0, 1.0], (4, 1)))
    v = bezier.bezier_interpolate(torch.from_numpy(vals), torch.from_numpy(stamps),
                                  torch.from_numpy(t))
    jv = jx.bezier.bezier_interpolate(jx.jnp.asarray(vals), jx.jnp.asarray(stamps),
                                      jx.jnp.asarray(t))
    _close(v.numpy(), np.asarray(jv), 1e-6)
    assert v.dtype == torch.float32


def test_linalg_matches_jax(jx):
    rng = np.random.default_rng(1)
    A = rng.normal(0, 1, (32, 3, 3))
    S3 = (A @ np.swapaxes(A, 1, 2) + 0.5 * np.eye(3)).astype(np.float32)
    inv, det = linalg.inv_det_small3(torch.from_numpy(S3))
    jinv, jdet = jx.linalg.inv_det_small3(jx.jnp.asarray(S3))
    np.testing.assert_allclose(det.numpy(), np.asarray(jdet), rtol=1e-6)
    np.testing.assert_allclose(inv.numpy(), np.asarray(jinv), rtol=1e-6, atol=1e-6)
    A = rng.normal(0, 1, (8, 6, 6))
    S6 = (A @ np.swapaxes(A, 1, 2) + np.eye(6)).astype(np.float32)
    S6[:, 0, 1] += 1e-3                              # spd_solve symmetrizes
    b = rng.normal(0, 1, (8, 6, 4)).astype(np.float32)
    for rhs in (b, b[..., 0]):
        got = linalg.spd_solve(torch.from_numpy(S6), torch.from_numpy(rhs))
        want = jx.linalg.spd_solve(jx.jnp.asarray(S6), jx.jnp.asarray(rhs))
        assert got.shape == want.shape
        _close(got.numpy(), np.asarray(want), 1e-5)
    sym = linalg.symmetrize(torch.from_numpy(S6))
    np.testing.assert_array_equal(sym.numpy(), np.asarray(jx.linalg.symmetrize(jx.jnp.asarray(S6))))


def test_loc_timeline_bitwise(jx):
    from test_torch_no_jax import _assert_bitwise, _flat

    m = sim.simulate(sim.MissionSpec(**SPEC, seed=3))
    tl, jtl = _quiet(loc.loc_timeline, m, CFG), _quiet(jx.JL.loc_timeline, m, CFG)
    _assert_bitwise(_flat(tl), _flat(jtl))


def test_convert_round_trip(jx):
    m = sim.simulate(sim.MissionSpec(**SPEC, seed=8))
    jp = jx.JL.make_params(m.landmarks, CFG)
    p = convert.loc_params_from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()}, "cpu")
    want = loc.make_params(m.landmarks, CFG, device="cpu")
    for k in loc.EKFLocParams._fields:
        assert getattr(p, k).dtype == getattr(want, k).dtype, k
        assert torch.equal(getattr(p, k), getattr(want, k)), k
    js = jx.JL.init_state(CFG, mu0=np.arange(6) * 0.1)
    s = convert.loc_state_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()}, "cpu")
    ws = loc.init_state(CFG, mu0=np.arange(6) * 0.1, device="cpu")
    for k in loc.EKFLocState._fields:
        assert torch.equal(getattr(s, k), getattr(ws, k)), k


def test_jacobians_match_jax(jx):
    rng = np.random.default_rng(2)
    for _ in range(3):
        mu = rng.normal(0, 1, 6).astype(np.float32)
        lm = rng.normal(0, 10, 3).astype(np.float32)
        H = loc.meas_jacobian(torch.from_numpy(mu), torch.from_numpy(lm))
        jH = jx.JL.meas_jacobian(jx.jnp.asarray(mu), jx.jnp.asarray(lm))
        _close(H.numpy(), np.asarray(jH), 1e-6)
        G = loc.motion_jacobian(torch.from_numpy(mu[3:6]), torch.from_numpy(lm * 0.01))
        jG = jx.JL.motion_jacobian(jx.jnp.asarray(mu[3:6]), jx.jnp.asarray(lm * 0.01))
        _close(G.numpy(), np.asarray(jG), 1e-6)
        assert H.dtype == G.dtype == torch.float32


# ---------------------------------------------------------------------------
# K9 on one seeded tick
# ---------------------------------------------------------------------------

def _tick_inputs(seed, B=6, N=16, M=5):
    """A fleet state and one tick: per mission a map of near and far
    landmarks, detections of some near ones (noisy), one far outlier, one
    masked slot; the last mission has no IMU/DVL contact."""
    rng = np.random.default_rng(seed)
    mu = np.zeros((B, 6), np.float32)
    mu[:, 0:3] = rng.normal(0, 3, (B, 3))
    mu[:, 3:5] = rng.uniform(-0.1, 0.1, (B, 2))
    mu[:, 5] = rng.uniform(-np.pi, np.pi, B)
    A = rng.normal(0, 0.2, (B, 6, 6))
    Sig = (A @ np.swapaxes(A, 1, 2) + 0.05 * np.eye(6)).astype(np.float32)
    rpy = (mu[:, 3:6] + rng.normal(0, 0.02, (B, 3))).astype(np.float32)
    disp = rng.normal(0, 0.05, (B, 3)).astype(np.float32)
    have = np.ones(B, bool)
    have[-1] = False
    map_pos = np.zeros((N, 3), np.float32)
    map_pos[: N // 2] = rng.uniform([-6, -6, -12], [6, 6, -8], (N // 2, 3))
    map_pos[N // 2: N - 2] = rng.uniform([40, 40, -12], [60, 60, -8], (N // 2 - 2, 3))
    map_mask = np.ones(N, bool)
    map_mask[-2:] = False                            # padding slots
    z = np.zeros((B, M, 3), np.float32)
    z_valid = np.ones((B, M), bool)
    for b in range(B):
        Rt = _rot(rpy[b]).T
        for j in range(M - 2):
            lm = map_pos[rng.integers(0, N // 2)]
            z[b, j] = Rt @ (lm - mu[b, 0:3]) + rng.normal(0, 0.05, 3)
        z[b, M - 2] = [200.0, -150.0, 30.0]         # outlier
        z_valid[b, M - 1] = False                    # masked slot
        z[b, M - 1] = z[b, 0]
    return dict(mu=mu, Sigma=Sig, rpy_t=rpy, disp_base=disp, have=have, z=z, z_valid=z_valid,
                map_pos=map_pos, map_mask=map_mask, q_diag=np.full(3, 0.25, np.float32),
                r_diag=np.array([1e-2] * 3 + [1e-4] * 3, np.float32),
                lambda_m=np.float32(6.25), epsilon=10.0)


def _rot(rpy):
    r, p, y = rpy
    cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), np.cos(y), np.sin(y)
    return np.array([[cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
                     [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
                     [-sp, cp * sr, cp * cr]])


def _torch_args(x, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(v)).to(device) if isinstance(v, np.ndarray)
            else (torch.tensor(v, device=device) if isinstance(v, np.float32) else v)
            for v in x.values()]


def test_fleet_tick_reference_matches_jax_kernel(jx):
    x = _tick_inputs(0)
    with jx.pltpu.force_tpu_interpret_mode():
        jmu, jsig, jmatch = jx.lk.fleet_tick(*[jx.jnp.asarray(v) for v in x.values()])
    mu, sig, match = loc_kernels.fleet_tick(*_torch_args(x))
    assert match.dtype == torch.int32 and mu.dtype == sig.dtype == torch.float32
    np.testing.assert_array_equal(match.numpy(), np.asarray(jmatch))
    assert 0 < int((match >= 0).sum()) < match.numel()
    _close(mu.numpy(), np.asarray(jmu), 1e-5, "mu")
    _close(sig.numpy(), np.asarray(jsig), 1e-5, "Sigma")
    # the mission without contact keeps its input state bit for bit
    assert torch.equal(mu[-1], torch.from_numpy(x["mu"][-1]))
    assert torch.equal(sig[-1], torch.from_numpy(x["Sigma"][-1]))


def test_fleet_tick_invalid_detections_and_no_contact(jx):
    """The invariants the CUDA kernel's skips rely on, in the plain version
    and the JAX kernel (interpret mode): a round whose detection is invalid
    matches nothing and leaves μ and Σ as a round that associates nothing
    does, so removing it changes no state; a mission without contact gets
    its input state back bit for bit (its matches are still reported)."""
    x = _tick_inputs(4)                              # B=6, N=16, M=5
    x["z_valid"][0] = False                          # every detection invalid
    x["z_valid"][1, 1] = False                       # one invalid round among valid ones
    x["have"][2] = False                             # no contact, no valid detection
    x["z_valid"][2] = False
    with jx.pltpu.force_tpu_interpret_mode():
        jmu, jsig, jmatch = jx.lk.fleet_tick(*[jx.jnp.asarray(v) for v in x.values()])
    mu, sig, match = loc_kernels.fleet_tick(*_torch_args(x))
    np.testing.assert_array_equal(match.numpy(), np.asarray(jmatch))
    _close(mu.numpy(), np.asarray(jmu), 1e-5, "mu")
    _close(sig.numpy(), np.asarray(jsig), 1e-5, "Sigma")
    assert (match[torch.from_numpy(~x["z_valid"])] == -1).all()
    assert int((match[1] >= 0).sum()) > 0
    for b in (2, 5):                                 # without contact
        assert torch.equal(mu[b], torch.from_numpy(x["mu"][b]))
        assert torch.equal(sig[b], torch.from_numpy(x["Sigma"][b]))
    # mission 0: invalid detections leave the state as detections that
    # associate nothing (far outliers) do
    far = {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in x.items()}
    far["z_valid"][0] = True
    far["z"][0] = [300.0, 300.0, 300.0]
    mu_f, sig_f, match_f = loc_kernels.fleet_tick(*_torch_args(far))
    assert (match_f[0] == -1).all()
    assert torch.equal(mu[0], mu_f[0]) and torch.equal(sig[0], sig_f[0])
    # mission 1: the same tick without its invalid round
    keep = [m for m in range(x["z"].shape[1]) if x["z_valid"][1, m]]
    one = {k: (v[1:2] if k in ("mu", "Sigma", "rpy_t", "disp_base", "have") else v)
           for k, v in x.items()}
    one["z"], one["z_valid"] = x["z"][1:2, keep], x["z_valid"][1:2, keep]
    mu_1, sig_1, match_1 = loc_kernels.fleet_tick(*_torch_args(one))
    assert torch.equal(mu[1], mu_1[0]) and torch.equal(sig[1], sig_1[0])
    assert torch.equal(match[1, keep], match_1[0])


def test_fleet_tick_checks_its_inputs():
    args = _torch_args(_tick_inputs(1))
    args[0] = args[0].double()
    with pytest.raises(TypeError, match="mu"):
        loc_kernels.fleet_tick(*args)
    args = _torch_args(_tick_inputs(1))              # more detections than the kernel stages
    B, M = args[5].shape[0], loc_kernels.MAX_M + 1
    args[5], args[6] = torch.zeros((B, M, 3)), torch.ones((B, M), dtype=torch.bool)
    with pytest.raises(ValueError, match="M <="):
        loc_kernels.fleet_tick(*args)


# ---------------------------------------------------------------------------
# the fleet replay and the dense path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fleet_runs(jx):
    """The same JAX-built fleet timeline through JAX ``run_fleet`` (Pallas,
    interpret mode) and the port's ``run_fleet`` (plain K9) on the CPU."""
    jtls, landmarks = _missions(jx)
    jbatched = jx.fleet.batch_timelines(jtls)
    jparams = jx.JL.make_params(landmarks, CFG)
    with jx.pltpu.force_tpu_interpret_mode():
        jfinal, jout = jx.JL.run_fleet(jbatched, jparams, CFG)
    params = loc.make_params(landmarks, CFG, device="cpu")
    tls = [port_timeline(t) for t in jtls]
    final, out = loc.run_fleet(fleet.batch_timelines(tls).to("cpu"), params, CFG)
    return SimpleNamespace(jtls=jtls, tls=tls, params=params, jparams=jparams, landmarks=landmarks,
                           jfinal=jfinal, jout=jout, final=final, out=out)


def test_run_fleet_matches_jax(fleet_runs):
    r = fleet_runs
    assert r.out["matches"].dtype == torch.int32
    np.testing.assert_array_equal(r.out["matches"].numpy(), np.asarray(r.jout["matches"]))
    np.testing.assert_array_equal(r.out["num_matched"].numpy(), np.asarray(r.jout["num_matched"]))
    n = int((r.out["matches"] >= 0).sum())
    assert n > 100 and n < int((r.out["matches"] >= -1).sum())
    np.testing.assert_allclose(r.out["mu"].numpy(), np.asarray(r.jout["mu"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(r.out["sigma_diag"].numpy(), np.asarray(r.jout["sigma_diag"]),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(r.final.mu.numpy(), np.asarray(r.jfinal.mu), rtol=0, atol=1e-4)
    np.testing.assert_allclose(r.final.Sigma.numpy(), np.asarray(r.jfinal.Sigma), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(r.final.t_prev.numpy(), np.asarray(r.jfinal.t_prev))


def test_dense_run_matches_jax(fleet_runs, jx):
    """The port's dense ``run`` against the JAX dense ``run`` (mission 1,
    whose landmarks are the map), and the port's fleet against its dense
    path at the reference's own bound."""
    r = fleet_runs
    jfinal, jout = jx.JL.run(r.jtls[1], r.jparams, CFG)
    final, out = loc.run(r.tls[1].to("cpu"), r.params, CFG)
    np.testing.assert_array_equal(out["matches"].numpy(), np.asarray(jout["matches"]))
    assert int((out["matches"] >= 0).sum()) > 100
    np.testing.assert_allclose(out["mu"].numpy(), np.asarray(jout["mu"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(out["sigma_diag"].numpy(), np.asarray(jout["sigma_diag"]),
                               rtol=0, atol=1e-4)
    assert out["num_matched"].dtype == torch.int32
    np.testing.assert_array_equal(out["num_matched"].numpy(), np.asarray(jout["num_matched"]))
    # fleet (K9's forms) vs dense, as tests/test_loc_kernels.py holds them
    np.testing.assert_array_equal(r.out["matches"][:, 1].numpy(), out["matches"].numpy())
    np.testing.assert_allclose(r.out["mu"][:, 1].numpy(), out["mu"].numpy(), atol=2e-3)
    np.testing.assert_allclose(r.out["sigma_diag"][:, 1].numpy(), out["sigma_diag"].numpy(),
                               atol=2e-3)


def test_run_fleet_no_input_rebroadcast(fleet_runs):
    """Ticks without IMU+DVL contact leave the state untouched (as
    ``tests/test_loc_kernels.py`` holds the reference's fleet)."""
    tl = fleet_runs.tls[0]
    cut = tl.ticks > 2.0
    imu = tl.channels["imu"]
    tl2 = dataclasses.replace(tl, channels={
        **tl.channels, "imu": dataclasses.replace(imu, valid=imu.valid & ~cut)})
    _, out = loc.run_fleet(fleet.batch_timelines([tl2]).to("cpu"), fleet_runs.params, CFG)
    mu, sd = out["mu"][:, 0], out["sigma_diag"][:, 0]
    k = int(np.argmax(cut))
    assert torch.equal(mu[k - 1], mu[-1]) and torch.equal(sd[k - 1], sd[-1])
    assert not torch.equal(mu[k - 2], mu[k - 1])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,M", [(6, 16, 5), (130, 64, 8)])
def test_fleet_tick_kernel_matches_plain_on_card(B, N, M):
    _need_cuda()
    x = _tick_inputs(3, B=B, N=N, M=M)
    got = loc_kernels.fleet_tick(*_torch_args(x, "cuda"))
    torch.cuda.synchronize()
    want = loc_kernels.fleet_tick_reference(*_torch_args(x, "cuda"))
    assert torch.equal(got[2], want[2])
    for g, w in zip(got[:2], want[:2]):
        _close(g.cpu().numpy(), w.cpu().numpy(), 1e-5)
    assert torch.equal(got[0][-1].cpu(), torch.from_numpy(x["mu"][-1]))
    assert torch.equal(got[1][-1].cpu(), torch.from_numpy(x["Sigma"][-1]))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 130])
def test_fleet_tick_kernel_skips_on_card(B):
    """One block per mission at widths that are not a multiple of anything,
    with valid and invalid detections mixed, and missions with and without
    contact (with and without a valid detection)."""
    _need_cuda()
    x = _tick_inputs(5, B=B, N=64, M=8)
    rng = np.random.default_rng(B)
    x["z_valid"] = rng.random((B, 8)) < 0.6
    x["have"] = rng.random(B) < 0.7
    x["have"][0], x["z_valid"][0, :2] = True, True
    if B > 3:
        x["z_valid"][1] = False                      # contact, nothing valid
        x["have"][2], x["z_valid"][2] = False, False  # the whole tick skipped
        x["have"][3], x["z_valid"][3, 0] = False, True  # no contact, matches reported
    got = loc_kernels.fleet_tick(*_torch_args(x, "cuda"))
    torch.cuda.synchronize()
    want = loc_kernels.fleet_tick_reference(*_torch_args(x, "cuda"))
    assert torch.equal(got[2], want[2])
    assert int((got[2] >= 0).sum()) > 0
    assert (got[2].cpu()[torch.from_numpy(~x["z_valid"])] == -1).all()
    for g, w in zip(got[:2], want[:2]):
        _close(g.cpu().numpy(), w.cpu().numpy(), 1e-5)
    off = torch.from_numpy(~x["have"])
    assert torch.equal(got[0].cpu()[off], torch.from_numpy(x["mu"])[off])
    assert torch.equal(got[1].cpu()[off], torch.from_numpy(x["Sigma"])[off])


@pytest.mark.cuda
def test_run_fleet_on_card_matches_cpu():
    _need_cuda()
    tls = []
    for seed in (7, 8):
        m = sim.simulate(sim.MissionSpec(**SPEC, seed=seed))
        tls.append(_quiet(loc.loc_timeline, m, CFG))
    bt = fleet.batch_timelines(tls)
    n0 = loc_kernels.fleet_tick.launches
    fk, ok = loc.run_fleet(bt.to("cuda"), loc.make_params(m.landmarks, CFG, device="cuda"), CFG)
    torch.cuda.synchronize()
    assert loc_kernels.fleet_tick.launches - n0 == bt.ticks.shape[1]
    fp, op = loc.run_fleet(bt.to("cpu"), loc.make_params(m.landmarks, CFG, device="cpu"), CFG)
    assert torch.equal(ok["matches"].cpu(), op["matches"])
    np.testing.assert_allclose(ok["mu"].cpu().numpy(), op["mu"].numpy(), rtol=0, atol=1e-4)
