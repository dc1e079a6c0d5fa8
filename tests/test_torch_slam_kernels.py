"""The port's three SLAM kernels (K1 ``da_lanes``, K2
``sequential_update_fleet``, K3 ``sequential_update``) against the JAX
package's, on the same numpy inputs made from a seed.

On the CPU the port's wrappers take their plain PyTorch versions; the JAX
side runs its Pallas kernels in TPU-interpret mode, as the JAX package's own
tests do. The ``cuda`` tests hold each CUDA kernel against its plain version
on the card and skip where there is none.

Tolerances: discrete outputs (col_to_row, do, add, slot) are exact. Float
outputs agree to rtol 1e-4 / atol 1e-5 of the output's scale: the kernels
write the Jacobians and S = HΣHᵀ out componentwise while the plain version
uses jacfwd and einsum, so the two round differently (observed ~1e-6
relative); Σ from K2/K3 is compared at atol 1e-4 of max|Σ| because the
sequential downdates cancel large terms.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from smarc_navigation_tpu_torch.configs import EKFSlamConfig
from smarc_navigation_tpu_torch.models import ekf_slam as S
from smarc_navigation_tpu_torch.ops import slam_da_kernels as tda
from smarc_navigation_tpu_torch.ops import slam_kernels as tsk
from smarc_navigation_tpu_torch.utils.geometry import Transform, rotmat_from_rpy

L, M = 16, 4
CFG = dataclasses.replace(
    EKFSlamConfig(), max_landmarks=L, max_obs=M, mhl_dist_mbes=1.0,
    q_mbes_diag=(0.1,) * 3, q_fls_diag=(4.0, 4.0), r_diag=(1e-3,) * 6)


@pytest.fixture(scope="module")
def jx():
    """The JAX reference, imported here rather than at the top so that the
    ``cuda`` tests of this file also run where only PyTorch is installed."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from smarc_navigation_tpu.ops import slam_da_kernels, slam_kernels

    return SimpleNamespace(jnp=jnp, pltpu=pltpu, da=slam_da_kernels, sk=slam_kernels)


def _close(got, want, rtol=1e-4, atol_scale=1e-5, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_scale * scale,
                               err_msg=what)


def _params(fls_mount: bool):
    if not fls_mount:
        return S.make_params(CFG, device="cpu")
    tf = Transform(rot=rotmat_from_rpy(torch.tensor([0.0, 0.08, 0.0])),
                   trans=torch.tensor([0.4, 0.0, -0.2]))
    return S.make_params(CFG, tf_base_fls=tf, device="cpu")


def _fleet_inputs(seed, B, sensor, params, n_act=(5, 9, 0)):
    """A fleet that honours the padding invariant (inactive slots' Σ rows
    and columns and μ entries are zero) with detections that re-observe
    active landmarks, propose new ones, and leave some slots masked."""
    rng = np.random.default_rng(seed)
    D = 6 + 3 * L
    mu = np.zeros((B, D), np.float32)
    Sig = np.zeros((B, D, D), np.float32)
    active = np.zeros((B, L), bool)
    n_active = np.zeros(B, np.int32)
    z = np.zeros((B, M, 3), np.float32)
    mask = np.zeros((B, M), bool)
    spec = S.FLS if sensor == "fls" else S.MBES
    for b in range(B):
        na = n_act[b % len(n_act)]
        Da = 6 + 3 * na
        mu[b, 0:3] = rng.normal(0, 2.0, 3)
        mu[b, 3:6] = rng.uniform(-0.2, 0.2, 3)
        if sensor == "fls":
            lms = mu[b, 0:3] + rng.uniform([6, -4, -2], [14, 4, 1], (na, 3))
        else:
            lms = mu[b, 0:3] + rng.uniform([-10, -10, -12], [10, 10, -8], (na, 3))
        mu[b, 6:Da] = lms.reshape(-1)
        Af = rng.normal(0, 0.08, (Da, Da))
        Sig[b, :Da, :Da] = Af @ Af.T + np.eye(Da) * 0.05
        active[b, :na] = True
        n_active[b] = na
        pose = torch.from_numpy(mu[b, 0:6])
        k = 0
        for i in range(min(na, 2)):
            zi = spec.h(pose, torch.from_numpy(lms[i].astype(np.float32)), params).numpy()
            z[b, k, :spec.dim] = zi + rng.normal(0, 0.02, spec.dim)
            mask[b, k] = True
            k += 1
        far = mu[b, 0:3] + (rng.uniform([20, 20, -12], [30, 30, -8]) if sensor == "mbes"
                            else rng.uniform([8, -3, -1], [12, 3, 0]))
        zf = spec.h(pose, torch.from_numpy(far.astype(np.float32)), params).numpy()
        z[b, k, :spec.dim] = zf + (0 if sensor == "mbes" else 25.0)
        mask[b, k] = True
    g = rng.normal(0, 0.05, (B, 3, 3)).astype(np.float32)
    A = np.tile(np.eye(6, dtype=np.float32), (B, 1, 1))
    A[:, 0:3, 3:6] = g
    r_full = np.tile(np.eye(6, dtype=np.float32) * 1e-3, (B, 1, 1))
    A[-1], r_full[-1] = np.eye(6), 0.0           # last mission: invalid odometry
    band = S.initial_band(torch.from_numpy(Sig), L).numpy()
    return dict(pose6=mu[:, 0:6].copy(), n_active=n_active, active=active,
                lm_pos=mu[:, 6:].reshape(B, L, 3).copy(), Sigma=Sig, z=z,
                z_mask=mask, A=A, r_full=r_full, band=band, mu=mu)


def _da_args(x, sensor, params, predict, use_band):
    spec = S.FLS if sensor == "fls" else S.MBES
    return (
        [x["pose6"], x["n_active"], x["active"], x["lm_pos"], x["Sigma"], x["z"],
         x["z_mask"], np.diag(spec.q(params).numpy()).copy(),
         float(spec.lam(params)), CFG.outlier_cost, spec.mh_dist(CFG),
         np.asarray(spec.new_lm_cov, np.float32)],
        dict(sensor=sensor,
             r_sb=params.r_fls_base.numpy() if sensor == "fls" else None,
             t_sb=params.t_fls_base.numpy() if sensor == "fls" else None,
             A=x["A"] if predict else None,
             r_full=x["r_full"] if predict else None,
             band=x["band"] if use_band else None))


def _to_torch(v, device="cpu"):
    if v is None or isinstance(v, (float, int, str)):
        return v
    return torch.from_numpy(np.ascontiguousarray(v)).to(device)


def _to_jax(jx, v):
    if v is None or isinstance(v, (float, int, str)):
        return v
    return jx.jnp.asarray(v)


DA_NAMES = ["col_to_row", "H_sel", "SinvH", "nu_sel", "cand", "do", "add", "slot"]


def _assert_da_equal(got, want, z_mask):
    """Discrete outputs exact; float outputs to tolerance on the detections
    that are present. A masked-out detection (z = 0) back-projects, in the
    FLS form, onto the sensor origin, where the pixel model is singular
    (range ~1e-6 m): its H/S⁻¹ are finite but carry no digits, and no update
    reads them (do is False)."""
    for n, g, w in zip(DA_NAMES, got, want):
        if n in ("col_to_row", "do", "add", "slot"):
            np.testing.assert_array_equal(g, w, err_msg=n)
        elif n == "cand":
            _close(g, w, what=n)
        else:
            _close(g[z_mask], w[z_mask], what=n)


DA_CASES = [("mbes", True, True), ("mbes", False, False),
            ("fls", True, True), ("fls", False, False)]


# the other two forms (MBES with predict and band, FLS with band only) run
# inside the JAX fleet replay of tests/test_torch_ekf_slam.py; each
# interpret-mode compile of the JAX kernel costs 15-30 s on the CPU
@pytest.mark.parametrize("sensor,predict,use_band", [DA_CASES[1], DA_CASES[2]])
def test_da_lanes_plain_matches_jax(jx, sensor, predict, use_band):
    params = _params(fls_mount=sensor == "fls")
    x = _fleet_inputs(3, 3, sensor, params)
    args, kw = _da_args(x, sensor, params, predict, use_band)
    got = tda.da_lanes(*[_to_torch(a) for a in args],
                       **{k: _to_torch(v) for k, v in kw.items()})
    with jx.pltpu.force_tpu_interpret_mode():
        want = jx.da.da_lanes(*[_to_jax(jx, a) for a in args],
                              **{k: _to_jax(jx, v) for k, v in kw.items()})
    _assert_da_equal([g.numpy() for g in got], [np.asarray(w) for w in want],
                     x["z_mask"])
    # the inputs really exercise re-observations, adds and masked slots
    do, add = got[5].numpy(), got[6].numpy()
    assert (do & ~add).any() and add.any() and (~do).any()


def _update_inputs(seed, B, dim, invariant=True, L=L, M=M):
    """Random update sequences (K2/K3 contract inputs) over L slots with M
    updates per mission."""
    rng = np.random.default_rng(seed)
    D = 6 + 3 * L
    A = rng.normal(0, 0.2, (B, D, D))
    Sigma = (np.einsum("bij,bkj->bik", A, A) + np.eye(D)[None]).astype(np.float32)
    mu = rng.normal(0, 1, (B, D)).astype(np.float32)
    H = rng.normal(0, 0.1, (B, M, dim, 9)).astype(np.float32)
    Sinv = rng.uniform(0.1, 0.4, (B, M))[:, :, None, None] * np.eye(dim)
    SinvH = np.einsum("bmij,bmjk->bmik", Sinv, H).astype(np.float32)
    nu = rng.normal(0, 0.3, (B, M, dim)).astype(np.float32)
    slots = np.stack([rng.permutation(L)[:M] for _ in range(B)])
    lm_ix = (6 + 3 * slots).astype(np.int32)
    do = rng.random((B, M)) < 0.8
    add = (rng.random((B, M)) < 0.4) & do
    do[0, 0], add[0, 1], do[0, 1] = False, True, True
    if invariant:   # added slots start with zero Σ rows/cols and zero μ
        for b in range(B):
            for j in np.nonzero(add[b])[0]:
                s = lm_ix[b, j]
                Sigma[b, s:s + 3, :] = 0.0
                Sigma[b, :, s:s + 3] = 0.0
                mu[b, s:s + 3] = 0.0
    cand = rng.normal(0, 5.0, (B, M, 3)).astype(np.float32)
    g = rng.normal(0, 0.05, (B, 3, 3)).astype(np.float32)
    a8 = np.zeros((B, 8, 16), np.float32)
    a8[:, :8, :8] = np.eye(8)
    a8[:, 0:3, 3:6] = g
    a8[:, 0:6, 8:14] = np.eye(6) * 1e-3
    a8[-1, :, :] = 0.0
    a8[-1, :8, :8] = np.eye(8)                     # invalid odometry: exact no-op
    new_cov = np.array([2.0, 1.5, 1.0], np.float32)
    band = S.initial_band(torch.from_numpy(Sigma), L).numpy()
    return dict(Sigma=Sigma, mu=mu, H=H, SinvH=SinvH, nu=nu, lm_ix=lm_ix, do=do,
                add=add, new_cov=new_cov, cand=cand, a8=a8, band=band)


def _band_consumed(band):
    """The (a, d) rows with a + d <= 2 — the only band entries consumed."""
    return np.stack([band[:, a * 8 + d] for a in range(3) for d in range(3 - a)], 1)


@pytest.mark.parametrize("with_extras,dim", [(True, 3), (False, 3), (True, 2)])
def test_sequential_update_fleet_plain_matches_jax(jx, with_extras, dim):
    x = _update_inputs(5 + dim, 3, dim)
    args = [x[k] for k in ("Sigma", "mu", "H", "SinvH", "nu", "lm_ix", "do", "add", "new_cov")]
    extras = [x["cand"], x["a8"], x["band"]] if with_extras else []
    got = tsk.sequential_update_fleet(*[_to_torch(a) for a in args + extras])
    with jx.pltpu.force_tpu_interpret_mode():
        want = jx.sk.sequential_update_fleet(*[_to_jax(jx, a) for a in args + extras])
    Sg, Sw = got[0].numpy(), np.asarray(want[0])
    _close(Sg, Sw, rtol=0, atol_scale=1e-4, what="Sigma")
    _close(got[1].numpy(), np.asarray(want[1]), rtol=0, atol_scale=1e-5, what="mu")
    np.testing.assert_array_equal(Sg, np.swapaxes(Sg, 1, 2))
    if with_extras:
        _close(_band_consumed(got[2].numpy()), _band_consumed(np.asarray(want[2])),
               rtol=0, atol_scale=1e-4, what="band")
        # the invalid-odometry mission's predict is an exact no-op, and the
        # activations and candidate μ really landed
        b = 2
        for j in np.nonzero(x["add"][b])[0]:
            s = x["lm_ix"][b, j]
            assert not np.allclose(got[1].numpy()[b, s:s + 3], 0.0)


def test_sequential_update_plain_matches_jax(jx):
    x = _update_inputs(17, 1, 3)
    args = [x[k][0] for k in ("Sigma", "mu", "H", "SinvH", "nu", "lm_ix", "do", "add")]
    args.append(x["new_cov"])
    got = tsk.sequential_update(*[_to_torch(a) for a in args])
    with jx.pltpu.force_tpu_interpret_mode():
        want = jx.sk.sequential_update(*[_to_jax(jx, a) for a in args])
    _close(got[0].numpy(), np.asarray(want[0]), rtol=0, atol_scale=1e-4, what="Sigma")
    _close(got[1].numpy(), np.asarray(want[1]), rtol=0, atol_scale=1e-5, what="mu")


def test_wrappers_take_plain_version_only_for_cpu_tensors():
    """A wrapper launches nothing for CPU tensors and refuses other devices."""
    x = _update_inputs(1, 2, 3)
    args = [_to_torch(x[k]) for k in
            ("Sigma", "mu", "H", "SinvH", "nu", "lm_ix", "do", "add", "new_cov")]
    n0 = tsk.sequential_update_fleet.launches
    tsk.sequential_update_fleet(*args)
    assert tsk.sequential_update_fleet.launches == n0
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tsk.sequential_update_fleet(*[a.to("meta") for a in args])


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sensor,predict,use_band", DA_CASES)
def test_da_lanes_kernel_matches_plain(cuda, sensor, predict, use_band):
    params = _params(fls_mount=sensor == "fls")
    x = _fleet_inputs(7, 5, sensor, params)
    args, kw = _da_args(x, sensor, params, predict, use_band)
    targs = [_to_torch(a, cuda) for a in args]
    tkw = {k: _to_torch(v, cuda) for k, v in kw.items()}
    n0 = tda.da_lanes.launches
    got = tda.da_lanes(*targs, **tkw)
    torch.cuda.synchronize()
    assert tda.da_lanes.launches == n0 + 1
    want = tda.da_lanes_reference(*targs, **tkw)
    _assert_da_equal([g.cpu().numpy() for g in got], [w.cpu().numpy() for w in want],
                     x["z_mask"])


@pytest.mark.cuda
@pytest.mark.parametrize("with_extras,dim", [(True, 3), (False, 3), (True, 2)])
def test_sequential_update_fleet_kernel_matches_plain(cuda, with_extras, dim):
    x = _update_inputs(23 + dim, 4, dim)
    args = [_to_torch(x[k], cuda) for k in
            ("Sigma", "mu", "H", "SinvH", "nu", "lm_ix", "do", "add", "new_cov")]
    extras = [_to_torch(x[k], cuda) for k in ("cand", "a8", "band")] if with_extras else []
    got = tsk.sequential_update_fleet(*args, *extras)
    torch.cuda.synchronize()
    want = tsk.sequential_update_fleet_reference(*args, *extras)
    _close(got[0].cpu().numpy(), want[0].cpu().numpy(), rtol=0, atol_scale=1e-4)
    _close(got[1].cpu().numpy(), want[1].cpu().numpy(), rtol=0, atol_scale=1e-5)
    assert torch.equal(got[0], got[0].transpose(1, 2))
    if with_extras:
        _close(_band_consumed(got[2].cpu().numpy()),
               _band_consumed(want[2].cpu().numpy()), rtol=0, atol_scale=1e-4)


@pytest.mark.cuda
def test_sequential_update_kernel_matches_plain(cuda):
    x = _update_inputs(31, 1, 3)
    args = [_to_torch(x[k][0], cuda) for k in
            ("Sigma", "mu", "H", "SinvH", "nu", "lm_ix", "do", "add")]
    args.append(_to_torch(x["new_cov"], cuda))
    n0 = tsk.sequential_update.launches
    got = tsk.sequential_update(*args)
    torch.cuda.synchronize()
    assert tsk.sequential_update.launches == n0 + 1
    want = tsk.sequential_update_reference(*args)
    _close(got[0].cpu().numpy(), want[0].cpu().numpy(), rtol=0, atol_scale=1e-4)
    _close(got[1].cpu().numpy(), want[1].cpu().numpy(), rtol=0, atol_scale=1e-5)
