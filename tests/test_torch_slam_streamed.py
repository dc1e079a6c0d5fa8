"""K2's streamed schedule and K12 (``symmetric_downdate``) against the JAX
package's ``sequential_update_fleet(streamed=True)`` and against numpy.

The shape is the JAX package's own streamed test
(``tests/test_slam_kernels.py``: B=2, L=170, M=4, D=516). On the CPU the
port's wrappers take their plain versions; the JAX side runs its Pallas
kernels in TPU-interpret mode. The ``cuda`` tests hold K12 and the streamed
K2 against their plain versions, and the streamed schedule against the
one-kernel schedule, on the card.

Tolerances: μ of the streamed schedule is bitwise the one-kernel schedule's
(the same update sequence produces both). Σ agrees with JAX's to 1e-5 of its
scale: the factors are the same algebra, summed in another order (observed
~1e-7 relative). Every Σ is exactly symmetric.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from smarc_navigation_tpu_torch.configs import EKFSlamConfig
from smarc_navigation_tpu_torch.models import ekf_slam as S
from smarc_navigation_tpu_torch.ops import slam_kernels as tsk

from test_torch_slam_kernels import _close, _to_torch

B, L, M, DIM = 2, 170, 4, 3
D = 6 + 3 * L


@pytest.fixture(scope="module")
def jx():
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from smarc_navigation_tpu.ops import slam_kernels

    return SimpleNamespace(jnp=jnp, pltpu=pltpu, sk=slam_kernels)


def _inputs(seed):
    """The JAX package's streamed-test inputs (random SPD Σ, random update
    sequences at D >= 512)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(0, 0.05, (B, D, D))
    Sigma0 = (np.einsum("bij,bkj->bik", A, A) + np.eye(D)[None]).astype(np.float32)
    mu0 = rng.normal(0, 1, (B, D)).astype(np.float32)
    H = rng.normal(0, 0.1, (B, M, DIM, 9)).astype(np.float32)
    Sinv = rng.uniform(0.1, 0.4, (B, M))[:, :, None, None] * np.eye(DIM)
    SinvH = np.einsum("bmij,bmjk->bmik", Sinv, H).astype(np.float32)
    nu = rng.normal(0, 0.3, (B, M, DIM)).astype(np.float32)
    slots = rng.integers(0, L, (B, M))
    lm_ix = (6 + 3 * slots).astype(np.int32)
    do = rng.random((B, M)) < 0.8
    add = (rng.random((B, M)) < 0.4) & do
    new_cov = np.array([2.0, 1.5, 1.0], np.float32)
    return [Sigma0, mu0, H, SinvH, nu, lm_ix, do, add, new_cov]


def test_streamed_plain_matches_jax(jx):
    args = _inputs(29)
    targs = [_to_torch(a) for a in args]
    S_s, mu_s = tsk.sequential_update_fleet(*targs, streamed=True)
    S_d, mu_d = tsk.sequential_update_fleet(*targs, streamed=False)
    with jx.pltpu.force_tpu_interpret_mode():
        JS_s, _ = jx.sk.sequential_update_fleet(*[jx.jnp.asarray(a) for a in args],
                                                streamed=True)
    assert torch.equal(mu_s, mu_d)
    _close(S_s.numpy(), np.asarray(JS_s), rtol=0, atol_scale=1e-5, what="Sigma vs JAX")
    _close(S_s.numpy(), S_d.numpy(), rtol=0, atol_scale=1e-5, what="Sigma vs one-kernel")
    assert torch.equal(S_s, S_s.transpose(1, 2))


def test_streamed_is_the_default_at_large_state():
    """The default schedule is the streamed one (its plain version, on the
    CPU), here at D >= 512 as at every state size."""
    targs = [_to_torch(a) for a in _inputs(3)]
    S_n, mu_n = tsk.sequential_update_fleet(*targs)
    S_s, mu_s = tsk.sequential_update_fleet(*targs, streamed=True)
    assert torch.equal(S_n, S_s) and torch.equal(mu_n, mu_s)


def _downdate_inputs(seed, Bd=3, Dd=70, K=7):
    rng = np.random.default_rng(seed)
    A = rng.normal(0, 0.3, (Bd, Dd, Dd))
    Sigma = (np.einsum("bij,bkj->bik", A, A) + np.eye(Dd)[None]).astype(np.float32)
    U = rng.normal(0, 0.2, (Bd, K, Dd)).astype(np.float32)
    V = rng.normal(0, 0.2, (Bd, K, Dd)).astype(np.float32)
    P = (Sigma[:, 0:6] + rng.normal(0, 0.01, (Bd, 6, Dd))).astype(np.float32)
    act = np.where(rng.random((Bd, Dd)) < 0.2, rng.uniform(1, 3, (Bd, Dd)), 0.0
                   ).astype(np.float32)
    return Sigma, U, V, P, act


def test_symmetric_downdate_plain_matches_numpy():
    """K12's function: Σ − ½(UᵀV + VᵀU) on Σ' = Σ with its pose rows
    replaced by P (and their transpose), plus the activation diagonal."""
    Sigma, U, V, P, act = _downdate_inputs(1)
    got = tsk.symmetric_downdate(*[_to_torch(a) for a in (Sigma, U, V, P, act)]).numpy()
    S1 = Sigma.astype(np.float64)
    S1[:, 0:6, :] = P
    S1[:, 6:, 0:6] = np.swapaxes(P[:, :, 6:], 1, 2)
    S1 += act[:, :, None] * np.eye(Sigma.shape[1])[None]
    s = S1 - np.einsum("bki,bkj->bij", U, V)
    want = 0.5 * (s + np.swapaxes(s, 1, 2))
    _close(got, want, rtol=0, atol_scale=1e-6, what="downdate")
    assert np.array_equal(got, np.swapaxes(got, 1, 2))
    # without P and act: Σ − ½(UᵀV + VᵀU)
    plain = tsk.symmetric_downdate(*[_to_torch(a) for a in (Sigma, U, V)]).numpy()
    uv = np.einsum("bki,bkj->bij", U.astype(np.float64), V)
    _close(plain, Sigma - 0.5 * (uv + np.swapaxes(uv, 1, 2)), rtol=0, atol_scale=1e-6)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("with_p", [True, False])
def test_symmetric_downdate_kernel_matches_plain(cuda, with_p):
    Sigma, U, V, P, act = _downdate_inputs(7, Bd=4, Dd=774, K=24)
    t = [_to_torch(a, cuda) for a in (Sigma, U, V)]
    extra = [_to_torch(P, cuda), _to_torch(act, cuda)] if with_p else []
    n0 = tsk.symmetric_downdate.launches
    got = tsk.symmetric_downdate(*t, *extra)
    torch.cuda.synchronize()
    assert tsk.symmetric_downdate.launches == n0 + 1
    want = tsk.symmetric_downdate_reference(*t, *extra)
    _close(got.cpu().numpy(), want.cpu().numpy(), rtol=0, atol_scale=1e-5)
    assert torch.equal(got, got.transpose(1, 2))


@pytest.mark.cuda
def test_streamed_kernel_matches_one_kernel_schedule(cuda):
    """On the card the two schedules give the same μ and band bit for bit,
    Σ exactly symmetric and equal to tolerance; both match the plain
    streamed version."""
    from test_torch_slam_kernels import _update_inputs

    x = _update_inputs(41, 3, 3)
    args = [_to_torch(x[k], cuda) for k in
            ("Sigma", "mu", "H", "SinvH", "nu", "lm_ix", "do", "add", "new_cov",
             "cand", "a8", "band")]
    n0 = (tsk.sequential_update_fleet.launches, tsk.symmetric_downdate.launches)
    S_s, mu_s, band_s = tsk.sequential_update_fleet(*args, streamed=True)
    S_d, mu_d, band_d = tsk.sequential_update_fleet(*args, streamed=False)
    torch.cuda.synchronize()
    assert (tsk.sequential_update_fleet.launches, tsk.symmetric_downdate.launches) == (
        n0[0] + 2, n0[1] + 1)
    assert torch.equal(mu_s, mu_d) and torch.equal(band_s, band_d)
    assert torch.equal(S_s, S_s.transpose(1, 2))
    _close(S_s.cpu().numpy(), S_d.cpu().numpy(), rtol=0, atol_scale=1e-5)
    want = tsk.sequential_update_fleet_reference(*args, streamed=True)
    _close(S_s.cpu().numpy(), want[0].cpu().numpy(), rtol=0, atol_scale=1e-4)
    _close(mu_s.cpu().numpy(), want[1].cpu().numpy(), rtol=0, atol_scale=1e-5)


# ---------------------------------------------------------------------------
# the streamed schedule at every state size
# ---------------------------------------------------------------------------

def _update_args(x, b=None):
    """K2's arguments (all of them) from an ``_update_inputs`` dict, or K3's
    (no cand, a8, band) for mission ``b``."""
    if b is not None:
        return [x[k][b] for k in ("Sigma", "mu", "H", "SinvH", "nu", "lm_ix", "do", "add")] + [
            x["new_cov"]]
    return [x[k] for k in ("Sigma", "mu", "H", "SinvH", "nu", "lm_ix", "do", "add", "new_cov",
                           "cand", "a8", "band")]


def test_k3_and_b1_fleet_take_the_streamed_schedule(jx):
    """The default schedule is the streamed one at every D, for K3 and for
    K2 at B=1: on the CPU each wrapper gives its plain streamed version bit
    for bit, and that agrees with the JAX kernels as the large-state test
    above does."""
    from test_torch_slam_kernels import _update_inputs

    x = _update_inputs(17, 2, 3)
    x["add"] &= x["do"]              # the JAX kernels' contract: an add implies do
    k3 = _update_args(x, 0)
    got = tsk.sequential_update(*[_to_torch(a) for a in k3])
    want = tsk.sequential_update_reference(*[_to_torch(a) for a in k3], streamed=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    fleet = [a[0:1] if isinstance(a, np.ndarray) and a.ndim > 1 else a for a in _update_args(x)]
    gotf = tsk.sequential_update_fleet(*[_to_torch(a) for a in fleet])
    wantf = tsk.sequential_update_fleet_reference(*[_to_torch(a) for a in fleet], streamed=True)
    assert all(torch.equal(g, w) for g, w in zip(gotf, wantf))
    with jx.pltpu.force_tpu_interpret_mode():
        J3 = jx.sk.sequential_update(*[jx.jnp.asarray(a) for a in k3])
        JF = jx.sk.sequential_update_fleet(*[jx.jnp.asarray(a) for a in fleet])
    for g, w, what in ((got[0], J3[0], "K3 Sigma"), (got[1], J3[1], "K3 mu"),
                       (gotf[0], JF[0], "B=1 Sigma"), (gotf[1], JF[1], "B=1 mu")):
        _close(g.numpy(), np.asarray(w), rtol=0, atol_scale=1e-5, what=what)
    assert torch.equal(got[0], got[0].T) and torch.equal(gotf[0], gotf[0].transpose(1, 2))


def _bits(t):
    return t.contiguous().view(torch.int32)


def _card_case(case):
    """K2's arguments at one shape the card tests hold the streamed
    schedule to."""
    from test_torch_slam_kernels import _update_inputs

    if case == "headline":        # D=198, B=128
        x = _update_inputs(51, 128, 3, L=64, M=8)
    elif case == "L256":          # D=774, B=4
        x = _update_inputs(52, 4, 3, L=256, M=8)
    elif case == "B1":            # one mission with a real predict
        x = _update_inputs(53, 2, 3, L=64, M=8)
        x = {k: (v[0:1] if isinstance(v, np.ndarray) and v.ndim > 1 else v) for k, v in x.items()}
    elif case == "odd":           # D=129: odd rows, 4-byte copies
        x = _update_inputs(54, 5, 2, L=41, M=6)
    elif case == "small":         # D=21: below one tile of either kernel
        x = _update_inputs(55, 3, 3, L=5, M=3)
    elif case == "all_off":
        x = _update_inputs(56, 6, 3, L=64, M=8)
        x["do"][:], x["add"][:] = False, False
    elif case.startswith("defaults"):   # EKFSlamConfig()'s max_obs: M=16, K = 48 (MBES), 32 (FLS)
        cfg = EKFSlamConfig()
        dim = 3 if "mbes" in case else 2
        L_ = 64 if case.endswith("L64") else cfg.max_landmarks
        x = _update_inputs(58 + dim + L_, 4, dim, L=L_, M=cfg.max_obs)
    elif case == "spill":         # M=32: phase 1's working set in device scratch, K12 in 3 chunks
        x = _update_inputs(59, 6, 3, L=64, M=32)
    else:                         # an add on the last slot of every mission
        x = _update_inputs(57, 6, 3, L=64, M=8)
        last = 6 + 3 * 63
        for b in range(x["do"].shape[0]):   # the update on the last slot goes last
            hit = np.nonzero(x["lm_ix"][b] == last)[0]
            order = np.arange(8)
            if hit.size:
                order[[hit[0], 7]] = order[[7, hit[0]]]
            for k in ("H", "SinvH", "nu", "lm_ix", "do", "add", "cand"):
                x[k][b] = x[k][b][order]
            x["lm_ix"][b, 7] = last
            x["do"][b, 7] = x["add"][b, 7] = True
            x["Sigma"][b, last:, :] = 0.0
            x["Sigma"][b, :, last:] = 0.0
            x["mu"][b, last:] = 0.0
        x["band"] = S.initial_band(torch.from_numpy(x["Sigma"]), 64).numpy()
    return _update_args(x)


CASES = ["headline", "L256", "B1", "odd", "small", "all_off", "add_last", "defaults_mbes_L64",
         "defaults_fls_L64", "defaults_mbes_L256", "defaults_fls_L256", "spill"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_streamed_is_the_one_kernel_schedule_bit_for_bit(cuda, case):
    """Phase 1 + K12 give the one-kernel schedule's Σ, μ and band bit for
    bit, Σ exactly symmetric; one K2 launch per call and one K12 launch per
    streamed call; both within the plain version's tolerances."""
    args = _card_case(case)
    t = [_to_torch(a, cuda) for a in args]
    n0 = (tsk.sequential_update_fleet.launches, tsk.symmetric_downdate.launches)
    strm = tsk.sequential_update_fleet(*t)
    torch.cuda.synchronize()
    n1 = (tsk.sequential_update_fleet.launches, tsk.symmetric_downdate.launches)
    one = tsk.sequential_update_fleet(*t, streamed=False)
    torch.cuda.synchronize()
    n2 = (tsk.sequential_update_fleet.launches, tsk.symmetric_downdate.launches)
    assert n1 == (n0[0] + 1, n0[1] + 1) and n2 == (n1[0] + 1, n1[1])
    for g, w, what in zip(strm, one, ("Sigma", "mu", "band")):
        assert torch.equal(_bits(g), _bits(w)), f"{case}: {what} differs between the schedules"
    assert torch.equal(_bits(strm[0]), _bits(strm[0].transpose(1, 2)))
    want = tsk.sequential_update_fleet_reference(*t, streamed=True)
    _close(strm[0].cpu().numpy(), want[0].cpu().numpy(), rtol=0, atol_scale=1e-4)
    _close(strm[1].cpu().numpy(), want[1].cpu().numpy(), rtol=0, atol_scale=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_symmetric_downdate_kernel_on_phase1_factors(cuda, case):
    """K12 on phase 1's own outputs against its plain version, exactly
    symmetric, one launch per call."""
    args = _card_case(case)
    t = [_to_torch(a, cuda) for a in args]
    mu, band, P, U, V, act = tsk.phase1(*t)
    n0 = tsk.symmetric_downdate.launches
    got = tsk.symmetric_downdate(t[0], U, V, P, act)
    torch.cuda.synchronize()
    assert tsk.symmetric_downdate.launches == n0 + 1
    want = tsk.symmetric_downdate_reference(t[0], U, V, P, act)
    _close(got.cpu().numpy(), want.cpu().numpy(), rtol=0, atol_scale=1e-5)
    assert torch.equal(_bits(got), _bits(got.transpose(1, 2)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["headline", "odd", "small", "all_off", "add_last",
                                  "defaults_mbes_L64", "spill"])
def test_k3_is_the_one_kernel_schedule_bit_for_bit(cuda, case):
    """K3 (B=1, no predict) through phase 1 + K12: the one-kernel schedule's
    bits, one K3 and one K12 launch per call, and its plain version's
    tolerances."""
    args = _card_case(case)
    k3 = [a[0] if i < 8 else a for i, a in enumerate(args[:9])]
    t = [_to_torch(a, cuda) for a in k3]
    n0 = (tsk.sequential_update.launches, tsk.symmetric_downdate.launches)
    S3, mu3 = tsk.sequential_update(*t)
    torch.cuda.synchronize()
    assert (tsk.sequential_update.launches, tsk.symmetric_downdate.launches) == (
        n0[0] + 1, n0[1] + 1)
    S1, mu1 = tsk.sequential_update_fleet(*[a[None] if i < 8 else a for i, a in enumerate(t)],
                                          streamed=False)
    assert torch.equal(_bits(S3), _bits(S1[0])) and torch.equal(_bits(mu3), _bits(mu1[0]))
    assert torch.equal(_bits(S3), _bits(S3.T))
    want = tsk.sequential_update_reference(*t, streamed=True)
    _close(S3.cpu().numpy(), want[0].cpu().numpy(), rtol=0, atol_scale=1e-4)
    _close(mu3.cpu().numpy(), want[1].cpu().numpy(), rtol=0, atol_scale=1e-5)
