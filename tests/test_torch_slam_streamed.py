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
    """``streamed=None`` takes the streamed schedule for D >= STREAMED_MIN_D
    (its plain version, on the CPU) and the one-kernel schedule below."""
    targs = [_to_torch(a) for a in _inputs(3)]
    S_n, mu_n = tsk.sequential_update_fleet(*targs)
    S_s, mu_s = tsk.sequential_update_fleet(*targs, streamed=D >= tsk.STREAMED_MIN_D)
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
