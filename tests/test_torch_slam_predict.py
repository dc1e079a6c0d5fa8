"""The online step's motion predict, K15 (``slam_kernels.online_predict``),
against its plain twin ``ekf_slam.predict(state, odom_pose(v), params)``
(``odom_pose`` from ``utils.geometry``).

On the CPU the wrapper takes the twin as it is: bitwise, launching nothing.
The ``cuda`` tests hold the kernel to the twin run on the card, at L=64 and
L=256, with 6- and 13-wide odometry, on random symmetric positive definite
Σ: attitudes drawn at random, at ±π (where the wrap folds) and at pitch
±π/2 (where the clamp before the asin acts), odometry steps of tens of m
and of a few cm to m (a log's); μ's position, everything the predict does
not touch, ``mu_auv_odom`` and Σ's attitude rows and columns (R's and
zeros) bitwise, the attitude within 2 ulp, Σ within 1e-6 of its largest
entry and its position rows within 1e-6 of their own block's. Then ``step`` on CUDA state
launches K15 once a tick, and a ``run`` over a recorded log with detections
gives the twin's associations and landmark counts, poses within 1e-5. They
skip where there is no card. This file imports no JAX.
"""

import dataclasses
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from smarc_navigation_tpu_torch.configs import EKFSlamConfig
from smarc_navigation_tpu_torch.models import ekf_slam as S
from smarc_navigation_tpu_torch.ops import slam_kernels as K
from smarc_navigation_tpu_torch.utils.geometry import odom_pose, quat_from_rpy_np

HALF_PI = math.pi / 2
# attitudes (roll, pitch, yaw) by case; "random" draws them
ATTITUDES = {
    "pi": [(math.pi, 0.2, -math.pi), (-math.pi, -0.1, math.pi), (0.0, 0.0, math.pi)],
    "pitch90": [(0.3, HALF_PI, 1.0), (-0.7, -HALF_PI, -2.0), (0.1, HALF_PI - 1e-4, 3.0)],
}


def _state(L, seed, device):
    """A predict's inputs at L slots: random μ and mu_auv_odom, Σ and R
    random symmetric positive definite."""
    rng = np.random.default_rng(seed)
    D = 6 + 3 * L
    X = rng.normal(0.0, 1.0, (D, D)) / math.sqrt(D)
    Sigma = X @ X.T + 1e-3 * np.eye(D)
    Y = rng.normal(0.0, 0.05, (6, 6))
    R = Y @ Y.T + 1e-4 * np.eye(6)
    cfg = dataclasses.replace(EKFSlamConfig(), max_landmarks=L)
    st = S.init_state(cfg, device=device)
    st = st._replace(
        mu=torch.tensor(rng.normal(0.0, 20.0, D), dtype=torch.float32, device=device),
        Sigma=torch.tensor(Sigma, dtype=torch.float32, device=device),
        mu_auv_odom=torch.tensor(rng.normal(0.0, 20.0, 3), dtype=torch.float32, device=device))
    params = S.make_params(cfg, device=device)._replace(
        R=torch.tensor(R, dtype=torch.float32, device=device))
    return st, params


def _value(width, rpy, seed, device):
    """A raw odometry value: [pos3, rpy3] (6 wide) or [pos3, quat4 xyzw,
    linvel3, angvel3] (13 wide)."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(0.0, 20.0, 3)
    if width == 6:
        v = np.concatenate([pos, rpy])
    else:
        v = np.concatenate([pos, quat_from_rpy_np(np.asarray(rpy)), rng.normal(0.0, 1.0, 6)])
    return torch.tensor(v, dtype=torch.float32, device=device)


def _attitudes(case, seed):
    if case != "random":
        return ATTITUDES[case]
    rng = np.random.default_rng(seed)
    return [(rng.uniform(-math.pi, math.pi), rng.uniform(-1.5, 1.5), rng.uniform(-math.pi, math.pi))
            for _ in range(4)]


@pytest.mark.parametrize("width", [6, 13])
def test_online_predict_on_cpu_is_the_twin(width):
    """On CPU tensors ``online_predict`` is the twin, bit for bit, and
    launches nothing."""
    st, params = _state(4, 1, "cpu")
    n0 = K.online_predict.launches
    for i, rpy in enumerate(_attitudes("random", 2) + ATTITUDES["pi"] + ATTITUDES["pitch90"]):
        v = _value(width, rpy, 10 + i, "cpu")
        got = K.online_predict(st, v, params)
        want = S.predict(st, odom_pose(v), params)
        assert isinstance(got, S.SlamState)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert K.online_predict.launches == n0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _ulps(got, want):
    """|got − want| in units of the last place of want (float32)."""
    g, w = got.cpu().numpy(), want.cpu().numpy()
    return np.abs(g.astype(np.float64) - w) / np.spacing(np.abs(w).astype(np.float32))


def _check_k15(st, v, params, where):
    """One K15 call against the twin on the card."""
    D = st.mu.shape[0]
    n0 = K.online_predict.launches
    got = K.online_predict(st, v, params)
    assert K.online_predict.launches == n0 + 1
    want = S.predict(st, odom_pose(v), params)
    torch.cuda.synchronize()
    assert got.mu.shape == (D,) and got.Sigma.shape == (D, D), where
    assert torch.equal(got.mu[0:3], want.mu[0:3]), where
    assert torch.equal(got.mu[6:], want.mu[6:]), where
    assert torch.equal(got.mu_auv_odom, want.mu_auv_odom), where
    assert got.active is st.active and got.n_active is st.n_active
    assert float(_ulps(got.mu[3:6], want.mu[3:6]).max()) <= 2.0, (
        where, got.mu[3:6].tolist(), want.mu[3:6].tolist())
    assert torch.equal(got.Sigma[6:, 6:], want.Sigma[6:, 6:]), where
    # A's attitude rows are zero: Σ's attitude rows and columns are R's
    # columns and zeros, in the kernel and the twin alike
    assert torch.equal(got.Sigma[3:6], want.Sigma[3:6]), where
    assert torch.equal(got.Sigma[:, 3:6], want.Sigma[:, 3:6]), where
    scale = float(want.Sigma.abs().max())
    err = float((got.Sigma - want.Sigma).abs().max())
    assert err <= 1e-6 * scale, (where, err, scale)
    for rows, cols in ((slice(0, 3), slice(0, 3)), (slice(0, 3), slice(6, None))):
        g, w = got.Sigma[rows, cols].double(), want.Sigma[rows, cols].double()
        err, scale = float((g - w).abs().max()), float(w.abs().max())
        assert err <= 1e-6 * scale, (where, rows, cols, err, scale)
    assert torch.equal(got.Sigma[0:6, 6:], got.Sigma[6:, 0:6].T), where


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "pi", "pitch90"])
@pytest.mark.parametrize("width", [6, 13])
@pytest.mark.parametrize("L", [64, 256])
def test_k15_is_the_twin(cuda, L, width, case):
    """K15 against the twin on the card: μ's position, μ past the pose,
    ``mu_auv_odom``, Σ past the pose rows and columns and Σ's attitude rows
    and columns bitwise; the attitude within 2 ulp; Σ within 1e-6 of its
    largest entry, its position rows of their block's; one launch a call,
    fresh outputs, the inputs untouched. Each value is taken from a random
    ``mu_auv_odom`` (a step of tens of m) and from one a step of a few cm to
    m behind it, as a log's ticks are."""
    for seed in range(3):
        st, params = _state(L, 100 * L + seed, cuda)
        before = [x.clone() for x in st]
        rng = np.random.default_rng(seed)
        for i, rpy in enumerate(_attitudes(case, seed)):
            v = _value(width, rpy, 1000 * seed + i, cuda)
            _check_k15(st, v, params, (L, width, case, seed, rpy, "far"))
            step = rng.uniform(0.02, 2.0, 3) * rng.choice((-1.0, 1.0), 3)
            near = st._replace(mu_auv_odom=v[0:3] - torch.tensor(step, dtype=torch.float32,
                                                                device=cuda))
            _check_k15(near, v, params, (L, width, case, seed, rpy, "near"))
        for a, b in zip(st, before):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_k15_refuses_what_it_was_not_written_for(cuda):
    """A CUDA call launches or raises: another dtype, a non-contiguous Σ, a
    state size that is not 6 + 3L or odometry narrower than 6 never reach
    the kernel."""
    st, params = _state(8, 3, cuda)
    v = _value(13, (0.1, 0.2, 0.3), 4, cuda)
    n0 = K.online_predict.launches
    with pytest.raises(TypeError):
        K.online_predict(st, v.double(), params)
    with pytest.raises(ValueError):
        K.online_predict(st._replace(Sigma=st.Sigma.T), v, params)
    with pytest.raises(ValueError):
        K.online_predict(st._replace(mu=st.mu[:-1]), v, params)
    with pytest.raises(ValueError):
        K.online_predict(st, v[:5], params)
    assert K.online_predict.launches == n0


LOG_TICKS = 300     # the sample log's first 30 s


def _lolo_log(dev):
    """``run.py replay``'s configuration and parameters on ``dev``, and its
    default log's first LOG_TICKS ticks as a timeline on ``dev``."""
    from smarc_navigation_tpu_torch.io import logs

    cfg = dataclasses.replace(EKFSlamConfig(), max_landmarks=64, max_obs=8, mhl_dist_mbes=1.0,
                              q_mbes_diag=(0.1,) * 3, r_diag=(1e-3,) * 6)
    streams, _ = logs.load_log(str(Path(__file__).resolve().parents[1] / "data"
                                   / "sample_mission.npz"))
    tl = logs.log_to_timeline(streams, freq_hz=cfg.system_freq, channels=("odom",),
                              events={"mbes": cfg.max_obs})
    tl = tl.map(lambda x: torch.as_tensor(x[:LOG_TICKS])).to(dev)
    return cfg, S.make_params(cfg, device=dev), tl


@pytest.mark.cuda
def test_card_step_launches_k15_once_a_tick(cuda):
    """``step`` on CUDA state predicts through K15: one launch a tick, on
    quiet ticks and on ticks with detections alike."""
    cfg, params, tl = _lolo_log(cuda)
    tl = tl.map(lambda x: x[:60])
    burst = tl.events["mbes"].mask.any(-1).cpu()
    assert 0 < int(burst.sum()) < 60
    st = S.init_state(cfg, device=cuda)
    for k in range(60):
        n0 = K.online_predict.launches
        st, _ = S.step(cfg, params, st, tl.slice_tick(k))
        assert K.online_predict.launches == n0 + 1, (k, bool(burst[k]))


@pytest.mark.cuda
def test_card_run_is_the_twin_path(cuda, monkeypatch):
    """``run`` of a LoLo log on CUDA state through K15 against the same run
    with the twin in K15's place: matched_mbes and n_active exactly, poses
    within 1e-5 at every tick."""
    cfg, params, tl = _lolo_log(cuda)
    n_burst = int(tl.events["mbes"].mask.any(-1).sum())
    assert n_burst >= 50
    n0 = K.online_predict.launches
    final, out = S.run(tl, params, cfg)
    torch.cuda.synchronize()
    assert K.online_predict.launches == n0 + LOG_TICKS
    monkeypatch.setattr(K, "online_predict", lambda st, v, p: S.predict(st, odom_pose(v), p))
    t_final, t_out = S.run(tl, params, cfg)
    for key in ("matched_mbes", "n_active"):
        assert torch.equal(out[key], t_out[key]), key
    assert int((out["matched_mbes"] >= 0).sum()) > 0 and int(final.n_active) >= 5
    err = float((out["mu"] - t_out["mu"]).abs().max())
    assert err <= 1e-5, err
    assert torch.equal(final.active, t_final.active)
