"""6-DOF EKF localization against a known landmark map (PyTorch port of
``smarc_navigation_tpu/models/ekf_localization.py``).

The ROS timer tick of ``auv_ekf_localization`` (``ekf_localization.cpp:
547-624``) is ``step``; ``run`` folds it over one mission's timeline. See the
reference's module docstring for the mapping onto the ROS node:

* motion update from DVL body velocity + IMU absolute orientation, with a G
  whose orientation rows are zero (attitude is measured absolutely);
* measurement model h(μ, lm) = R(μ_rpy)ᵀ(lm − μ_pos), Jacobians by
  ``torch.func.jacfwd`` of the same models;
* per-detection greedy maximum-likelihood association (landmark pre-gate,
  χ²(3) gate, rank by ψ = exp(−d/2)·rsqrt(π³·det S)) and sequential updates
  in measurement order; the stone-volume offset on detection y/z.

``run_fleet`` stages every per-tick scalar over (B, T) in plain PyTorch and
then runs one K9 launch per tick (``ops.loc_kernels``: CUDA kernel for CUDA
tensors, its plain version for CPU tensors). K9 ranks by −½(d + log det S)
and writes the predicted attitude as wrap(rpy_t), as the reference's kernel
does; the dense path keeps the reference's dense forms.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch.func import jacfwd

from ..configs import EKFLocConfig
from ..ops import bezier, loc_kernels
from ..ops.timeline import build_timeline
from ..utils.geometry import rotmat_from_rpy, rpy_from_quat, wrap_angle
from ..utils.linalg import chi2_quantile, inv_det_small3


class EKFLocParams(NamedTuple):
    """Static (per-mission) parameters."""

    map_pos: torch.Tensor     # (N, 3) known landmark positions (odom frame)
    map_mask: torch.Tensor    # (N,) which slots hold real landmarks
    Q: torch.Tensor           # (3, 3) measurement noise
    R: torch.Tensor           # (6, 6) motion noise
    lambda_m: torch.Tensor    # χ²(3) gate
    r_base_dvl: torch.Tensor  # (3, 3) DVL->base extrinsic rotation


class EKFLocState(NamedTuple):
    mu: torch.Tensor          # (6,)
    Sigma: torch.Tensor       # (6, 6)
    t_prev: torch.Tensor      # scalar


def make_params(
    map_pos: np.ndarray,
    cfg: EKFLocConfig = EKFLocConfig(),
    r_base_dvl: np.ndarray | None = None,
    dtype=torch.float32,
    device="cuda",
) -> EKFLocParams:
    n = cfg.max_landmarks
    m = np.zeros((n, 3), dtype=np.float64)
    k = min(len(map_pos), n)
    m[:k] = np.asarray(map_pos)[:k]
    mask = np.zeros(n, bool)
    mask[:k] = True

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=device)

    return EKFLocParams(
        map_pos=t(m),
        map_mask=torch.as_tensor(mask, device=device),
        Q=torch.diag(t(cfg.q_diag)),
        R=torch.diag(t(cfg.r_diag)),
        lambda_m=t(chi2_quantile(cfg.delta_outlier_reject, 3)),
        r_base_dvl=t(np.eye(3) if r_base_dvl is None else r_base_dvl),
    )


def init_state(cfg: EKFLocConfig = EKFLocConfig(), mu0=None, dtype=torch.float32,
               device="cuda") -> EKFLocState:
    mu = (torch.zeros(6, dtype=dtype, device=device) if mu0 is None
          else torch.as_tensor(mu0, dtype=dtype, device=device))
    return EKFLocState(
        mu=mu,
        Sigma=torch.diag(torch.as_tensor(cfg.sigma0_diag, dtype=dtype, device=device)),
        t_prev=torch.zeros((), dtype=dtype, device=device),
    )


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

def meas_model(mu: torch.Tensor, lm: torch.Tensor) -> torch.Tensor:
    """h(μ, lm): landmark position expressed in the base frame."""
    return rotmat_from_rpy(mu[3:6]).T @ (lm - mu[0:3])


def meas_jacobian(mu: torch.Tensor, lm: torch.Tensor) -> torch.Tensor:
    """3×6 ∂h/∂μ, by forward-mode AD of the model."""
    return jacfwd(meas_model, argnums=0)(mu, lm)


def motion_jacobian(rpy: torch.Tensor, disp_base: torch.Tensor) -> torch.Tensor:
    """6×6 G_t: identity position block, ∂(R(rpy)·Δ)/∂rpy coupling, zero
    orientation rows (``ekf_localization.cpp:393-419``)."""
    J = jacfwd(lambda a: rotmat_from_rpy(a) @ disp_base)(rpy)     # (3, 3)
    G = torch.zeros((6, 6), dtype=rpy.dtype, device=rpy.device)
    G[0:3, 0:3] = torch.eye(3, dtype=rpy.dtype, device=rpy.device)
    G[0:3, 3:6] = J
    return G


def predict(
    state: EKFLocState,
    params: EKFLocParams,
    v_dvl: torch.Tensor,     # (3,) DVL body velocity
    q_auv: torch.Tensor,     # (4,) absolute orientation (odom frame)
    t_now: torch.Tensor,
) -> EKFLocState:
    dt = torch.clamp_min(t_now - state.t_prev, 0.0)
    disp_base = params.r_base_dvl @ (v_dvl * dt)
    rpy_t = rpy_from_quat(q_auv)
    disp_odom = rotmat_from_rpy(rpy_t) @ disp_base
    u = torch.cat([disp_odom, wrap_angle(rpy_t - state.mu[3:6])])
    mu_hat = state.mu + u
    mu_hat = torch.cat([mu_hat[0:3], wrap_angle(mu_hat[3:6])])
    G = motion_jacobian(rpy_t, disp_base)
    Sigma_hat = G @ state.Sigma @ G.T + params.R
    return EKFLocState(mu=mu_hat, Sigma=Sigma_hat, t_prev=t_now)


def _landmark_pregate(mu: torch.Tensor, lm: torch.Tensor, epsilon: float) -> torch.Tensor:
    """Reference's landmark narrowing heuristic (``ekf_localization.cpp:508``):
    ε > |(lm_x − μ_x) + (μ_y − lm_y)/tan(wrap(π/2 + ψ))|."""
    t = torch.tan(wrap_angle(math.pi / 2.0 + mu[5]))
    val = (lm[..., 0] - mu[0]) + (mu[1] - lm[..., 1]) / t
    return epsilon > torch.abs(val)


def update_one(
    mu: torch.Tensor,
    Sigma: torch.Tensor,
    z: torch.Tensor,          # (3,) detection in base frame (offset applied)
    z_valid: torch.Tensor,
    params: EKFLocParams,
    cfg: EKFLocConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy-ML association + sequential EKF update for one measurement.

    Returns (mu, Sigma, matched landmark index or -1 (int32))."""
    N = params.map_pos.shape[0]
    Rt = rotmat_from_rpy(mu[3:6]).T                                        # (3,3)
    dRt = jacfwd(lambda a: rotmat_from_rpy(a).T)(mu[3:6])                  # (3,3,3)
    diff = params.map_pos - mu[0:3]                                        # (N,3)
    z_hat = diff @ Rt.T                                                    # (N,3)
    H_ang = torch.einsum("ijk,nj->nik", dRt, diff)                         # (N,3,3)
    H = torch.cat([(-Rt).expand(N, 3, 3), H_ang], dim=2)                   # (N,3,6)
    S = torch.einsum("nij,jk,nlk->nil", H, Sigma, H) + params.Q            # (N,3,3)
    nu = z[None, :] - z_hat                                                # (N,3)
    S_inv, S_det = inv_det_small3(S)
    d_m = torch.einsum("ni,nij,nj->n", nu, S_inv, nu)                      # (N,)
    # ψ = det(π·S)^{-1/2} exp(-d/2)  (π·S normalization quirk preserved)
    psi = torch.exp(-0.5 * d_m) * torch.rsqrt(math.pi ** 3 * torch.clamp_min(S_det, 1e-30))

    ok = (params.map_mask & _landmark_pregate(mu, params.map_pos, cfg.epsilon)
          & (d_m < params.lambda_m) & z_valid)
    best = torch.argmax(torch.where(ok, psi, -math.inf))
    any_ok = torch.any(ok)

    Hb, nub = H[best], nu[best]
    K = Sigma @ Hb.T @ S_inv[best]                                         # Σ Hᵀ S⁻¹
    mu_new = mu + K @ nub
    mu_new = torch.cat([mu_new[0:3], wrap_angle(mu_new[3:6])])
    Sigma_new = (torch.eye(6, dtype=Sigma.dtype, device=Sigma.device) - K @ Hb) @ Sigma

    mu = torch.where(any_ok, mu_new, mu)
    Sigma = torch.where(any_ok, Sigma_new, Sigma)
    matched = torch.where(any_ok, best, -1).to(torch.int32)
    return mu, Sigma, matched


def _stone_offset(cfg: EKFLocConfig, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor([0.0, cfg.stone_offset, cfg.stone_offset], dtype=like.dtype,
                        device=like.device)


def step(
    cfg: EKFLocConfig,
    params: EKFLocParams,
    state: EKFLocState,
    tick,
) -> Tuple[EKFLocState, dict]:
    """One filter tick (``ekfLocalize``, ``ekf_localization.cpp:547-624``)."""
    imu = tick.channels["imu"]
    dvlw = tick.windows["dvl"]
    det = tick.events["mbes_detections"]
    t_now = tick.ticks

    # DVL: synced-latest or Bézier window extrapolation when stale
    newest = dvlw.stamp[-1]
    stale = (t_now - newest) > (0.5 / cfg.system_freq)
    v = torch.where(stale, bezier.bezier_interpolate(dvlw.value, dvlw.stamp, t_now),
                    dvlw.value[-1])

    pred = predict(state, params, v, imu.value[0:4], t_now)

    # stone-volume compensation on raw detections (ekf_localization.cpp:489-492)
    z_all = det.value - _stone_offset(cfg, det.value)
    mu, Sigma = pred.mu, pred.Sigma
    matches = []
    for m in range(z_all.shape[0]):
        mu, Sigma, matched = update_one(mu, Sigma, z_all[m], det.mask[m], params, cfg)
        matches.append(matched)
    matches = torch.stack(matches)

    # gate: without IMU+DVL contact the reference re-broadcasts the last pose
    have = imu.valid & (dvlw.count > 0)
    new_state = EKFLocState(
        mu=torch.where(have, mu, state.mu),
        Sigma=torch.where(have, Sigma, state.Sigma),
        t_prev=torch.where(have, t_now, state.t_prev),
    )
    out = {
        "mu": new_state.mu,
        "sigma_diag": torch.diagonal(new_state.Sigma),
        "matches": matches,
        "num_matched": torch.sum(matches >= 0).to(torch.int32),
    }
    return new_state, out


def run(
    timeline,
    params: EKFLocParams,
    cfg: EKFLocConfig = EKFLocConfig(),
    state0: EKFLocState | None = None,
):
    """Replay one mission (tensor-leaved Timeline) -> (final state, outputs
    stacked over ticks)."""
    s0 = (init_state(cfg, dtype=params.R.dtype, device=timeline.ticks.device)
          if state0 is None else state0)
    state, outs = s0, []
    for k in range(timeline.num_ticks):
        state, out = step(cfg, params, state, timeline.slice_tick(k))
        outs.append(out)
    return state, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def stage_fleet(batched_timeline, params: EKFLocParams, cfg: EKFLocConfig = EKFLocConfig()):
    """Every per-tick scalar of a fleet replay staged over (B, T) in f32 (IMU
    rpy, DVL staleness and Bézier window, the have-contact history and dt,
    the stone offset), packed as K9 reads it -> (tick (T, B, 8), z (T, B,
    M, 4), map (N, 4), par (16,), last contact time (B, T))."""
    tl = batched_timeline
    B, T = tl.ticks.shape
    f32 = torch.float32
    dev = tl.ticks.device
    imu = tl.channels["imu"]
    dvlw = tl.windows["dvl"]
    det = tl.events["mbes_detections"]
    ticks = tl.ticks.to(f32)
    stamps = dvlw.stamp.to(f32)
    dvl_v = dvlw.value.to(f32)

    rpy_t = rpy_from_quat(imu.value[..., 0:4].to(f32))
    stale = (ticks - stamps[..., -1]) > (0.5 / cfg.system_freq)
    v_b = bezier.bezier_interpolate(dvl_v, stamps, ticks)
    v = torch.where(stale[..., None], v_b, dvl_v[..., -1, :])
    have = imu.valid & (dvlw.count > 0)
    lf = torch.cummax(torch.where(have, ticks, 0.0), dim=1).values
    t_prev = torch.cat([torch.zeros((B, 1), dtype=f32, device=dev), lf[:, :-1]], dim=1)
    dt = torch.clamp_min(ticks - t_prev, 0.0)
    disp_base = (v * dt[..., None]) @ params.r_base_dvl.to(f32).T
    z_all = det.value.to(f32) - _stone_offset(cfg, det.value.to(f32))

    tick_t = torch.cat([rpy_t, disp_base, have.to(f32)[..., None],
                        torch.zeros((B, T, 1), dtype=f32, device=dev)], 2)
    z_t = torch.cat([z_all, det.mask.to(f32)[..., None]], 3)
    map4, par = loc_kernels.pack_params(
        params.map_pos, params.map_mask, torch.diagonal(params.Q).to(f32),
        torch.diagonal(params.R).to(f32), params.lambda_m, cfg.epsilon)
    return (tick_t.transpose(0, 1).contiguous(), z_t.transpose(0, 1).contiguous(),
            map4, par, lf)


def run_fleet(
    batched_timeline,
    params: EKFLocParams,
    cfg: EKFLocConfig = EKFLocConfig(),
    graph: bool = True,
):
    """Whole-fleet replay: the per-tick inputs staged over (B, T)
    (``stage_fleet``), then exactly one K9 launch per tick
    (``loc_kernels.run_ticks``; on CUDA tensors a cached CUDA graph of the
    tick loop unless ``graph=False``).

    Returns (final batched state, out) with out like ``run``'s with a
    mission axis: mu (T, B, 6), sigma_diag (T, B, 6), matches (T, B, M)
    int32, num_matched (T, B)."""
    B = batched_timeline.ticks.shape[0]
    tick_t, z_t, map4, par, lf = stage_fleet(batched_timeline, params, cfg)
    s0 = init_state(cfg, device=tick_t.device)
    mu0 = s0.mu.expand(B, 6).contiguous()
    sig0 = s0.Sigma.reshape(36).expand(B, 36).contiguous()
    mu_t, sigd_t, match_t, sig_f = loc_kernels.run_ticks(mu0, sig0, tick_t, z_t, map4, par,
                                                         graph=graph)
    out = {
        "mu": mu_t,
        "sigma_diag": sigd_t,
        "matches": match_t,
        "num_matched": torch.sum(match_t >= 0, dim=2).to(torch.int32),
    }
    final = EKFLocState(mu=mu_t[-1], Sigma=sig_f.reshape(B, 6, 6), t_prev=lf[:, -1])
    return final, out


def loc_timeline(mission, cfg: EKFLocConfig = EKFLocConfig()):
    """Timeline for the localization filter from a simulated mission (numpy
    leaves; bit for bit the reference's)."""
    s = mission.streams
    det = s["mbes_detections"]
    return build_timeline(
        t0=0.0,
        t1=mission.spec.duration_s,
        freq_hz=cfg.system_freq,
        channels={"imu": (s["imu"]["stamps"], s["imu"]["values"])},
        windows={"dvl": (s["dvl"]["stamps"], s["dvl"]["values"], cfg.dvl_window)},
        events={
            "mbes_detections": (det["stamps"], det["values"], det["burst"], cfg.max_obs)
        },
    )
