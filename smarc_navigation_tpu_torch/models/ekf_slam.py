"""Online EKF-SLAM with MBES / FLS landmark detections (PyTorch port of
``smarc_navigation_tpu/models/ekf_slam.py``).

The state is a fixed-size padded bank of ``max_landmarks`` 3-DOF slots with
an ``active`` mask (landmark "addition" is a slot activation), exactly as
in the reference; see its module docstring for the mapping onto the ROS
``auv_ekf_slam`` node. Public functions keep the reference's argument order
and shapes. The fleet replay ``run_fleet`` is a Python loop over ticks whose
every event pass runs the data-association kernel (K1,
``ops.slam_da_kernels.da_lanes``) and the sequential-update kernel (K2,
``ops.slam_kernels.sequential_update_fleet``, on its streamed schedule:
phase 1 + the tiled downdate K12); ``step``'s kernel branch runs K3
(``ops.slam_kernels.sequential_update``, on the same schedule).
``run_fleet_compact`` runs the same event pass on event ticks only, with
the predicts in between composed beforehand. ``run_fleet(update_mode="marginal")`` is the reference's own
9×9 marginal writeback on a pose-rows + band carry (``run_fleet_marginal``:
K1 in its pose-rows form, then K4,
``ops.slam_kernels.sequential_update_marginal_fleet``). Each wrapper
launches its CUDA kernel for CUDA tensors and takes its plain PyTorch
version for CPU tensors.

Mission sharding (``run_fleet(device_mesh=...)``): the missions split over
the mesh's ``mission`` axis, and each mission shard replays its missions
on the first device of its mesh row (graphed on the card), once: the
reference's copies along the particle axis compute the same values. The
outputs are joined on the caller's device, bitwise the unsharded replay's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import jacfwd, vmap

from ..configs import EKFSlamConfig
from ..ops import assignment, slam_da_kernels, slam_kernels
from ..ops.timeline import build_timeline
from ..parallel import mesh as mesh_lib
from ..utils import graphs, trace
from ..utils.geometry import Transform, rotmat_from_rpy, rpy_from_quat, wrap_angle
from ..utils.linalg import chi2_quantile, inv_small



class SlamParams(NamedTuple):
    R: torch.Tensor            # (6,6) motion noise
    Q_mbes: torch.Tensor       # (3,3)
    Q_fls: torch.Tensor        # (2,2)
    lambda_mbes: torch.Tensor  # χ²(δ,3) gate
    lambda_fls: torch.Tensor   # χ²(δ,2) gate
    r_fls_base: torch.Tensor   # (3,3) base->fls rotation
    t_fls_base: torch.Tensor   # (3,) base->fls translation


class SlamState(NamedTuple):
    mu: torch.Tensor           # (6 + 3L,)
    Sigma: torch.Tensor        # (6+3L, 6+3L)
    active: torch.Tensor       # (L,) bool
    n_active: torch.Tensor     # int32
    mu_auv_odom: torch.Tensor  # (3,) accumulated odom position


def make_params(
    cfg: EKFSlamConfig = EKFSlamConfig(),
    tf_base_fls: Transform | None = None,
    dtype=torch.float32,
    device="cuda",
) -> SlamParams:
    if tf_base_fls is None:
        tf_base_fls = Transform.identity(dtype, device)
    tf_base_fls = Transform(*(torch.as_tensor(x, dtype=dtype, device=device)
                              for x in tf_base_fls))
    tf_fls_base = tf_base_fls.inverse()

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    return SlamParams(
        R=torch.diag(t(cfg.r_diag)),
        Q_mbes=torch.diag(t(cfg.q_mbes_diag)),
        Q_fls=torch.diag(t(cfg.q_fls_diag)),
        lambda_mbes=t(chi2_quantile(cfg.delta_outlier_reject, 3)),
        lambda_fls=t(chi2_quantile(cfg.delta_outlier_reject, 2)),
        r_fls_base=tf_fls_base.rot.contiguous(),
        t_fls_base=tf_fls_base.trans.contiguous(),
    )


def init_state(
    cfg: EKFSlamConfig = EKFSlamConfig(),
    mu0=None,
    beacons: np.ndarray | None = None,
    dtype=torch.float32,
    device="cuda",
) -> SlamState:
    """Initial state; ``beacons`` pre-activates known-map landmark slots with
    the beacon prior covariance (``ekf_slam.cpp:141-175``)."""
    L = cfg.max_landmarks
    D = 6 + 3 * L
    mu = torch.zeros(D, dtype=dtype, device=device)
    if mu0 is not None:
        mu[0:6] = torch.as_tensor(mu0, dtype=dtype, device=device)
    Sigma = torch.zeros((D, D), dtype=dtype, device=device)
    Sigma[0:6, 0:6] = torch.diag(torch.as_tensor(cfg.sigma0_diag, dtype=dtype, device=device))
    active = torch.zeros(L, dtype=torch.bool, device=device)
    n = 0
    if beacons is not None and len(beacons):
        n = min(len(beacons), L)
        mu[6:6 + 3 * n] = torch.as_tensor(
            np.asarray(beacons)[:n].reshape(-1), dtype=dtype, device=device)
        bc = torch.as_tensor(cfg.beacon_cov, dtype=dtype, device=device)
        for k in range(n):
            Sigma[6 + 3 * k:9 + 3 * k, 6 + 3 * k:9 + 3 * k] = torch.diag(bc)
        active[:n] = True
    return SlamState(
        mu=mu,
        Sigma=Sigma,
        active=active,
        n_active=torch.tensor(n, dtype=torch.int32, device=device),
        mu_auv_odom=torch.zeros(3, dtype=dtype, device=device),
    )


# ---------------------------------------------------------------------------
# motion predict
# ---------------------------------------------------------------------------

def _motion_jacobian(att: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """g = ∂(R(att) u)/∂att, (..., 3, 3) — the closed-form derivative the
    reference takes with jacfwd (columns: roll, pitch, yaw)."""
    r, p, y = att[..., 0], att[..., 1], att[..., 2]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    zero = torch.zeros_like(r)
    dR = torch.stack([
        torch.stack([zero, cy * sp * cr + sy * sr, -cy * sp * sr + sy * cr,
                     zero, sy * sp * cr - cy * sr, -sy * sp * sr - cy * cr,
                     zero, cp * cr, -cp * sr], -1),
        torch.stack([-cy * sp, cy * cp * sr, cy * cp * cr,
                     -sy * sp, sy * cp * sr, sy * cp * cr,
                     -cp, -sp * sr, -sp * cr], -1),
        torch.stack([-sy * cp, -sy * sp * sr - cy * cr, -sy * sp * cr + cy * sr,
                     cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
                     zero, zero, zero], -1),
    ], -2).reshape(att.shape[:-1] + (3, 3, 3))          # [..., k, i, j]
    return torch.einsum("...kij,...j->...ik", dR, u)


def predict(state: SlamState, odom_pose: torch.Tensor, params: SlamParams) -> SlamState:
    """Consume one absolute odometry pose (``ekf_slam_core.cpp:41-121``)."""
    u_t = odom_pose[0:3] - state.mu_auv_odom
    mu = torch.cat([state.mu[0:3] + u_t, wrap_angle(odom_pose[3:6]), state.mu[6:]])

    g = _motion_jacobian(mu[3:6], u_t)                   # (3,3)
    # G = I except: G[0:3,3:6] = g, G[3:6,3:6] = 0 (absolute attitude)
    A = torch.zeros((6, 6), dtype=mu.dtype, device=mu.device)
    A[0:3, 0:3] = torch.eye(3, dtype=mu.dtype, device=mu.device)
    A[0:3, 3:6] = g

    S = state.Sigma
    S11 = A @ S[0:6, 0:6] @ A.T + params.R
    S1L = A @ S[0:6, 6:]
    Sigma = S.clone()
    Sigma[0:6, 0:6] = S11
    Sigma[0:6, 6:] = S1L
    Sigma[6:, 0:6] = S1L.T
    return SlamState(mu=mu, Sigma=Sigma, active=state.active,
                     n_active=state.n_active, mu_auv_odom=state.mu_auv_odom + u_t)


# ---------------------------------------------------------------------------
# sensor models
# ---------------------------------------------------------------------------

def h_mbes(pose6: torch.Tensor, lm: torch.Tensor, params: SlamParams) -> torch.Tensor:
    """Landmark in base frame (3,)."""
    return rotmat_from_rpy(pose6[3:6]).T @ (lm - pose6[0:3])


def backproject_mbes(z: torch.Tensor, pose6: torch.Tensor, params: SlamParams) -> torch.Tensor:
    return rotmat_from_rpy(pose6[3:6]) @ z[0:3] + pose6[0:3]


def h_fls(pose6: torch.Tensor, lm: torch.Tensor, params: SlamParams) -> torch.Tensor:
    """Pixel-space FLS measurement (2,): scaling·(‖(x,z)‖, −y) of the
    landmark in the FLS frame."""
    scale = 400.0 / 17.0
    v = params.r_fls_base @ h_mbes(pose6, lm, params) + params.t_fls_base
    # eps as a tensor: a 0-d tensor + Python float promotes to float64
    # under torch.func.jacfwd
    rho = torch.sqrt(v[0] ** 2 + v[2] ** 2 + v.new_tensor(1e-12))
    return scale * torch.stack([rho, -v[1]])


def backproject_fls(z: torch.Tensor, pose6: torch.Tensor, params: SlamParams) -> torch.Tensor:
    """Pixels -> polar -> metres in FLS plane -> map frame
    (``correspondence_obj_fls.cpp:44-58``)."""
    scale_inv = 17.0 / 400.0
    x, y = z[0], -z[1]
    theta = torch.atan2(y, x)
    rho = scale_inv * torch.sqrt(x * x + y * y)
    p_fls = torch.stack([rho * torch.cos(theta), rho * torch.sin(theta), torch.zeros_like(rho)])
    p_base = params.r_fls_base.T @ (p_fls - params.t_fls_base)
    return rotmat_from_rpy(pose6[3:6]) @ p_base + pose6[0:3]


@dataclasses.dataclass(frozen=True)
class SensorSpec:
    """Static per-sensor dispatch (MBES / FLS)."""

    h: Callable          # (pose6, lm, params) -> (dim,)
    backproject: Callable
    dim: int
    q: Callable          # params -> (dim,dim)
    lam: Callable        # params -> scalar
    new_lm_cov: Tuple[float, ...]
    mh_dist: Callable    # cfg -> float
    kind: str            # kernel sensor form


MBES = SensorSpec(
    h=h_mbes, backproject=backproject_mbes, dim=3,
    q=lambda p: p.Q_mbes, lam=lambda p: p.lambda_mbes,
    new_lm_cov=(100.0, 100.0, 100.0), mh_dist=lambda c: c.mhl_dist_mbes,
    kind="mbes",
)

FLS = SensorSpec(
    h=h_fls, backproject=backproject_fls, dim=2,
    q=lambda p: p.Q_fls, lam=lambda p: p.lambda_fls,
    new_lm_cov=(400.0, 200.0, 1000.0), mh_dist=lambda c: c.mhl_dist_fls,
    kind="fls",
)


# ---------------------------------------------------------------------------
# data association + sequential update (one sensor pass)
# ---------------------------------------------------------------------------

def _da_core(pose, lm_all, active, Spp, Spl, Sll, z, z_mask, sensor, params,
             Q, lam, outlier, mh_dist, new_lm_cov):
    """da_stage on the three Σ slabs it reads (one mission; vmappable):
    Spp (6,6), Spl (L,6,3) = Σ[0:6, slot], Sll (L,3,3) block diagonal."""
    dim = sensor.dim
    z_d = z[:, :dim]

    def h(p6, lm):
        return sensor.h(p6, lm, params)

    def corr(lm):
        zh = h(pose, lm)
        Hp = jacfwd(lambda p6: h(p6, lm))(pose)                      # (dim,6)
        Hl = jacfwd(lambda l3: h(pose, l3))(lm)                      # (dim,3)
        return zh, torch.cat([Hp, Hl], dim=1)                        # (dim,9)

    z_hat, H = vmap(corr)(lm_all)                                    # (L,dim),(L,dim,9)
    Hp_, Hl_ = H[:, :, 0:6], H[:, :, 6:9]
    S = (
        torch.einsum("ldi,ij,lej->lde", Hp_, Spp, Hp_)
        + torch.einsum("ldi,lik,lek->lde", Hp_, Spl, Hl_)
        + torch.einsum("ldk,lik,lei->lde", Hl_, Spl, Hp_)
        + torch.einsum("ldi,lik,lek->lde", Hl_, Sll, Hl_)
        + Q
    )
    S_inv = inv_small(S)
    nu = z_d[None, :, :] - z_hat[:, None, :]                          # (L,M,dim)
    d_m = torch.einsum("lmi,lij,lmj->lm", nu, S_inv, nu)              # (L,M)

    cand = vmap(lambda zi: sensor.backproject(zi, pose, params))(z)   # (M,3)
    zero63 = torch.zeros((6, 3), dtype=Spp.dtype, device=Spp.device)
    Sig9c = torch.cat([torch.cat([Spp, zero63], 1),
                       torch.cat([zero63.T, torch.diag(new_lm_cov)], 1)], 0)

    def cand_corr(c, zi):
        zh = h(pose, c)
        Hp = jacfwd(lambda p6: h(p6, c))(pose)
        Hl = jacfwd(lambda l3: h(pose, l3))(c)
        Hc = torch.cat([Hp, Hl], dim=1)
        Sc = Hc @ Sig9c @ Hc.T + Q
        return Hc, inv_small(Sc), zi[:dim] - zh

    H_cand, S_inv_cand, nu_cand = vmap(cand_corr)(cand, z)            # (M,...)

    M = z.shape[0]
    f32 = d_m.dtype
    gate = (d_m < lam) & active[:, None] & z_mask[None, :]
    # outlier and mh_dist: Python floats, or 0-d tensors (the fleet loops')
    out_c = torch.as_tensor(outlier, dtype=f32, device=d_m.device)
    cost_known = torch.where(gate, d_m, out_c)                         # (L,M)
    eye = torch.eye(M, dtype=torch.bool, device=d_m.device)
    cost_cand = torch.where(eye, torch.as_tensor(mh_dist, dtype=f32, device=d_m.device), out_c)
    cost = torch.cat([cost_known, cost_cand], dim=0)                   # (L+M,M)
    return cost, (H, S_inv, nu, cand, H_cand, S_inv_cand, nu_cand)


def _slabs(Sigma: torch.Tensor, L: int):
    """(Spp, Spl, Sll) of a (..., D, D) covariance."""
    lead = Sigma.shape[:-2]
    Spp = Sigma[..., 0:6, 0:6]
    Spl = Sigma[..., 0:6, 6:].reshape(lead + (6, L, 3)).movedim(-2, -3)   # (..., L,6,3)
    Sll = torch.diagonal(Sigma[..., 6:, 6:].reshape(lead + (L, 3, L, 3)),
                         dim1=-4, dim2=-2).movedim(-1, -3)               # (..., L,3,3)
    return Spp, Spl, Sll


def da_stage(
    state: SlamState,
    z: torch.Tensor,        # (M, 3) detections (FLS uses [:, :2])
    z_mask: torch.Tensor,   # (M,)
    params: SlamParams,
    cfg: EKFSlamConfig,
    sensor: SensorSpec,
):
    """Pre-solver half of the DA pass: batch correspondence (h, H at the
    pre-update μ̂, Jacobians by ``torch.func.jacfwd`` of the sensor model),
    back-projected candidates and the (L+M, M) cost table."""
    L = cfg.max_landmarks
    mu = state.mu
    Spp, Spl, Sll = _slabs(state.Sigma, L)
    dt = mu.dtype
    return _da_core(
        mu[0:6], mu[6:].reshape(L, 3), state.active, Spp, Spl, Sll, z, z_mask,
        sensor, params, sensor.q(params), sensor.lam(params), cfg.outlier_cost,
        sensor.mh_dist(cfg),
        torch.tensor(sensor.new_lm_cov, dtype=dt, device=mu.device))


def data_associate_update(
    state: SlamState,
    z: torch.Tensor,
    z_mask: torch.Tensor,
    params: SlamParams,
    cfg: EKFSlamConfig,
    sensor: SensorSpec,
    solver: str = "device",
    update_mode: str = "auto",
) -> Tuple[SlamState, torch.Tensor]:
    """One batch-DA + sequential-update pass. Returns (state, matched).

    ``solver``: ``"device"`` solves the assignment with the exact torch JV
    (``assignment.hungarian``); any other value on the host with scipy
    (``assignment.hungarian_host``), as the reference's host solver."""
    with trace.span("slam.da_stage"):
        cost, staged = da_stage(state, z, z_mask, params, cfg, sensor)
    with trace.span("slam.jv"):
        if solver == "device":
            col_to_row = assignment.hungarian(cost)
        else:
            col_to_row = assignment.hungarian_host(cost)
    with trace.span("slam.commit"):
        return da_commit(state, col_to_row, staged, z, z_mask, params, cfg,
                         sensor, update_mode)


def select_updates(col_to_row, z_mask, n_active, L: int):
    """Slots and activations for a whole pass at once (the reference's
    kernel-branch prologue): capacity denials are monotone — once the bank
    is full it stays full — so the running-count check is an exclusive
    cumsum. Works on (M,) or (B, M) with n_active () or (B,).
    Returns (is_new, r_clip, do, add, slot)."""
    is_new = col_to_row >= L
    r_clip = torch.clamp(col_to_row, 0, L - 1)
    adds = z_mask & is_new
    n = n_active[..., None] if n_active.dim() else n_active
    ai = adds.to(torch.int32)
    cum_excl = torch.cumsum(ai, dim=-1, dtype=torch.int32) - ai
    can_add = adds & (n + cum_excl < L)
    do = z_mask & (can_add | ~is_new)
    ci = can_add.to(torch.int32)
    new_slot = n + torch.cumsum(ci, dim=-1, dtype=torch.int32) - ci
    slot = torch.where(is_new, new_slot, r_clip).to(torch.int32)
    return is_new, r_clip, do, can_add, slot


def da_commit(
    state: SlamState,
    col_to_row: torch.Tensor,
    staged,
    z: torch.Tensor,
    z_mask: torch.Tensor,
    params: SlamParams,
    cfg: EKFSlamConfig,
    sensor: SensorSpec,
    update_mode: str = "auto",
) -> Tuple[SlamState, torch.Tensor]:
    """Post-solver half of the DA pass: landmark adds + sequential update.

    ``update_mode``: ``"full"`` — the dense in-place full-covariance
    sequence (the reference's ``upd_dense``); ``"kernel"`` — slots and
    activations precomputed for the whole pass, then the update-loop kernel
    (K3, ``ops.slam_kernels.sequential_update``; its plain version on the
    CPU); ``"marginal"`` — the reference's own semantics
    (``ekf_slam_core.cpp:351-371``): each update writes back only the 9×9
    (pose, matched landmark) marginal and leaves the other
    cross-covariances as they are (the reference's ``upd2``); ``"auto"`` —
    ``"kernel"`` for CUDA state, ``"full"`` elsewhere; ``"pallas"`` — the
    reference's name of ``"kernel"``. An unknown mode raises (the reference
    runs it as ``"full"``)."""
    L = cfg.max_landmarks
    if update_mode == "auto":
        update_mode = "kernel" if state.mu.is_cuda else "full"
    if update_mode == "pallas":
        update_mode = "kernel"
    if update_mode not in ("full", "kernel", "marginal"):
        raise ValueError(f"unknown update_mode {update_mode!r}")
    mu, Sigma = state.mu, state.Sigma
    M = z.shape[0]
    dt, dev = mu.dtype, mu.device
    D = mu.shape[0]
    new_cov = torch.tensor(sensor.new_lm_cov, dtype=dt, device=dev)
    (H, S_inv, nu, cand, H_cand, S_inv_cand, nu_cand) = staged
    col_to_row = col_to_row.to(torch.int32)

    if update_mode == "kernel":
        is_new, r_clip, do, can_add, slot = select_updates(
            col_to_row, z_mask, state.n_active, L)
        lm_ix = (6 + 3 * slot).to(torch.int32)
        # candidate positions pre-written (their Σ rows are zero until the
        # in-kernel activation, so earlier updates cannot touch them)
        ar3 = torch.arange(3, device=dev)
        tgt = torch.where(can_add[:, None], lm_ix[:, None] + ar3, D).reshape(-1)
        mu = torch.cat([mu, mu.new_zeros(1)]).index_put(
            (tgt,), cand.to(dt).reshape(-1))[:D]
        active = torch.cat([state.active, state.active.new_zeros(1)]).index_put(
            (torch.where(can_add, slot, L).long(),),
            torch.tensor(True, device=dev))[:L]
        n_active = state.n_active + can_add.sum(dtype=torch.int32)

        rc = r_clip.long()
        H_sel = torch.where(is_new[:, None, None], H_cand, H[rc])
        Sinv_sel = torch.where(is_new[:, None, None], S_inv_cand, S_inv[rc])
        nu_sel = torch.where(is_new[:, None], nu_cand, nu[rc, torch.arange(M, device=dev)])
        SinvH = torch.einsum("mij,mjk->mik", Sinv_sel, H_sel)
        Sigma, mu = slam_kernels.sequential_update(
            Sigma.contiguous(), mu.contiguous(), H_sel.contiguous(),
            SinvH.contiguous(), nu_sel.contiguous(), lm_ix, do, can_add, new_cov)
        matched = torch.where(do, slot, torch.full_like(slot, -1))
        return SlamState(mu=mu, Sigma=Sigma, active=active, n_active=n_active,
                         mu_auv_odom=state.mu_auv_odom), matched

    # the sequence in measurement order: the dense full update (upd_dense) or
    # the reference's 9×9 marginal writeback (upd2)
    marginal = update_mode == "marginal"
    active, n_active = state.active, state.n_active
    ar3 = torch.arange(3, device=dev)
    pose_ix = torch.arange(6, device=dev)
    eye9 = torch.eye(9, dtype=dt, device=dev)
    matched = []
    for m in range(M):
        r = col_to_row[m]
        is_new = r >= L
        r_clip = torch.clamp(r, 0, L - 1).long()
        can_add = is_new & (n_active < L)
        do = z_mask[m] & (can_add | ~is_new)
        slot = torch.where(is_new, n_active, r_clip.to(torch.int32))
        # a denied add points past the bank (do is False there): clamp the
        # index so the discarded branch stays in range
        slot_c = torch.clamp(slot, max=L - 1).long()
        idx3 = 6 + 3 * slot_c + ar3

        add = do & is_new
        mu = torch.where(add, mu.index_put((idx3,), cand[m].to(dt)), mu)
        # the full path's inactive rows/cols are zero by invariant (diag set ==
        # add); the marginal path zeroes the slot's rows and columns first
        S_add = Sigma.index_fill(0, idx3, 0.0).index_fill(1, idx3, 0.0) if marginal else Sigma
        Sigma = torch.where(add, S_add.index_put((idx3[:, None], idx3[None, :]),
                                                 torch.diag(new_cov)), Sigma)
        active = torch.where(add, active.index_put((slot_c,),
                                                   torch.tensor(True, device=dev)), active)
        n_active = torch.where(add, n_active + 1, n_active)

        H_i = torch.where(is_new, H_cand[m], H[r_clip])
        Sinv_i = torch.where(is_new, S_inv_cand[m], S_inv[r_clip])
        nu_i = torch.where(is_new, nu_cand[m], nu[r_clip, m])

        if marginal:   # Σ9' = (I − K H) Σ9, K = Σ9 Hᵀ S⁻¹, written back alone
            idx9 = torch.cat([pose_ix, idx3])
            Sig9 = Sigma[idx9[:, None], idx9[None, :]]
            K = Sig9 @ H_i.T @ Sinv_i                                  # (9,dim)
            delta = K @ nu_i
            mu_new = mu.clone()
            mu_new[0:6] = mu_new[0:6] + delta[0:6]
            mu_new[3:6] = wrap_angle(mu_new[3:6])
            mu_new[idx3] = mu_new[idx3] + delta[6:9]
            Sigma_new = Sigma.index_put((idx9[:, None], idx9[None, :]),
                                        (eye9 - K @ H_i) @ Sig9)
        else:
            rows = torch.cat([Sigma[0:6, :], Sigma[idx3, :]], dim=0)  # (9,D)
            Kt = (Sinv_i @ H_i) @ rows                                 # (dim,D)
            mu_new = mu + nu_i @ Kt
            mu_new = torch.cat([mu_new[0:3], wrap_angle(mu_new[3:6]), mu_new[6:]])
            Vt = H_i @ rows                                            # (dim,D)
            Sigma_new = Sigma - Kt.T @ Vt
            Sigma_new = 0.5 * (Sigma_new + Sigma_new.T)

        mu = torch.where(do, mu_new, mu)
        Sigma = torch.where(do, Sigma_new, Sigma)
        matched.append(torch.where(do, slot, torch.full_like(slot, -1)))
    return SlamState(mu=mu, Sigma=Sigma, active=active, n_active=n_active,
                     mu_auv_odom=state.mu_auv_odom), torch.stack(matched)


# ---------------------------------------------------------------------------
# full tick + replay
# ---------------------------------------------------------------------------

def _odom_pose(value: torch.Tensor) -> torch.Tensor:
    """6-dim pose track, or the 13-dim nav_msgs-style [pos3, quat4, linvel3,
    angvel3] layout converted to [pos3, rpy3]."""
    if value.shape[-1] >= 13:
        return torch.cat([value[..., 0:3], rpy_from_quat(value[..., 3:7])], dim=-1)
    return value[..., 0:6]


def step(
    cfg: EKFSlamConfig,
    params: SlamParams,
    state: SlamState,
    tick,
    solver: str = "device",
    update_mode: str = "auto",
):
    """One SLAM tick (``ekf_slam.cpp:296-350``): consume latest odometry,
    then run a DA pass per sensor whose burst is non-empty (a host-side
    branch: one sync per sensor per tick)."""
    with trace.span("slam.step"):
        odom = tick.channels["odom"]
        with trace.span("slam.predict"):
            pred = predict(state, _odom_pose(odom.value), params)

        def run_pass(st, ev, sensor):
            if bool(ev.mask.any()):
                return data_associate_update(st, ev.value, ev.mask, params, cfg,
                                             sensor, solver, update_mode)
            return st, torch.full(ev.mask.shape, -1, dtype=torch.int32,
                                  device=ev.mask.device)

        st = pred
        matched_mbes = matched_fls = None
        if "mbes" in tick.events:
            st, matched_mbes = run_pass(st, tick.events["mbes"], MBES)
        if "fls" in tick.events:
            st, matched_fls = run_pass(st, tick.events["fls"], FLS)

        # gate: without odometry the reference rebroadcasts the last pose
        st = SlamState(*(torch.where(odom.valid, new, old) for new, old in zip(st, state)))
        out = {
            "mu": st.mu[0:6],
            "sigma_diag6": torch.diagonal(st.Sigma[0:6, 0:6]),
            "n_active": st.n_active,
        }
        if matched_mbes is not None:
            out["matched_mbes"] = matched_mbes
        if matched_fls is not None:
            out["matched_fls"] = matched_fls
        return st, out


def _stack_outputs(outs: list) -> dict:
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def run(
    timeline,
    params: SlamParams,
    cfg: EKFSlamConfig = EKFSlamConfig(),
    state0: SlamState | None = None,
    solver: str = "device",
    update_mode: str = "auto",
):
    """Single-mission replay over a tensor-leaved Timeline -> (final state,
    outputs stacked over ticks)."""
    s0 = init_state(cfg, device=timeline.ticks.device) if state0 is None else state0
    state, outs = s0, []
    for k in range(timeline.num_ticks):
        state, out = step(cfg, params, state, timeline.slice_tick(k), solver, update_mode)
        outs.append(out)
    return state, _stack_outputs(outs)


def initial_band(Sigma0: torch.Tensor, L: int) -> torch.Tensor:
    """(..., 24, L) landmark block-diag band of a covariance: row a*8+d holds
    Σ[6+3l+a, 6+3l+a+d] for d = 0..2 (the index clamped to D-1); rows with
    d >= 3 are zero. Only entries with a+d <= 2 are ever consumed."""
    D = Sigma0.shape[-1]
    la = 6 + 3 * torch.arange(L, device=Sigma0.device)
    band = Sigma0.new_zeros(Sigma0.shape[:-2] + (24, L))
    for a in range(3):
        for d in range(3):
            band[..., a * 8 + d, :] = Sigma0[..., la + a, torch.clamp(la + a + d, max=D - 1)]
    return band


class PassConsts(NamedTuple):
    """A DA pass's constants as tensors, made once per replay, never per
    tick (a tensor built from host data inside a tick cannot be captured in
    a CUDA graph)."""
    new_cov: torch.Tensor   # (3,) the sensor's new-landmark covariance
    q_diag: torch.Tensor    # (dim,)
    lam: torch.Tensor       # 0-d χ² gate
    outlier: torch.Tensor   # 0-d
    mh_dist: torch.Tensor   # 0-d


def pass_consts(params: SlamParams, cfg: EKFSlamConfig, sensor: SensorSpec) -> PassConsts:
    dt, dev = params.R.dtype, params.R.device
    return PassConsts(new_cov=torch.tensor(sensor.new_lm_cov, dtype=dt, device=dev),
                      q_diag=torch.diagonal(sensor.q(params)), lam=sensor.lam(params),
                      outlier=torch.full((), cfg.outlier_cost, dtype=dt, device=dev),
                      mh_dist=torch.full((), sensor.mh_dist(cfg), dtype=dt, device=dev))


def da_lanes_pass(state_b: SlamState, z_b, mask_b, params: SlamParams,
                  cfg: EKFSlamConfig, sensor: SensorSpec = None,
                  a8=None, valid=None, band=None, consts: PassConsts = None,
                  streamed: bool = True):
    """Fleet DA pass (MBES or FLS): DA kernel (K1) + fleet update kernel
    (K2). state_b is a batched SlamState; z_b (B, M, 3), mask_b (B, M).
    ``valid`` is accepted and ignored, as in the reference (the odometry
    gate is folded into ``a8``).

    With ``a8`` given (see ``_fleet_predict``), state_b.Sigma is the RAW
    (pre-predict) covariance and both kernels apply the motion predict to
    what they read. With ``band`` (B, 24, L) given, K1 reads the landmark
    block diagonal from it and K2 returns the new band as a third element.
    ``consts`` (``pass_consts``) is made here when not given; ``streamed``
    is K2's schedule (``streamed=False``: the one-kernel schedule)."""
    sensor = MBES if sensor is None else sensor
    c = pass_consts(params, cfg, sensor) if consts is None else consts
    B = state_b.mu.shape[0]
    L = cfg.max_landmarks
    r_sb = params.r_fls_base if sensor.kind == "fls" else None
    t_sb = params.t_fls_base if sensor.kind == "fls" else None
    A = a8[:, 0:6, 0:6].contiguous() if a8 is not None else None
    r_full = a8[:, 0:6, 8:14].contiguous() if a8 is not None else None
    ctr, H_sel, SinvH, nu_sel, cand, do, add, slot = slam_da_kernels.da_lanes(
        state_b.mu[:, 0:6].contiguous(), state_b.n_active, state_b.active,
        state_b.mu[:, 6:].reshape(B, L, 3).contiguous(), state_b.Sigma,
        z_b[:, :, 0:3].contiguous(), mask_b.contiguous(),
        c.q_diag, c.lam, c.outlier, c.mh_dist, c.new_cov,
        sensor=sensor.kind, r_sb=r_sb, t_sb=t_sb, A=A, r_full=r_full, band=band,
    )
    lm_ix = 6 + 3 * slot
    active = torch.cat([state_b.active, state_b.active.new_zeros(B, 1)], 1).scatter(
        1, torch.where(add, slot, L).long(), True)[:, :L].contiguous()
    n_active = state_b.n_active + add.sum(1, dtype=torch.int32)
    upd = slam_kernels.sequential_update_fleet(
        state_b.Sigma, state_b.mu, H_sel, SinvH, nu_sel, lm_ix, do, add,
        c.new_cov, cand, a8, band, streamed=streamed)
    matched = torch.where(do, slot, torch.full_like(slot, -1))
    new_state = SlamState(mu=upd[1], Sigma=upd[0], active=active,
                          n_active=n_active, mu_auv_odom=state_b.mu_auv_odom)
    if band is not None:
        return new_state, matched, upd[2]
    return new_state, matched


def a8_consts(R: torch.Tensor, dt) -> tuple:
    """The constant parts of ``_predict_a8``'s a8: (c1, c2), c1 (8, 16) =
    the identity on rows 0:3 and 6:8 plus R in rows 0:6, cols 8:14; c2 the
    (8, 16) identity (an invalid tick's a8). Built without host data."""
    c1 = torch.zeros((8, 16), dtype=dt, device=R.device)
    c1.diagonal()[0:3].fill_(1.0)
    c1.diagonal()[6:8].fill_(1.0)
    c1[0:6, 8:14] = R.to(dt)
    return c1, torch.eye(8, 16, dtype=dt, device=R.device)


def _predict_a8(mu_b, mu_auv_odom, odom_pose, valid, params: SlamParams, c12=None):
    """The fleet predict's μ bookkeeping and its packed motion Jacobian:
    returns ``(mu, u_t, a8)``, a8 (B, 8, 16) with cols 0:8 = blockdiag(A6,
    I2) and cols 8:14 of rows 0:6 = R̃ = R·valid. valid=False gives an exact
    no-op (u_t=0, A the exact identity, R̃ zero, attitude kept). ``c12``
    (``a8_consts``) is made here when not given."""
    dt = mu_b.dtype
    v1 = valid.to(dt)[:, None]
    u_t = (odom_pose[:, 0:3] - mu_auv_odom) * v1
    att = torch.where(valid[:, None], wrap_angle(odom_pose[:, 3:6]), mu_b[:, 3:6])
    mu = torch.cat([mu_b[:, 0:3] + u_t, att, mu_b[:, 6:]], dim=1)

    g = _motion_jacobian(att, u_t)                                     # (B,3,3)
    c1, c2 = a8_consts(params.R, dt) if c12 is None else c12
    a8 = torch.where(valid[:, None, None], F.pad(g, (3, 10, 0, 5)) + c1, c2)
    return mu, u_t, a8


def _fleet_predict(state_b: SlamState, odom_pose: torch.Tensor,
                   valid: torch.Tensor, params: SlamParams,
                   predict_sigma: bool = False, c12=None):
    """Batched ``predict`` with the odom-validity gate folded into the
    inputs (see ``_predict_a8``).

    Returns ``(state, a8)``. By default Σ is left untouched and the motion
    Jacobian comes back packed as a8 for the kernels to apply to what they
    read. With ``predict_sigma=True`` (no event pass this tick to carry it)
    Σ is predicted here and a8 comes back None."""
    mu, u_t, a8 = _predict_a8(state_b.mu, state_b.mu_auv_odom, odom_pose, valid, params, c12)
    Sigma = state_b.Sigma
    if predict_sigma:
        S = state_b.Sigma
        A, R = a8[:, 0:6, 0:6], a8[:, 0:6, 8:14]
        S11 = torch.einsum("bij,bjk,blk->bil", A, S[:, 0:6, 0:6], A) + R
        S1L = torch.einsum("bij,bjk->bik", A, S[:, 0:6, 6:])
        Sigma = S.clone()
        Sigma[:, 0:6, 0:6] = S11
        Sigma[:, 0:6, 6:] = S1L
        Sigma[:, 6:, 0:6] = S1L.transpose(1, 2)
        a8 = None
    return SlamState(mu=mu, Sigma=Sigma, active=state_b.active,
                     n_active=state_b.n_active,
                     mu_auv_odom=state_b.mu_auv_odom + u_t), a8


def _fleet_inputs(tl):
    """Per-tick (T, B, ...) views of a batched timeline's odometry and
    events: (odom poses, validity, event sensor names, {name: (z, mask)});
    an event counts only where the odometry is valid."""
    odom = tl.channels["odom"]
    odom_pose_t = _odom_pose(odom.value).transpose(0, 1).contiguous()   # (T,B,6)
    valid_t = odom.valid.transpose(0, 1).contiguous()                   # (T,B)
    names = [n for n in ("mbes", "fls") if n in tl.events]
    ev_t = {n: (tl.events[n].value.transpose(0, 1).contiguous(),
                (tl.events[n].mask & odom.valid[:, :, None]).transpose(0, 1).contiguous())
            for n in names}
    return odom_pose_t, valid_t, names, ev_t


def _run_per_mission(tl, params, cfg, update_mode):
    """``run`` of each mission of a batched timeline, stacked as the fleet
    replay stacks it (final state (B, ...), outputs (T, B, ...))."""
    finals, outs = [], []
    for b in range(tl.ticks.shape[0]):
        f, o = run(tl.map(lambda x: x[b]), params, cfg, update_mode=update_mode)
        finals.append(f)
        outs.append(o)
    final = SlamState(*(torch.stack(xs) for xs in zip(*finals)))
    return final, {k: torch.stack([o[k] for o in outs], 1) for k in outs[0]}


_SENSORS = {"mbes": MBES, "fls": FLS}


def _loop_inputs(tl, params: SlamParams, cfg: EKFSlamConfig):
    """Every tensor a fleet tick loop reads, as a flat dict, and the event
    sensor names: the per-tick (T, B, ...) odometry and events, the
    parameters, the initial state, each pass's constants. A graphed replay
    copies exactly these into its static buffers."""
    L = cfg.max_landmarks
    s0 = init_state(cfg, dtype=params.R.dtype, device=tl.ticks.device)
    odom_pose_t, valid_t, names, ev_t = _fleet_inputs(tl)
    inp = {"odom_pose": odom_pose_t, "valid": valid_t, "band0": initial_band(s0.Sigma, L)}
    for n in names:
        inp["z_" + n], inp["m_" + n] = ev_t[n]
        c = pass_consts(params, cfg, _SENSORS[n])
        inp["new_cov_" + n], inp["outlier"], inp["mh_dist_" + n] = c.new_cov, c.outlier, c.mh_dist
    inp.update(("p_" + k, v) for k, v in params._asdict().items() if v is not None)
    inp.update(("s0_" + k, v) for k, v in s0._asdict().items())
    return inp, tuple(names)


def _loop_setup(inp: dict, names: tuple):
    """The loop's prologue on its inputs: (params, s0, {sensor name:
    PassConsts}, a8 constants)."""
    params = SlamParams(*(inp.get("p_" + k) for k in SlamParams._fields))
    s0 = SlamState(*(inp["s0_" + k] for k in SlamState._fields))
    consts = {n: PassConsts(new_cov=inp["new_cov_" + n],
                            q_diag=torch.diagonal(_SENSORS[n].q(params)),
                            lam=_SENSORS[n].lam(params), outlier=inp["outlier"],
                            mh_dist=inp["mh_dist_" + n]) for n in names}
    return params, s0, consts, a8_consts(params.R, params.R.dtype)


def _full_tick(state: SlamState, band, odom_pose, valid, events: dict, params: SlamParams,
               cfg: EKFSlamConfig, consts: dict, c12, streamed: bool = True):
    """One tick of the full-Σ fleet -> (state, band, outputs): the batched
    predict, then one ``da_lanes_pass`` (K1 + K2) per event sensor of
    ``events`` ({name: (z (B, M, 3), mask (B, M))}), the first pass carrying
    the predict's Σ transform, the band carried through every pass."""
    st, a8 = _fleet_predict(state, odom_pose, valid, params, predict_sigma=not events, c12=c12)
    out = {}
    for n, (z, m) in events.items():
        st, matched, band = da_lanes_pass(st, z, m, params, cfg, _SENSORS[n], a8=a8, band=band,
                                          consts=consts[n], streamed=streamed)
        a8 = None
        out["matched_" + n] = matched
    out["mu"] = st.mu[:, 0:6]
    out["n_active"] = st.n_active
    return st, band, out


def _tick_events(inp: dict, names: tuple, t: int) -> dict:
    return {n: (inp["z_" + n][t], inp["m_" + n][t]) for n in names}


def _full_loop(inp: dict, cfg: EKFSlamConfig, names: tuple, streamed: bool = True):
    """``run_fleet``'s tick loop on ``_loop_inputs`` -> (final state,
    outputs stacked (T, B, ...)), K2 on the given schedule. Capture-safe:
    nothing in it syncs with the host or builds a tensor from host data."""
    params, s0, consts, c12 = _loop_setup(inp, names)
    T, B = inp["valid"].shape
    L = cfg.max_landmarks
    state = SlamState(*(x.expand((B,) + x.shape).contiguous() for x in s0))
    band = inp["band0"].expand(B, 24, L).contiguous()
    outs = []
    for t in range(T):
        state, band, out = _full_tick(state, band, inp["odom_pose"][t], inp["valid"][t],
                                      _tick_events(inp, names, t), params, cfg, consts, c12,
                                      streamed)
        outs.append(out)
    return state, _stack_outputs(outs)


def run_fleet(
    batched_timeline,
    params: SlamParams,
    cfg: EKFSlamConfig = EKFSlamConfig(),
    update_mode: str = "auto",
    device_mesh=None,
    graph: bool = True,
    streamed: bool = True,
):
    """Fleet replay of B missions (tensor-leaved batched Timeline, leaves
    (B, T, ...)) -> (final batched SlamState, outputs stacked (T, B, ...)).

    Every tick: ``_fleet_predict`` in PyTorch, then for each event sensor
    one ``da_lanes_pass`` (K1 + K2); the first pass carries the predict's Σ
    transform. Semantics are the reference's ``run_fleet`` (= vmapped
    ``run`` with full updates). No host sync inside the tick loop.

    On CUDA tensors the tick loop runs as a CUDA graph cached per shape,
    configuration, sensor set and K2 schedule (``utils.graphs``; the
    reference runs it as one jitted ``lax.scan``); ``graph=False`` runs it
    eagerly, launch by launch, for comparisons. CPU tensors always take the
    eager loop on the kernels' plain versions. ``streamed=False`` runs K2's
    one-kernel schedule instead of phase 1 + K12 (the same bits on the
    card; kept for comparisons).

    ``update_mode="marginal"`` is ``run_fleet_marginal`` (K1 + K4 on the
    pose-rows + band carry); ``"marginal_dense"`` and ``"kernel"`` (or its
    reference name ``"pallas"``) replay each mission through ``run`` with
    that covariance writeback, as the reference does for its non-default
    modes."""
    if device_mesh is not None:
        return _run_fleet_sharded(batched_timeline, params, cfg, update_mode, device_mesh,
                                  graph, streamed)
    if update_mode == "marginal":
        return run_fleet_marginal(batched_timeline, params, cfg, graph=graph)
    if update_mode == "marginal_dense":
        update_mode = "marginal"
    if update_mode == "pallas":
        update_mode = "kernel"
    if update_mode in ("marginal", "kernel"):
        return _run_per_mission(batched_timeline, params, cfg, update_mode)
    if update_mode not in ("auto", "full"):
        raise ValueError(f"unknown update_mode {update_mode!r}")

    with trace.span("slam.fleet.stage"):
        inp, names = _loop_inputs(batched_timeline, params, cfg)
    if graph and inp["valid"].device.type == "cuda":
        key = ("ekf_slam.run_fleet", cfg, names, streamed)
        return graphs.run(key, lambda x: _full_loop(x, cfg, names, streamed), inp)
    return _full_loop(inp, cfg, names, streamed)


def _run_fleet_sharded(tl, params: SlamParams, cfg: EKFSlamConfig, update_mode: str,
                       device_mesh, graph: bool, streamed: bool):
    """``run_fleet`` with the missions split over ``device_mesh``'s mission
    axis: each mission shard's replay (any update mode) on the first device
    of its mesh row, the final states and the (T, B, ...) outputs joined on
    the timeline's device."""
    M = device_mesh.shape[mesh_lib.MISSION_AXIS]
    B = tl.ticks.shape[0]
    if B % M:
        raise ValueError(f"fleet size {B} not divisible by mission axis {M}")
    res = [run_fleet(t, mesh_lib.tree_map(lambda x, d=row[0]: x.to(d), params), cfg,
                     update_mode, graph=graph, streamed=streamed)
           for t, row in zip(mesh_lib.shard_missions(tl, device_mesh), device_mesh.devices)]
    dev = tl.ticks.device
    return (mesh_lib.join_missions([r[0] for r in res], dev, 0),
            mesh_lib.join_missions([r[1] for r in res], dev, 1))


# ---------------------------------------------------------------------------
# marginal-writeback fleet: the reference's covariance semantics
# ---------------------------------------------------------------------------

class MarginalFleetState(NamedTuple):
    """Fleet carry of the marginal-semantics path: under the reference's
    own update (``ekf_slam_core.cpp:351-371``) cross-landmark covariance
    blocks stay exactly zero, so pose rows + the landmark block-diagonal
    band ARE the complete covariance."""
    mu: torch.Tensor           # (B, D)
    rows: torch.Tensor         # (B, 8, D) Σ[0:6, :] (rows 6:8 zero)
    band: torch.Tensor         # (B, 24, L)
    active: torch.Tensor       # (B, L) bool
    n_active: torch.Tensor     # (B,) int32
    mu_auv_odom: torch.Tensor  # (B, 3)


def sigma_from_rows_band(rows: torch.Tensor, band: torch.Tensor, L: int) -> torch.Tensor:
    """The full (B, D, D) covariance of a marginal-mode fleet: pose rows,
    their transpose in the pose columns, and the landmark block diagonal;
    every cross-landmark block is zero by the marginal-semantics invariant."""
    B, _, D = rows.shape
    pr = rows[:, 0:6, :]
    Sig = rows.new_zeros((B, D, D))
    Sig[:, :, 0:6] = pr.transpose(1, 2)
    Sig[:, 0:6, :] = pr
    la = 6 + 3 * torch.arange(L, device=rows.device)
    for a in range(3):
        for d in range(3 - a):
            Sig[:, la + a, la + a + d] = band[:, a * 8 + d, :]
            if d:
                Sig[:, la + a + d, la + a] = band[:, a * 8 + d, :]
    return Sig


def _rows_block_fix(P1: torch.Tensor, t2: torch.Tensor) -> torch.Tensor:
    """Place the (B, 8, 8) predicted pose block into lanes 0:6 of the
    left-multiplied rows (lanes >= 6 keep A·Σ[0:6, 6:])."""
    return torch.cat([t2[:, :, 0:6], P1[:, :, 6:]], dim=2)


def _fleet_predict_marginal(ms: MarginalFleetState, odom_pose, valid,
                            params: SlamParams, predict_rows: bool, c12=None):
    """``_fleet_predict`` for the marginal carry: the μ bookkeeping is the
    same; the covariance transform touches only the pose rows
    (Σ'[0:6, 6:] = A Σ[0:6, 6:], Σ'66 = A Σ66 Aᵀ + R̃; landmark blocks are
    untouched by the motion predict, ``ekf_slam_core.cpp:110-118``). With
    ``predict_rows=False`` the transform rides the kernels via the returned
    a8 and the rows come back untouched."""
    mu, u_t, a8 = _predict_a8(ms.mu, ms.mu_auv_odom, odom_pose, valid, params, c12)
    rows = ms.rows
    if predict_rows:
        A8, r88 = a8[:, :, 0:8], a8[:, :, 8:16]
        P1 = torch.einsum("bij,bjd->bid", A8, rows)
        t2 = torch.einsum("bij,bjk,blk->bil", A8, rows[:, :, 0:8], A8) + r88
        rows = _rows_block_fix(P1, t2)
        a8 = None
    return ms._replace(mu=mu, rows=rows, mu_auv_odom=ms.mu_auv_odom + u_t), a8


def da_lanes_pass_marginal(ms: MarginalFleetState, z_b, mask_b,
                           params: SlamParams, cfg: EKFSlamConfig,
                           sensor: SensorSpec = None, a8=None, valid=None,
                           consts: PassConsts = None):
    """Fleet DA pass on the marginal carry: K1 reads Spp/Spl from the pose
    rows and Sll from the band; the update is K4
    (``slam_kernels.sequential_update_marginal_fleet``). ``consts``
    (``pass_consts``) is made here when not given; ``valid`` is accepted and
    ignored, as in the reference."""
    sensor = MBES if sensor is None else sensor
    c = pass_consts(params, cfg, sensor) if consts is None else consts
    B = ms.mu.shape[0]
    L = cfg.max_landmarks
    fls = sensor.kind == "fls"
    ctr, H_sel, SinvH, nu_sel, cand, do, add, slot = slam_da_kernels.da_lanes(
        ms.mu[:, 0:6].contiguous(), ms.n_active, ms.active,
        ms.mu[:, 6:].reshape(B, L, 3).contiguous(), None,
        z_b[:, :, 0:3].contiguous(), mask_b.contiguous(),
        c.q_diag, c.lam, c.outlier, c.mh_dist, c.new_cov, sensor=sensor.kind,
        r_sb=params.r_fls_base if fls else None, t_sb=params.t_fls_base if fls else None,
        A=a8[:, 0:6, 0:6].contiguous() if a8 is not None else None,
        r_full=a8[:, 0:6, 8:14].contiguous() if a8 is not None else None,
        band=ms.band, pose_rows=ms.rows,
    )
    active = torch.cat([ms.active, ms.active.new_zeros(B, 1)], 1).scatter(
        1, torch.where(add, slot, L).long(), True)[:, :L].contiguous()
    n_active = ms.n_active + add.sum(1, dtype=torch.int32)
    rows, mu, band = slam_kernels.sequential_update_marginal_fleet(
        ms.rows, ms.mu, H_sel, SinvH, nu_sel, 6 + 3 * slot, do, add, c.new_cov,
        cand, ms.band, a8)
    matched = torch.where(do, slot, torch.full_like(slot, -1))
    return ms._replace(mu=mu, rows=rows, band=band, active=active,
                       n_active=n_active), matched


def _marginal_loop(inp: dict, cfg: EKFSlamConfig, names: tuple):
    """``run_fleet_marginal``'s tick loop on ``_loop_inputs`` -> (final
    MarginalFleetState, outputs stacked (T, B, ...)). Capture-safe."""
    params, s0, consts, c12 = _loop_setup(inp, names)
    T, B = inp["valid"].shape
    L = cfg.max_landmarks
    D = s0.mu.shape[0]
    rows0 = s0.Sigma.new_zeros((8, D))
    rows0[0:6] = s0.Sigma[0:6]
    ms = MarginalFleetState(
        mu=s0.mu.expand(B, D).contiguous(),
        rows=rows0.expand(B, 8, D).contiguous(),
        band=inp["band0"].expand(B, 24, L).contiguous(),
        active=s0.active.expand(B, L).contiguous(),
        n_active=s0.n_active.expand(B).contiguous(),
        mu_auv_odom=s0.mu_auv_odom.expand(B, 3).contiguous())
    outs = []
    for t in range(T):
        ms, a8 = _fleet_predict_marginal(ms, inp["odom_pose"][t], inp["valid"][t], params,
                                         predict_rows=not names, c12=c12)
        out = {}
        for n in names:
            ms, matched = da_lanes_pass_marginal(
                ms, inp["z_" + n][t], inp["m_" + n][t], params, cfg, _SENSORS[n], a8=a8,
                consts=consts[n])
            a8 = None
            out["matched_" + n] = matched
        out["mu"] = ms.mu[:, 0:6]
        out["n_active"] = ms.n_active
        outs.append(out)
    return ms, _stack_outputs(outs)


def run_fleet_marginal(
    batched_timeline,
    params: SlamParams,
    cfg: EKFSlamConfig = EKFSlamConfig(),
    graph: bool = True,
):
    """Fleet replay under the reference's marginal covariance semantics
    (the ``run_fleet`` counterpart of ``run(update_mode="marginal")``): the
    carry is pose rows + band, nothing (D, D)-shaped exists in the tick
    loop. Every tick: the predict's bookkeeping in PyTorch, then per event
    sensor K1 (pose-rows form) + K4; the first pass carries the predict's
    pose-row transform. Returns (final SlamState with the covariance
    reconstructed once at the end, outputs stacked (T, B, ...)). On CUDA
    tensors the tick loop runs as a cached CUDA graph unless ``graph=False``
    (see ``run_fleet``)."""
    inp, names = _loop_inputs(batched_timeline, params, cfg)
    if graph and inp["valid"].device.type == "cuda":
        key = ("ekf_slam.run_fleet_marginal", cfg, names)
        ms, outs = graphs.run(key, lambda x: _marginal_loop(x, cfg, names), inp)
    else:
        ms, outs = _marginal_loop(inp, cfg, names)
    L = cfg.max_landmarks
    final = SlamState(mu=ms.mu, Sigma=sigma_from_rows_band(ms.rows, ms.band, L),
                      active=ms.active, n_active=ms.n_active,
                      mu_auv_odom=ms.mu_auv_odom)
    return final, outs


def _segmented_affine_scan(A: torch.Tensor, R: torch.Tensor, reset: torch.Tensor):
    """Inclusive segmented prefix composition along axis 1 of (B, T, 6, 6)
    motion Jacobians A and noises R under the affine-covariance monoid
    (A2,R2)∘(A1,R1) = (A2 A1, A2 R1 A2ᵀ + R2); ``reset`` (T,) starts a fresh
    segment at a tick. log₂T doubling passes of batched 6×6 products
    (Hillis-Steele), no loop over T."""
    T = A.shape[1]
    r = reset.clone()
    d = 1
    while d < T:
        Ax, Rx, rx = A[:, :-d], R[:, :-d], r[:-d]          # element t - d
        Ay, Ry, ry = A[:, d:], R[:, d:], r[d:]             # element t
        m = ry[None, :, None, None]
        Ac = torch.where(m, Ay, Ay @ Ax)
        Rc = torch.where(m, Ry, Ay @ Rx @ Ay.transpose(-1, -2) + Ry)
        A = torch.cat([A[:, :d], Ac], 1)
        R = torch.cat([R[:, :d], Rc], 1)
        r = torch.cat([r[:d], rx | ry])
        d *= 2
    return A, R


def _rfc_core(tl, params, e_idx, seg_of, ev_any, cfg, names):
    """Core of ``run_fleet_compact`` (e_idx, seg_of, ev_any host numpy)."""
    od = tl.channels["odom"]
    B, T = od.valid.shape
    dt, dev = params.R.dtype, od.value.device
    pos = od.value[..., 0:3].to(dt)
    if od.value.shape[-1] >= 13:
        att = wrap_angle(rpy_from_quat(od.value[..., 3:7])).to(dt)
    else:
        att = wrap_angle(od.value[..., 3:6]).to(dt)
    # per-tick odometric increments (all ticks valid: caller precondition)
    u = pos - torch.cat([pos.new_zeros(B, 1, 3), pos[:, :-1]], 1)
    U_cum = torch.cumsum(u, 1)

    A = torch.zeros((B, T, 6, 6), dtype=dt, device=dev)
    A[..., 0:3, 0:3] = torch.eye(3, dtype=dt, device=dev)
    A[..., 0:3, 3:6] = _motion_jacobian(att, u)
    R = params.R.expand(B, T, 6, 6)
    # segment boundaries sit just after each event tick: prefix[t] is the
    # composition since the last event
    reset = torch.as_tensor(np.concatenate([[True], ev_any[:-1]]), device=dev)
    A_seg, R_seg = _segmented_affine_scan(A, R, reset)

    e = torch.as_tensor(e_idx, dtype=torch.int64, device=dev)
    E = e.shape[0]
    Ue = U_cum[:, e]                                           # (B, E, 3)
    u_seg = Ue - torch.cat([Ue.new_zeros(B, 1, 3), Ue[:, :-1]], 1)
    att_e = att[:, e]
    a8e = torch.zeros((B, E, 8, 16), dtype=dt, device=dev)
    a8e[..., 0:6, 0:6] = A_seg[:, e]
    a8e[..., 6, 6] = 1.0
    a8e[..., 7, 7] = 1.0
    a8e[..., 0:6, 8:14] = R_seg[:, e]

    L = cfg.max_landmarks
    s0 = init_state(cfg, dtype=dt, device=dev)
    st = SlamState(*(x.expand((B,) + x.shape).contiguous() for x in s0))
    band = initial_band(s0.Sigma, L).expand(B, 24, L).contiguous()
    ev = {n: (tl.events[n].value[:, e], tl.events[n].mask[:, e]) for n in names}

    oev = []
    for k in range(E):
        mu = torch.cat([st.mu[:, 0:3] + u_seg[:, k], att_e[:, k], st.mu[:, 6:]], 1)
        st = SlamState(mu=mu, Sigma=st.Sigma, active=st.active, n_active=st.n_active,
                       mu_auv_odom=st.mu_auv_odom + u_seg[:, k])
        a8 = a8e[:, k].contiguous()
        out = {}
        for n in names:
            z, m = ev[n][0][:, k].contiguous(), ev[n][1][:, k].contiguous()
            st, matched, band = da_lanes_pass(
                st, z, m, params, cfg, MBES if n == "mbes" else FLS, a8=a8, band=band)
            a8 = None
            out["matched_" + n] = matched
        out["mu"] = st.mu[:, 0:6]
        out["n_active"] = st.n_active
        oev.append(out)
    oev = _stack_outputs(oev)

    # per-tick outputs: event slices + odometric deltas between events
    seg = torch.as_tensor(seg_of, dtype=torch.int64, device=dev)
    mu_e = oev["mu"]                                           # (E, B, 6)
    pos_ext = torch.cat([s0.mu[0:3].expand(1, B, 3), mu_e[:, :, 0:3]], 0)
    base_U = torch.cat([Ue.new_zeros(1, B, 3), Ue.transpose(0, 1)], 0)
    U_t = U_cum.transpose(0, 1)                                # (T, B, 3)
    mu_pos_t = pos_ext[seg] + (U_t - base_U[seg])
    att_ext = torch.cat([s0.mu[3:6].expand(1, B, 3), mu_e[:, :, 3:6]], 0)
    evt = torch.as_tensor(ev_any, device=dev)[:, None, None]
    att_out = torch.where(evt, att_ext[seg], att.transpose(0, 1))
    out = {"mu": torch.cat([mu_pos_t, att_out], -1)}
    na_ext = torch.cat([s0.n_active.expand(1, B), oev["n_active"]], 0)
    out["n_active"] = na_ext[seg]
    for n in names:
        me = oev["matched_" + n]                               # (E, B, M)
        full = torch.full((T,) + me.shape[1:], -1, dtype=me.dtype, device=dev)
        full[e] = me
        out["matched_" + n] = full
    return st, out


def run_fleet_compact(
    batched_timeline,
    params: SlamParams,
    cfg: EKFSlamConfig = EKFSlamConfig(),
):
    """Event-compacted fleet replay: the event pass (K1 + K2) runs on EVENT
    ticks only.

    With valid odometry at every tick the motion predict between events is
    state-independent (attitude absolute, position increment odometric), so
    the per-tick (A_t, R_t) compose outside the event loop (a segmented
    prefix scan, log₂T batched passes) and each event tick consumes ONE
    composed a8 with a full 6×6 R̃. Per-tick outputs are rebuilt from the
    event outputs plus cumulative odometry, so the output contract is
    ``run_fleet``'s; values agree with it up to f32 re-association.

    Falls back to ``run_fleet`` when any odometry tick is invalid (an invalid
    tick rebroadcasts the post-update attitude into the next predict, which
    cannot be precomposed), with the reference's rule (``ekf_slam.py:1305``)."""
    tl = batched_timeline
    od = tl.channels["odom"]
    if not bool(od.valid.all()):
        return run_fleet(tl, params, cfg)
    T = tl.ticks.shape[1]
    names = tuple(n for n in ("mbes", "fls") if n in tl.events)
    ev_any = np.zeros(T, bool)
    for n in names:
        ev_any |= tl.events[n].mask.any(dim=2).any(dim=0).cpu().numpy()
    ev_any[T - 1] = True   # final virtual event carries the tail predicts
    e_idx = np.nonzero(ev_any)[0]
    seg_of = np.searchsorted(e_idx, np.arange(T), side="right")
    return _rfc_core(tl, params, e_idx, seg_of, ev_any, cfg, names)


def map_to_odom_correction(mu_pose: torch.Tensor, odom_pose: torch.Tensor) -> Transform:
    """tf map->odom correction (``bcMapOdomTF``, ``ekf_slam.cpp:263-294``):
    composes the filter's map->base estimate with the inverse of the raw
    odom->base odometry."""
    return Transform.from_pose(mu_pose).compose(Transform.from_pose(odom_pose).inverse())


def slam_timeline(mission, odom_track: np.ndarray, odom_ticks: np.ndarray,
                  cfg: EKFSlamConfig = EKFSlamConfig()):
    """SLAM timeline (numpy leaves): odometry channel (from a DR provider
    run) + MBES events."""
    det = mission.streams["mbes_detections"]
    return build_timeline(
        t0=0.0, t1=mission.spec.duration_s, freq_hz=cfg.system_freq,
        channels={"odom": (odom_ticks, odom_track)},
        events={"mbes": (det["stamps"], det["values"], det["burst"], cfg.max_obs)},
    )


def landmarks_map(state: SlamState, cfg: EKFSlamConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Current landmark estimates: (L, 3) positions + active mask (the RViz
    marker output of the reference, ``ekf_slam.cpp:201-233``)."""
    return state.mu[6:].reshape(cfg.max_landmarks, 3), state.active
