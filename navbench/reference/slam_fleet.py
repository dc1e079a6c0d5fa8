"""The benchmark's plain reference of the EKF-SLAM tick, batched over
missions: the frozen oracle (``ekf_slam_oracle.py``, full-covariance
writeback, MBES) restated in plain PyTorch over a leading mission axis N,
in float64. It imports nothing of either navigation package.

Per tick and mission, as the oracle: the odometry gate; the predict
(position increment, absolute wrapped attitude from the odometry
quaternion, G = [[I, g], [0, 0]] on the pose block, R added); on a tick
with detections the (L + M, M) cost table (Mahalanobis distances of known
active slots under the χ² gate, each detection's back-projected candidate
at the new-landmark cost on the diagonal, the outlier cost elsewhere); the
assignment; the updates in measurement order with the batch-stage H, S⁻¹
and ν, each a whole-state gain with the attitude wrapped, Σ symmetrised.

``replay(..., decisions=None)`` takes its own optimal assignment (scipy's
exact LAP). With ``decisions`` (the judged program's per-tick matched
slots, (N, T, M)) it breaks near ties as the program did: where the
program's slots form a valid assignment in the reference's own table that
costs at most ``TIE`` more than the optimum there, it applies them;
anywhere else it applies its own optimum, so a wrong association shows in
the states that follow. It reports each tick's ``gap`` (the program's
assignment's cost over the optimum) and counts the ticks it ``overruled``.
It keeps its own state throughout and takes only the discrete decisions,
as a served model's reference is run over the served tokens.

``precision="tf32"`` is the control: the same code in float32 with every
matrix product's operands rounded to TF32 (10 explicit mantissa bits), as
the card's tensor cores take them with TF32 on.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment
from scipy.stats import chi2

BAD = 1e30   # the gap of an assignment that is not one (a reused row, a wrong new slot)
# Near ties (Mahalanobis units) broken as the program broke them: float32's
# state error moves an L=64 cost by ~3e-4 at most; the TF32 control's, ~100x
# more, flipped no decision in 96 missions, so real margins lie above 1e-2
TIE = 1e-3


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (nearest, ties away from zero in magnitude)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -8192).view(torch.float32)


class _Math:
    """Matrix products in the run's precision."""

    def __init__(self, precision: str):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.tf32 = precision == "tf32"
        self.dtype = torch.float32 if self.tf32 else torch.float64

    def ein(self, eq: str, *ops):
        if self.tf32:
            ops = [_tf32(o) for o in ops]
        return torch.einsum(eq, *ops)


def wrap(a):
    return torch.remainder(a + math.pi, 2 * math.pi) - math.pi


def rotmat(rpy):
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr, cp, sp, cy, sy = r.cos(), r.sin(), p.cos(), p.sin(), y.cos(), y.sin()
    return torch.stack([
        torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1),
        torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1),
        torch.stack([-sp, cp * sr, cp * cr], -1)], -2)


def rpy_from_quat(q):
    """xyzw quaternion -> roll, pitch, yaw (tf getRPY, solution 1)."""
    q = q / q.norm(dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r20 = 2 * (x * z - w * y)
    r21, r22 = 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)
    r10, r00 = 2 * (x * y + w * z), 1 - 2 * (y * y + z * z)
    return torch.stack([torch.atan2(r21, r22), torch.arcsin(torch.clamp(-r20, -1, 1)),
                        torch.atan2(r10, r00)], -1)


def motion_g(u, rpy):
    """d(R(rpy) u)/d(rpy), (..., 3, 3): ``ekf_slam_core.cpp:84-107``."""
    u0, u1, u2 = u[..., 0], u[..., 1], u[..., 2]
    c3, s3 = rpy[..., 0].cos(), rpy[..., 0].sin()
    c4, s4 = rpy[..., 1].cos(), rpy[..., 1].sin()
    c5, s5 = rpy[..., 2].cos(), rpy[..., 2].sin()
    g = [
        u1 * (s3 * s5 + c3 * c5 * s4) + u2 * (c3 * s5 - c5 * s4 * s3),
        c5 * (u2 * c4 * c3 - u0 * s4 + u1 * c4 * s3),
        u2 * (c5 * s3 - c3 * s4 * s5) - u1 * (c3 * c5 + s4 * s3 * s5) - u0 * c4 * s5,
        -u1 * (c5 * s3 - c3 * s4 * s5) - u2 * (c3 * c5 + s4 * s3 * s5),
        s5 * (u2 * c4 * c3 - u0 * s4 + u1 * c4 * s3),
        u2 * (s3 * s5 + c3 * c5 * s4) - u1 * (c3 * s5 - c5 * s4 * s3) + u0 * c4 * c5,
        c4 * (u1 * c3 - u2 * s3),
        -u0 * c4 - u2 * c3 * s4 - u1 * s4 * s3,
        torch.zeros_like(u0),
    ]
    return torch.stack(g, -1).reshape(u.shape[:-1] + (3, 3))


def mbes_H(pose, lm):
    """3x9 MBES Jacobian, ``correspondence_obj_mbes.cpp:61-107``; pose
    (..., 6) and lm (..., 3) broadcast."""
    mu0, mu1, mu2 = pose[..., 0], pose[..., 1], pose[..., 2]
    c3, s3 = pose[..., 3].cos(), pose[..., 3].sin()
    c4, s4 = pose[..., 4].cos(), pose[..., 4].sin()
    c5, s5 = pose[..., 5].cos(), pose[..., 5].sin()
    lx, ly, lz = lm[..., 0], lm[..., 1], lm[..., 2]
    shape = torch.broadcast_shapes(mu0.shape, lx.shape)
    z = torch.zeros(shape, dtype=pose.dtype, device=pose.device)

    def b(x):
        return x.expand(shape) if torch.is_tensor(x) else z + x

    rows = [
        [-c4 * c5, -c4 * s5, s4, z,
         mu2 * c4 - lz * c4 - lx * c5 * s4 - ly * s4 * s5 + mu0 * c5 * s4 + mu1 * s4 * s5,
         c4 * (ly * c5 - lx * s5 - mu1 * c5 + mu0 * s5),
         c4 * c5, c4 * s5, -s4],
        [c3 * s5 - c5 * s4 * s3, -c3 * c5 - s4 * s3 * s5, -c4 * s3,
         (lz * c4 * c3 - mu2 * c4 * c3 - ly * c5 * s3 + lx * s3 * s5 + mu1 * c5 * s3
          - mu0 * s3 * s5 + lx * c3 * c5 * s4 + ly * c3 * s4 * s5 - mu0 * c3 * c5 * s4
          - mu1 * c3 * s4 * s5),
         -s3 * (lz * s4 - mu2 * s4 - lx * c4 * c5 - ly * c4 * s5 + mu0 * c4 * c5 + mu1 * c4 * s5),
         (mu0 * c3 * c5 - ly * c3 * s5 - lx * c3 * c5 + mu1 * c3 * s5 + ly * c5 * s4 * s3
          - lx * s4 * s3 * s5 - mu1 * c5 * s4 * s3 + mu0 * s4 * s3 * s5),
         c5 * s4 * s3 - c3 * s5, c3 * c5 + s4 * s3 * s5, c4 * s3],
        [-s3 * s5 - c3 * c5 * s4, c5 * s3 - c3 * s4 * s5, -c4 * c3,
         (lx * c3 * s5 - lz * c4 * s3 - ly * c3 * c5 + mu1 * c3 * c5 + mu2 * c4 * s3
          - mu0 * c3 * s5 - lx * c5 * s4 * s3 - ly * s4 * s3 * s5 + mu0 * c5 * s4 * s3
          + mu1 * s4 * s3 * s5),
         -c3 * (lz * s4 - mu2 * s4 - lx * c4 * c5 - ly * c4 * s5 + mu0 * c4 * c5 + mu1 * c4 * s5),
         (lx * c5 * s3 + ly * s3 * s5 - mu0 * c5 * s3 - mu1 * s3 * s5 + ly * c3 * c5 * s4
          - lx * c3 * s4 * s5 - mu1 * c3 * c5 * s4 + mu0 * c3 * s4 * s5),
         s3 * s5 + c3 * c5 * s4, c3 * s4 * s5 - c5 * s3, c4 * c3],
    ]
    return torch.stack([torch.stack([b(x) for x in r], -1) for r in rows], -2)


def replay(cfg: dict, odom, valid, z, zmask, decisions=None, precision: str = "float64",
           device="cpu") -> dict:
    """Replay N missions of T ticks.

    cfg: the configuration's fields (``max_landmarks``, ``sigma0_diag``,
    ``r_diag``, ``q_mbes_diag``, ``new_lm_cov_mbes``, ``mhl_dist_mbes``,
    ``delta_outlier_reject``, ``outlier_cost``). odom (N, T, 13) rows
    [pos3, quat4 xyzw, ...] (or (N, T, 6) poses), valid (N, T), z (N, T, M,
    3) detections, zmask (N, T, M); numpy or tensors.

    Returns numpy: ``pose`` (N, T, 6) after each tick, ``matched`` (N, T,
    M) the slot each detection updated (-1 none), ``n_active_t`` (N, T),
    the final ``mu`` (N, D), ``Sigma`` (N, D, D), ``n_active`` (N,),
    ``gap`` (N, T): the given decisions' cost over the optimum in this
    replay's own table (0 without ``decisions``; NaN on ticks without
    detections; ``BAD`` where the decisions are no valid assignment), and
    ``overruled`` (N,): ticks on which the decisions were not applied."""
    mm = _Math(precision)
    dt = mm.dtype

    def t(x, dtype=dt):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               device=device).to(dtype)

    odom, z = t(odom), t(z)
    valid, zmask = t(valid, torch.bool), t(zmask, torch.bool)
    N, T, M = zmask.shape
    L = int(cfg["max_landmarks"])
    D = 6 + 3 * L
    dec = None if decisions is None else t(decisions, torch.int64)
    Q = torch.diag(t(cfg["q_mbes_diag"]))
    R = torch.diag(t(cfg["r_diag"]))
    new_cov = t(cfg["new_lm_cov_mbes"])
    lam = float(chi2.ppf(cfg["delta_outlier_reject"], 3))
    outlier, mh = float(cfg["outlier_cost"]), float(cfg["mhl_dist_mbes"])
    if odom.shape[-1] >= 13:
        odom_pose = torch.cat([odom[..., 0:3], rpy_from_quat(odom[..., 3:7])], -1)
    else:
        odom_pose = odom[..., 0:6]

    mu = torch.zeros((N, D), dtype=dt, device=device)
    Sig = torch.zeros((N, D, D), dtype=dt, device=device)
    Sig[:, 0:6, 0:6] = torch.diag(t(cfg["sigma0_diag"]))
    active = torch.zeros((N, L), dtype=torch.bool, device=device)
    n_act = torch.zeros(N, dtype=torch.int64, device=device)
    mu_odom = torch.zeros((N, 3), dtype=dt, device=device)
    lanes = torch.arange(N, device=device)
    ar3, ar6 = torch.arange(3, device=device), torch.arange(6, device=device)
    eyeM = torch.eye(M, dtype=torch.bool, device=device)
    slots = torch.arange(L, device=device)

    pose_t = np.zeros((N, T, 6))
    matched_t = np.full((N, T, M), -1, np.int64)
    nact_t = np.zeros((N, T), np.int64)
    gap_t = np.full((N, T), np.nan)
    overruled = np.zeros(N, np.int64)

    for k in range(T):
        v = valid[:, k]
        # predict (ekf_slam_core.cpp:41-120) on lanes with odometry
        u = (odom_pose[:, k, 0:3] - mu_odom) * v[:, None]
        att = torch.where(v[:, None], wrap(odom_pose[:, k, 3:6]), mu[:, 3:6])
        mu = torch.cat([mu[:, 0:3] + u, att, mu[:, 6:]], 1)
        mu_odom = mu_odom + u
        A = torch.eye(6, dtype=dt, device=device).repeat(N, 1, 1)
        A[:, 3:6, 3:6] = 0
        A[:, 0:3, 3:6] = motion_g(u, att)
        S11 = mm.ein("nij,njk,nlk->nil", A, Sig[:, 0:6, 0:6], A) + R
        S1L = mm.ein("nij,njd->nid", A, Sig[:, 0:6, 6:])
        Sp = Sig.clone()
        Sp[:, 0:6, 0:6], Sp[:, 0:6, 6:] = S11, S1L
        Sp[:, 6:, 0:6] = S1L.transpose(1, 2)
        Sig = torch.where(v[:, None, None], Sp, Sig)

        zm = zmask[:, k] & v[:, None]
        burst = zm.any(1)
        if not bool(burst.any()):
            pose_t[:, k] = mu[:, 0:6].cpu().double().numpy()
            nact_t[:, k] = n_act.cpu().numpy()
            continue
        zk = z[:, k]
        # batch stage at the pre-update state (ekf_slam_core.cpp:184-304)
        pose = mu[:, 0:6]
        Rt = rotmat(pose[:, 3:6])                                     # (N,3,3)
        lm = mu[:, 6:].reshape(N, L, 3)
        zh = mm.ein("nji,nlj->nli", Rt, lm - pose[:, None, 0:3])      # (N,L,3)
        H = mbes_H(pose[:, None], lm)                                 # (N,L,3,9)
        Spp = Sig[:, 0:6, 0:6]
        Spl = Sig[:, 0:6, 6:].reshape(N, 6, L, 3).permute(0, 2, 1, 3)
        Sll = torch.diagonal(Sig[:, 6:, 6:].reshape(N, L, 3, L, 3), dim1=1, dim2=3)
        Sll = Sll.permute(0, 3, 1, 2)
        Sig9 = torch.cat([torch.cat([Spp[:, None].expand(N, L, 6, 6), Spl], 3),
                          torch.cat([Spl.transpose(2, 3), Sll], 3)], 2)   # (N,L,9,9)
        S = mm.ein("nlai,nlij,nlbj->nlab", H, Sig9, H) + Q
        Sinv = torch.linalg.inv(S)
        nu = zk[:, None, :, :] - zh[:, :, None, :]                    # (N,L,M,3)
        d = mm.ein("nlma,nlab,nlmb->nlm", nu, Sinv, nu)
        gate = (d < lam) & active[:, :, None] & zm[:, None, :]
        cost_known = torch.where(gate, d, torch.full_like(d, outlier))
        cand = mm.ein("nij,nmj->nmi", Rt, zk) + pose[:, None, 0:3]   # (N,M,3)
        Hc = mbes_H(pose[:, None], cand)                              # (N,M,3,9)
        Sig9c = torch.zeros((N, 9, 9), dtype=dt, device=device)
        Sig9c[:, 0:6, 0:6] = Spp
        Sig9c[:, 6:9, 6:9] = torch.diag(new_cov)
        Sinvc = torch.linalg.inv(mm.ein("nmai,nij,nmbj->nmab", Hc, Sig9c, Hc) + Q)
        nuc = zk - mm.ein("nji,nmj->nmi", Rt, cand - pose[:, None, 0:3])
        cost_cand = torch.where(eyeM, torch.full((M, M), mh, dtype=dt, device=device),
                                torch.full((M, M), outlier, dtype=dt, device=device))
        cost = torch.cat([cost_known, cost_cand.expand(N, M, M)], 1)  # (N,L+M,M)
        cost_h = cost.double().cpu().numpy()
        act_h, n_h, burst_h = active.cpu().numpy(), n_act.cpu().numpy(), burst.cpu().numpy()
        zm_h = zm.cpu().numpy()
        col_to_row = np.tile(L + np.arange(M), (N, 1))
        dec_h = None if dec is None else dec[:, k].cpu().numpy()
        for n in np.nonzero(burst_h)[0]:
            rows, cols = linear_sum_assignment(cost_h[n])
            opt = cost_h[n][rows, cols].sum()
            col_to_row[n, cols] = rows
            gap_t[n, k] = 0.0
            if dec_h is None:
                continue
            c2r, ok = _rows_of(dec_h[n], zm_h[n], act_h[n], int(n_h[n]), L)
            gap_t[n, k] = cost_h[n][c2r, np.arange(M)].sum() - opt if ok else BAD
            if gap_t[n, k] <= TIE:
                col_to_row[n] = c2r
            else:
                overruled[n] += 1
        c2r = torch.as_tensor(col_to_row, device=device)

        # updates in measurement order (ekf_slam_core.cpp:317-371, full gain)
        for i in range(M):
            r = c2r[:, i]
            is_new = r >= L
            can_add = is_new & (n_act < L)
            do = zm[:, i] & (can_add | ~is_new)
            if not bool(do.any()):
                continue
            slot = torch.where(is_new, n_act, torch.clamp(r, max=L - 1)).clamp(max=L - 1)
            idx3 = 6 + 3 * slot[:, None] + ar3                        # (N,3)
            add = do & is_new
            if bool(add.any()):   # addLMtoFilter (ekf_utils.cpp:25-44): zero rows/cols + diag
                mu = torch.where(add[:, None], mu.scatter(1, idx3, cand[:, i]), mu)
                rowmask = torch.zeros((N, D), dtype=torch.bool, device=device).scatter(
                    1, idx3, True) & add[:, None]
                Sig = Sig.masked_fill(rowmask[:, :, None] | rowmask[:, None, :], 0.0)
                Sig[lanes[:, None], idx3, idx3] = torch.where(
                    add[:, None], new_cov.expand(N, 3), Sig[lanes[:, None], idx3, idx3])
                active = active | (add[:, None] & (slots[None] == slot[:, None]))
                n_act = n_act + add.long()

            rc = torch.clamp(r, max=L - 1)
            Hi = torch.where(is_new[:, None, None], Hc[:, i], H[lanes, rc])
            Sinvi = torch.where(is_new[:, None, None], Sinvc[:, i], Sinv[lanes, rc])
            nui = torch.where(is_new[:, None], nuc[:, i], nu[lanes, rc, i])
            idx9 = torch.cat([ar6.expand(N, 6), idx3], 1)
            cols = Sig.gather(2, idx9[:, None, :].expand(N, D, 9))     # (N,D,9)
            K = mm.ein("ndj,naj,nab->ndb", cols, Hi, Sinvi)            # (N,D,3)
            mu_n = mu + mm.ein("nda,na->nd", K, nui)
            mu_n = torch.cat([mu_n[:, 0:3], wrap(mu_n[:, 3:6]), mu_n[:, 6:]], 1)
            HS = mm.ein("naj,ndj->nad", Hi, cols)                      # (N,3,D)
            Sig_n = Sig - mm.ein("nda,nae->nde", K, HS)
            Sig_n = 0.5 * (Sig_n + Sig_n.transpose(1, 2))
            mu = torch.where(do[:, None], mu_n, mu)
            Sig = torch.where(do[:, None, None], Sig_n, Sig)
            matched_t[:, k, i] = torch.where(do, slot, -1).cpu().numpy()
        pose_t[:, k] = mu[:, 0:6].cpu().double().numpy()
        nact_t[:, k] = n_act.cpu().numpy()

    return dict(pose=pose_t, matched=matched_t, n_active_t=nact_t, gap=gap_t, overruled=overruled,
                mu=mu.cpu().double().numpy(), Sigma=Sig.cpu().double().numpy(),
                n_active=n_act.cpu().numpy())


def _rows_of(matched, zm, active, n_active: int, L: int):
    """A program's matched slots (M,) as the assignment's rows in the
    (L + M, M) table, and whether they form a valid one: a known slot must be
    active and used once; a new landmark takes the next free slot in
    measurement order; an empty column and a denied add take their
    candidate row (the denial must be the bank's being full)."""
    M = len(matched)
    rows = L + np.arange(M)
    used, nxt, ok = set(), n_active, True
    for i in range(M):
        m = int(matched[i])
        if not zm[i]:
            ok &= m == -1
            continue
        if m == -1:
            ok &= nxt >= L
        elif m < L and active[m] and m < n_active:
            ok &= m not in used
            used.add(m)
            rows[i] = m
        else:
            ok &= m == nxt
            nxt += 1
    return rows, bool(ok)
