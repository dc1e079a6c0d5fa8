"""K9: the whole EKF-localization fleet tick.

``fleet_tick`` launches the CUDA kernel ``csrc/loc_tick.cu`` for CUDA
tensors and takes its plain PyTorch version ``fleet_tick_reference`` for
CPU tensors. It replaces the TPU kernel of
``smarc_navigation_tpu/ops/loc_kernels.py`` (``fleet_tick``, body
``_make_tick_kernel``; also launched by the reference's
``ekf_localization.run_fleet``) and keeps its signature, with (B, ...)
tensors in and out.

One tick, per mission: the absolute-attitude motion predict (identity
position block, the ∂(R(rpy)·Δ)/∂rpy coupling, zero orientation rows), then
for each of the M detections in order a greedy maximum-likelihood
association over the N map slots (landmark pre-gate, χ²(3) Mahalanobis gate,
rank by −½(d + log det S)) and the 6-state update, and last the no-input
gate that restores the input state. The plain version transcribes the TPU
kernel's body in its operation order, over (B, N) tensors.

``run_ticks`` is the fleet replay's loop: one launch per tick, each writing
tick t's μ, diag Σ and matches straight into preallocated (T, B, ...)
outputs, so nothing runs between two launches. On the card the loop runs
as a CUDA graph cached per shape (``utils.graphs``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build, _tensors
from ..utils import graphs
from ..utils.geometry import wrap_angle

_NEG = -3.0e38
MAX_N = 2048   # map slots and detections the kernel stages in shared memory
MAX_M = 512

_ARGTYPES = ([ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3
             + [ctypes.c_void_p] * 10)


def _rot_entries(sr, cr, sp, cp, sy, cy):
    """Entries of R = Rz(y) Ry(p) Rx(r) as a 3x3 nested list."""
    return [
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr],
    ]


def _drot_entries(sr, cr, sp, cp, sy, cy):
    """dR/d(roll), dR/d(pitch), dR/d(yaw), each a 3x3 nested list."""
    zero = sr * 0.0
    dR_dr = [
        [zero, cy * sp * cr + sy * sr, -cy * sp * sr + sy * cr],
        [zero, sy * sp * cr - cy * sr, -sy * sp * sr - cy * cr],
        [zero, cp * cr, -cp * sr],
    ]
    dR_dp = [
        [-cy * sp, cy * cp * sr, cy * cp * cr],
        [-sy * sp, sy * cp * sr, sy * cp * cr],
        [-cp, -sp * sr, -sp * cr],
    ]
    dR_dy = [
        [-sy * cp, -sy * sp * sr - cy * cr, -sy * sp * cr + cy * sr],
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [zero, zero, zero],
    ]
    return [dR_dr, dR_dp, dR_dy]


def fleet_tick_reference(mu, Sigma, rpy_t, disp_base, have, z, z_valid, map_pos,
                         map_mask, q_diag, r_diag, lambda_m, epsilon):
    """Plain PyTorch version of ``fleet_tick``: the TPU kernel's body with
    missions on dim 0 and map slots on dim 1."""
    B, M = z.shape[0], z.shape[1]
    N = map_pos.shape[0]
    f32 = torch.float32
    dev = mu.device

    def col(x):                                    # (B,) -> (B, 1)
        return x.to(f32)[:, None]

    qd = [q_diag[i].to(f32) for i in range(3)]
    rd = [r_diag[i].to(f32) for i in range(6)]
    lam = torch.as_tensor(lambda_m, dtype=f32, device=dev)
    eps = torch.as_tensor(epsilon, dtype=f32, device=dev)
    hv = have[:, None]

    # ---- motion predict -----------------------------------------------------
    rpy = [col(rpy_t[:, i]) for i in range(3)]
    db = [col(disp_base[:, i]) for i in range(3)]
    sr, cr = torch.sin(rpy[0]), torch.cos(rpy[0])
    sp, cp = torch.sin(rpy[1]), torch.cos(rpy[1])
    sy, cy = torch.sin(rpy[2]), torch.cos(rpy[2])
    R = _rot_entries(sr, cr, sp, cp, sy, cy)
    dR = _drot_entries(sr, cr, sp, cp, sy, cy)
    mu_in = [col(mu[:, i]) for i in range(6)]
    sig_in = [[col(Sigma[:, i, j]) for j in range(6)] for i in range(6)]

    mu_p = [mu_in[i] + sum(R[i][j] * db[j] for j in range(3)) for i in range(3)]
    mu_a = [wrap_angle(rpy[i]) for i in range(3)]
    J = [[sum(dR[k][i][j] * db[j] for j in range(3)) for k in range(3)]
         for i in range(3)]
    T = [[sum(J[i][k] * sig_in[3 + k][j] for k in range(3)) for j in range(3)]
         for i in range(3)]
    U = [[sum(J[i][k] * sig_in[3 + k][3 + j] for k in range(3)) for j in range(3)]
         for i in range(3)]
    UJt = [[sum(U[i][k] * J[j][k] for k in range(3)) for j in range(3)]
           for i in range(3)]
    sig = [[None] * 6 for _ in range(6)]
    for i in range(3):
        for j in range(3):
            sig[i][j] = sig_in[i][j] + T[i][j] + T[j][i] + UJt[i][j]
            sig[i][3 + j] = sig_in[i][j] * 0.0
            sig[3 + i][j] = sig_in[i][j] * 0.0
            sig[3 + i][3 + j] = sig_in[i][j] * 0.0
    for i in range(6):
        sig[i][i] = sig[i][i] + rd[i]
    mu_w = mu_p + mu_a

    # ---- M sequential greedy-ML updates ------------------------------------
    mx = map_pos[:, 0].to(f32)[None, :]
    my = map_pos[:, 1].to(f32)[None, :]
    mz = map_pos[:, 2].to(f32)[None, :]
    mmask = map_mask[None, :]
    iota_n = torch.arange(N, dtype=f32, device=dev)[None, :]
    matches = []
    for m in range(M):
        zm = [col(z[:, m, i]) for i in range(3)]
        zvalid = z_valid[:, m][:, None]
        sr, cr = torch.sin(mu_w[3]), torch.cos(mu_w[3])
        sp, cp = torch.sin(mu_w[4]), torch.cos(mu_w[4])
        sy, cy = torch.sin(mu_w[5]), torch.cos(mu_w[5])
        R = _rot_entries(sr, cr, sp, cp, sy, cy)
        dR = _drot_entries(sr, cr, sp, cp, sy, cy)

        diff = [mx - mu_w[0], my - mu_w[1], mz - mu_w[2]]            # (B, N)
        zh = [sum(R[j][i] * diff[j] for j in range(3)) for i in range(3)]
        Ha = [[sum(dR[k][j][i] * diff[j] for j in range(3)) for k in range(3)]
              for i in range(3)]
        Hp = [[-R[j][i] for j in range(3)] for i in range(3)]

        def Hcol(a, c):
            return Hp[a][c] if c < 3 else Ha[a][c - 3]

        W = [[sum(Hcol(a, c) * sig[c][d] for c in range(6)) for d in range(6)]
             for a in range(3)]
        S = [[None] * 3 for _ in range(3)]
        for a in range(3):
            for b in range(a, 3):
                s = sum(W[a][d] * Hcol(b, d) for d in range(6))
                if a == b:
                    s = s + qd[a]
                S[a][b] = s
                S[b][a] = s

        c00 = S[1][1] * S[2][2] - S[1][2] * S[1][2]
        c01 = S[0][2] * S[1][2] - S[0][1] * S[2][2]
        c02 = S[0][1] * S[1][2] - S[0][2] * S[1][1]
        det = S[0][0] * c00 + S[0][1] * c01 + S[0][2] * c02
        det = torch.clamp_min(det, 1e-30)
        inv_det = 1.0 / det
        Si = [[None] * 3 for _ in range(3)]
        Si[0][0] = c00 * inv_det
        Si[0][1] = c01 * inv_det
        Si[0][2] = c02 * inv_det
        Si[1][1] = (S[0][0] * S[2][2] - S[0][2] * S[0][2]) * inv_det
        Si[1][2] = (S[0][1] * S[0][2] - S[0][0] * S[1][2]) * inv_det
        Si[2][2] = (S[0][0] * S[1][1] - S[0][1] * S[0][1]) * inv_det
        Si[1][0] = Si[0][1]
        Si[2][0] = Si[0][2]
        Si[2][1] = Si[1][2]

        nu = [zm[i] - zh[i] for i in range(3)]
        dm = sum(nu[a] * Si[a][b] * nu[b] for a in range(3) for b in range(3))
        logpsi = -0.5 * (dm + torch.log(det))
        t = torch.tan(wrap_angle(math.pi / 2.0 + mu_w[5]))
        pregate = eps > torch.abs((mx - mu_w[0]) + (mu_w[1] - my) / t)
        ok = mmask & pregate & (dm < lam) & zvalid
        score = torch.where(ok, logpsi, _NEG)

        best_score = torch.amax(score, dim=1, keepdim=True)               # (B, 1)
        upd = best_score > 0.5 * _NEG
        best_ix = torch.amin(torch.where(score == best_score, iota_n, float(N)),
                             dim=1, keepdim=True)                         # first max
        ix = best_ix.long()

        def pick(q):
            return torch.gather(q.expand(B, N), 1, ix)                   # (B, 1)

        Hb = [[Hp[a][c] if c < 3 else pick(Ha[a][c - 3]) for c in range(6)]
              for a in range(3)]
        Sib = [[pick(Si[a][b]) for b in range(3)] for a in range(3)]
        nub = [pick(nu[a]) for a in range(3)]

        HS = [[sum(Hb[a][c] * Sib[a][b] for a in range(3)) for b in range(3)]
              for c in range(6)]
        K = [[sum(sig[i][c] * HS[c][b] for c in range(6)) for b in range(3)]
             for i in range(6)]
        dmu = [sum(K[i][b] * nub[b] for b in range(3)) for i in range(6)]
        mu_new = [mu_w[i] + torch.where(upd, dmu[i], 0.0) for i in range(6)]
        for i in range(3, 6):
            mu_new[i] = torch.where(upd, wrap_angle(mu_new[i]), mu_new[i])
        KH = [[sum(K[i][b] * Hb[b][j] for b in range(3)) for j in range(6)]
              for i in range(6)]
        sig = [[sig[i][j] - torch.where(upd, sum(KH[i][c] * sig[c][j] for c in range(6)), 0.0)
                for j in range(6)] for i in range(6)]
        mu_w = mu_new
        matches.append(torch.where(upd, best_ix, -1.0))

    # ---- no-input rebroadcast: the whole tick is discarded ------------------
    mu_out = torch.cat([torch.where(hv, mu_w[i], mu_in[i]) for i in range(6)], 1)
    sig_out = torch.stack([torch.cat([torch.where(hv, sig[i][j], sig_in[i][j])
                                      for j in range(6)], 1) for i in range(6)], 1)
    return mu_out, sig_out, torch.cat(matches, 1).to(torch.int32)


def _lib():
    fn = _build.load("loc_tick").loc_tick_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def pack_params(map_pos, map_mask, q_diag, r_diag, lambda_m, epsilon):
    """The kernel's constant inputs: the map as (N, 4) rows [x, y, z, mask]
    and the 16 parameters [q (3), r (6), λ, ε, 0...]."""
    dev = map_pos.device
    f32 = torch.float32
    map4 = torch.cat([map_pos.to(f32), map_mask.to(f32)[:, None]], 1).contiguous()
    par = torch.zeros(16, dtype=f32, device=dev)
    par[0:3] = q_diag
    par[3:9] = r_diag
    par[9] = torch.as_tensor(lambda_m, dtype=f32, device=dev)
    par[10] = torch.as_tensor(epsilon, dtype=f32, device=dev)
    return map4, par


def pack_tick(rpy_t, disp_base, have, z, z_valid):
    """One tick's inputs as the kernel reads them: (B, 8) rows [rpy (3),
    disp (3), have, 0] and (B, M, 4) detections [z (3), valid]."""
    f32 = torch.float32
    B = rpy_t.shape[0]
    tick8 = torch.cat([rpy_t.to(f32), disp_base.to(f32), have.to(f32)[:, None],
                       torch.zeros(B, 1, dtype=f32, device=rpy_t.device)], 1)
    z4 = torch.cat([z.to(f32), z_valid.to(f32)[..., None]], 2)
    return tick8.contiguous(), z4.contiguous()


def _unpacked_reference(mu, sig36, tick8, z4, map4, par):
    """``fleet_tick_reference`` on the packed inputs -> (μ, Σ (B, 36), matches)."""
    B = mu.shape[0]
    m, S, match = fleet_tick_reference(
        mu, sig36.reshape(B, 6, 6), tick8[:, 0:3], tick8[:, 3:6], tick8[:, 6] > 0.5,
        z4[..., 0:3], z4[..., 3] > 0.5, map4[:, 0:3], map4[:, 3] > 0.5,
        par[0:3], par[3:9], par[9], par[10])
    return m, S.reshape(B, 36), match


def _check_packed(mu, sig36, tick8, z4, map4, par, what):
    dev = mu.device
    B, M, N = mu.shape[0], z4.shape[1], map4.shape[0]
    f32 = torch.float32
    c = _tensors.check
    c(mu, "mu", (B, 6), f32, dev)
    c(sig36, "Sigma", (B, 36), f32, dev)
    c(tick8, "tick", (B, 8), f32, dev)
    c(z4, "z", (B, M, 4), f32, dev)
    c(map4, "map", (N, 4), f32, dev)
    c(par, "par", (16,), f32, dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on CUDA or CPU tensors, not {dev}")
    if B < 1 or not 1 <= M <= MAX_M or not 1 <= N <= MAX_N:
        raise ValueError(f"{what}: needs B >= 1, 1 <= M <= {MAX_M} and 1 <= N <= {MAX_N}, "
                         f"got B={B} M={M} N={N}")


def fleet_tick(mu, Sigma, rpy_t, disp_base, have, z, z_valid, map_pos, map_mask,
               q_diag, r_diag, lambda_m, epsilon):
    """One whole fleet tick -> (mu' (B, 6), Sigma' (B, 6, 6), matches (B, M)
    int32, -1 where a detection matched nothing)."""
    B, M = z.shape[0], z.shape[1]
    map4, par = pack_params(map_pos, map_mask, q_diag, r_diag, lambda_m, epsilon)
    tick8, z4 = pack_tick(rpy_t, disp_base, have, z, z_valid)
    sig36 = Sigma.reshape(B, 36).contiguous()
    mu = mu.contiguous()
    _check_packed(mu, sig36, tick8, z4, map4, par, "fleet_tick")
    if mu.device.type == "cpu":
        m, S, match = _unpacked_reference(mu, sig36, tick8, z4, map4, par)
        return m, S.reshape(B, 6, 6), match
    mu_out, sig_out = torch.empty_like(mu), torch.empty_like(sig36)
    match = torch.empty((B, M), dtype=torch.int32, device=mu.device)
    _run_kernel(B, M, map4.shape[0], mu, sig36, tick8, z4, map4, par, mu_out, sig_out,
                match, None)
    return mu_out, sig_out.reshape(B, 6, 6), match


fleet_tick.launches = 0


def _run_kernel(B, M, N, mu, sig36, tick8, z4, map4, par, mu_out, sig_out, match_out,
                sigd_out):
    """One K9 launch; every pointer argument is a tensor or an int address."""
    dev = map4.device
    p = [a if isinstance(a, int) else (0 if a is None else a.data_ptr())
         for a in (mu, sig36, tick8, z4, map4, par, mu_out, sig_out, match_out, sigd_out)]
    rc = _lib()(_tensors.device_index(dev), _tensors.stream(dev), B, N, M,
                *(ctypes.c_void_p(v or None) for v in p))
    _build.check(rc, "fleet_tick")
    fleet_tick.launches += 1


def run_ticks(mu0, sig0, tick_t, z_t, map4, par, graph: bool = True):
    """The fleet replay's tick loop: T ticks from state (mu0 (B, 6), sig0
    (B, 36)) on the packed inputs tick_t (T, B, 8), z_t (T, B, M, 4) ->
    (mu (T, B, 6), sigma_diag (T, B, 6), matches (T, B, M) int32, final Σ
    (B, 36)). On the card: one launch per tick, nothing between launches,
    replayed as a cached CUDA graph unless ``graph=False``."""
    T, B, M = z_t.shape[0], z_t.shape[1], z_t.shape[2]
    dev = mu0.device
    f32 = torch.float32
    _tensors.check(tick_t, "tick", (T, B, 8), f32, dev)
    _tensors.check(z_t, "z", (T, B, M, 4), f32, dev)
    _check_packed(mu0, sig0, tick_t[0], z_t[0], map4, par, "run_ticks")
    if dev.type == "cpu":
        mu_t = torch.empty((T, B, 6), dtype=f32, device=dev)
        sigd_t = torch.empty((T, B, 6), dtype=f32, device=dev)
        match_t = torch.empty((T, B, M), dtype=torch.int32, device=dev)
        mu, s = mu0, sig0
        for t in range(T):
            mu, s, match = _unpacked_reference(mu, s, tick_t[t], z_t[t], map4, par)
            mu_t[t], match_t[t] = mu, match
            sigd_t[t] = s[:, ::7]
        return mu_t, sigd_t, match_t, s
    inp = dict(mu0=mu0, sig0=sig0, tick=tick_t, z=z_t, map4=map4, par=par)
    if graph:
        return graphs.run("loc_kernels.run_ticks", _kernel_ticks, inp)
    return _kernel_ticks(inp)


def _kernel_ticks(inp: dict):
    """``run_ticks``' loop on the card, on its checked (contiguous) inputs:
    one K9 launch per tick on pointer offsets into the (T, B, ...) tensors.
    Capture-safe."""
    tick_t, z_t, map4, par = inp["tick"], inp["z"], inp["map4"], inp["par"]
    T, B, M = z_t.shape[0], z_t.shape[1], z_t.shape[2]
    N = map4.shape[0]
    dev, f32 = tick_t.device, torch.float32
    mu_t = torch.empty((T, B, 6), dtype=f32, device=dev)
    sigd_t = torch.empty((T, B, 6), dtype=f32, device=dev)
    match_t = torch.empty((T, B, M), dtype=torch.int32, device=dev)
    sig = torch.empty((2, B, 36), dtype=f32, device=dev)
    # byte strides of one tick in each (T, B, ...) tensor (f32 and int32)
    mu_p, sig_p = inp["mu0"].data_ptr(), inp["sig0"].data_ptr()
    tick_p, z_p = tick_t.data_ptr(), z_t.data_ptr()
    step_tick, step_z, step_mu, step_m = B * 8 * 4, B * M * 4 * 4, B * 6 * 4, B * M * 4
    buf = [sig[0].data_ptr(), sig[1].data_ptr()]
    mu_o, sigd_o, match_o = mu_t.data_ptr(), sigd_t.data_ptr(), match_t.data_ptr()
    for t in range(T):
        out_sig = buf[t & 1]
        _run_kernel(B, M, N, mu_p, sig_p, tick_p + t * step_tick, z_p + t * step_z, map4, par,
                    mu_o + t * step_mu, out_sig, match_o + t * step_m, sigd_o + t * step_mu)
        mu_p, sig_p = mu_o + t * step_mu, out_sig
    return mu_t, sigd_t, match_t, sig[(T - 1) & 1]
