"""K10: the whole 15-state (robot_localization) EKF fleet tick.

``fleet15_tick`` launches the CUDA kernel ``csrc/ekf15_tick.cu`` for CUDA
tensors and takes its plain PyTorch version ``fleet15_tick_reference`` for
CPU tensors. ``run_fleet15`` is the fleet replay: it stages the (T, B, rows)
tick inputs in PyTorch and then launches K10 once per tick, each launch
writing x and diag(P) of its tick straight into preallocated (T, B, 15)
outputs. They replace the TPU kernel of
``smarc_navigation_tpu/ops/ekf15_kernels.py`` (``_run_fleet15_jit``, body
``_make_ekf15_kernel``) and keep ``run_fleet15``'s signature.

One tick, per mission: the omega-kinematics predict with the analytic
sparse Jacobian (A = F − I in blocks A1, A2, A3, B1, B2; Pn entry by entry
as P + AP + (AP)ᵀ + APAᵀ + q·dt, the same value written to (i, j) and
(j, i)), the control-shaped acceleration, then one exact-subspace update per
sensor: with the k measured components m, S = P[m, m] + diag(r_m), a k×k
Cholesky, K = P[:, m] S⁻¹, x += Kν, P − ½(K P[m, :] + (K P[m, :])ᵀ), gated by
the sensor's apply flag. The sensor wiring, static in the reference, is the
``Ekf15Wiring`` the wrapper passes by value.

The plain version transcribes the TPU kernel's body and its
``_chol_solve_cols`` in their operation order, over (B,) columns.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import numpy as np
import torch

from .. import _build, _tensors
from ..utils import graphs
from ..utils.geometry import wrap_angle
from .loc_kernels import _drot_entries, _rot_entries

_ANGLES = (3, 4, 5)
MAX_SENSORS = 8
MAX_K = 6


@dataclasses.dataclass(frozen=True)
class Ekf15Wiring:
    """The static sensor wiring of one filter: per sensor the measured state
    indices and their noise (floored at 1e-9), the process noise diagonal,
    the control shaping. The tick input holds, after its four leading rows
    (dt, cmd x, cmd y, cmd valid), each sensor's k values and apply flag."""

    sensor_idx: Tuple[Tuple[int, ...], ...]
    sensor_noise: Tuple[Tuple[float, ...], ...]
    q_diag: Tuple[float, ...]
    gains: Tuple[float, ...]
    limits: Tuple[float, ...]
    use_control: bool

    @property
    def rows(self) -> int:
        return 4 + sum(len(ix) + 1 for ix in self.sensor_idx)


class _CWiring(ctypes.Structure):
    _fields_ = [("n_sens", ctypes.c_int), ("k", ctypes.c_int * MAX_SENSORS),
                ("idx", ctypes.c_int * (MAX_SENSORS * MAX_K)),
                ("row", ctypes.c_int * MAX_SENSORS),
                ("noise", ctypes.c_float * (MAX_SENSORS * MAX_K)),
                ("q", ctypes.c_float * 15), ("gain", ctypes.c_float * 3),
                ("lim", ctypes.c_float * 3), ("use_control", ctypes.c_int)]


def _c_wiring(w: Ekf15Wiring) -> _CWiring:
    if len(w.sensor_idx) > MAX_SENSORS or any(not 1 <= len(ix) <= MAX_K for ix in w.sensor_idx):
        raise ValueError(f"fleet15_tick takes at most {MAX_SENSORS} sensors of 1-{MAX_K} "
                         f"components, got {w.sensor_idx}")
    c = _CWiring()
    c.n_sens = len(w.sensor_idx)
    row = 4
    for s, (ix, nz) in enumerate(zip(w.sensor_idx, w.sensor_noise)):
        c.k[s] = len(ix)
        c.row[s] = row
        row += len(ix) + 1
        for a, (i, r) in enumerate(zip(ix, nz)):
            c.idx[s * MAX_K + a] = i
            c.noise[s * MAX_K + a] = r
    for i in range(15):
        c.q[i] = w.q_diag[i]
    for i in range(3):
        c.gain[i] = w.gains[i]
        c.lim[i] = w.limits[i]
    c.use_control = int(w.use_control)
    return c


def wiring(cfg, channels) -> Tuple[Ekf15Wiring, Tuple[str, ...], Tuple[float, ...], bool]:
    """The wiring of ``cfg``'s sensors that ``channels`` carries, their
    channel names and timeouts, and whether the cmd_vel control is fed."""
    sensors = [s for s in cfg.sensors if s.channel in channels]
    idx = [np.where(np.asarray(s.mask))[0] for s in sensors]
    w = Ekf15Wiring(
        sensor_idx=tuple(tuple(int(i) for i in ix) for ix in idx),
        sensor_noise=tuple(tuple(float(max(np.asarray(s.noise_diag)[i], 1e-9)) for i in ix)
                           for s, ix in zip(sensors, idx)),
        q_diag=tuple(float(q) for q in cfg.process_noise_diag),
        gains=tuple(float(g) for g in cfg.control_gains),
        limits=tuple(float(v) for v in cfg.control_limits),
        use_control=bool(cfg.use_control),
    )
    names = tuple(s.channel for s in sensors)
    timeouts = tuple(float(s.timeout_s) for s in sensors)
    return w, names, timeouts, bool(cfg.use_control) and "cmd_vel" in channels


def _chol_solve_cols(S, RHS, k, n_rhs):
    """X (n_rhs × k) = RHS S⁻¹ by a componentwise Cholesky S = LLᵀ and two
    triangular solves per RHS row (the reference kernel's order)."""
    L = [[None] * k for _ in range(k)]
    for j in range(k):
        d = S[j][j] - sum(L[j][p] * L[j][p] for p in range(j))
        L[j][j] = torch.sqrt(torch.clamp_min(d, 1e-20))
        inv_ljj = 1.0 / L[j][j]
        for i in range(j + 1, k):
            off = S[i][j] - sum(L[i][p] * L[j][p] for p in range(j))
            L[i][j] = off * inv_ljj
    X = []
    for r in range(n_rhs):
        y = [None] * k
        for i in range(k):
            y[i] = (RHS[r][i] - sum(L[i][p] * y[p] for p in range(i))) / L[i][i]
        x = [None] * k
        for i in reversed(range(k)):
            x[i] = (y[i] - sum(L[j][i] * x[j] for j in range(i + 1, k))) / L[i][i]
        X.append(x)
    return X


def fleet15_tick_reference(x, P, tick, w: Ekf15Wiring):
    """Plain PyTorch version of ``fleet15_tick``: x (B, 15), P (B, 15, 15),
    tick (B, rows) -> (x', P')."""
    xs = [x[:, i] for i in range(15)]
    Ps = [[P[:, i, j] for j in range(15)] for i in range(15)]
    dt = tick[:, 0]

    # ---- control shaping (gain·(cmd − v) clamped) ----------------------------
    a_cmd = [xs[0] * 0.0 for _ in range(3)]
    if w.use_control:
        cmd_ok = tick[:, 3] > 0.5
        for i in range(2):
            g, lim = w.gains[i], w.limits[i]
            raw = g * (tick[:, 1 + i] - xs[6 + i])
            raw = torch.clamp(raw, -lim, lim)
            a_cmd[i] = torch.where(cmd_ok, raw, 0.0)

    a_eff = [xs[12 + i] + a_cmd[i] for i in range(3)]
    v = [xs[6 + i] for i in range(3)]
    wr = [xs[9 + i] for i in range(3)]
    sr, cr = torch.sin(xs[3]), torch.cos(xs[3])
    sp, cp = torch.sin(xs[4]), torch.cos(xs[4])
    sy, cy = torch.sin(xs[5]), torch.cos(xs[5])
    R = _rot_entries(sr, cr, sp, cp, sy, cy)
    dR = _drot_entries(sr, cr, sp, cp, sy, cy)

    # Euler rate matrix E and its roll/pitch derivatives
    tp = sp / cp
    inv_cp = 1.0 / cp
    E = [[cy * 0.0 + 1.0, sr * tp, cr * tp],
         [cy * 0.0, cr, -sr],
         [cy * 0.0, sr * inv_cp, cr * inv_cp]]
    dE_dr = [[cy * 0.0, cr * tp, -sr * tp],
             [cy * 0.0, -sr, -cr],
             [cy * 0.0, cr * inv_cp, -sr * inv_cp]]
    sec2 = inv_cp * inv_cp
    dE_dp = [[cy * 0.0, sr * sec2, cr * sec2],
             [cy * 0.0, cy * 0.0, cy * 0.0],
             [cy * 0.0, sr * tp * inv_cp, cr * tp * inv_cp]]

    # displacement d = v dt + a dt²/2 (body), pos' = pos + R d
    half_dt2 = 0.5 * dt * dt
    d = [v[i] * dt + a_eff[i] * half_dt2 for i in range(3)]
    x_new = [None] * 15
    for i in range(3):
        x_new[i] = xs[i] + sum(R[i][j] * d[j] for j in range(3))
    wdt = [wr[i] * dt for i in range(3)]
    for i in range(3):
        x_new[3 + i] = wrap_angle(xs[3 + i] + sum(E[i][j] * wdt[j] for j in range(3)))
    for i in range(3):
        x_new[6 + i] = v[i] + a_eff[i] * dt
        x_new[9 + i] = wr[i]
        x_new[12 + i] = xs[12 + i]

    # ---- Jacobian blocks (A = F − I, sparse) ---------------------------------
    A1 = [[sum(dR[k][i][j] * d[j] for j in range(3)) for k in range(3)] for i in range(3)]
    A2 = [[R[i][j] * dt for j in range(3)] for i in range(3)]
    A3 = [[R[i][j] * half_dt2 for j in range(3)] for i in range(3)]
    dE = [dE_dr, dE_dp, None]
    B1 = [[(sum(dE[k][i][j] * wdt[j] for j in range(3)) if k < 2 else cy * 0.0)
           for k in range(3)] for i in range(3)]
    B2 = [[E[i][j] * dt for j in range(3)] for i in range(3)]

    def Arow(i):  # (col, coeff) pairs of row i of A
        if i < 3:
            return ([(3 + j, A1[i][j]) for j in range(3)] + [(6 + j, A2[i][j]) for j in range(3)]
                    + [(12 + j, A3[i][j]) for j in range(3)])
        if i < 6:
            return [(3 + j, B1[i - 3][j]) for j in range(3)] + [(9 + j, B2[i - 3][j]) for j in range(3)]
        if i < 9:
            return [(12 + (i - 6), dt)]
        return []

    AP = [[sum(c * Ps[col][j] for col, c in Arow(i)) for j in range(15)] for i in range(9)]

    def APA(i, j):
        return sum(AP[i][col] * c for col, c in Arow(j))

    Pn = [[None] * 15 for _ in range(15)]
    for i in range(15):
        for j in range(i, 15):
            val = Ps[i][j]
            if i < 9:
                val = val + AP[i][j]
            if j < 9:
                val = val + AP[j][i]
            if i < 9 and j < 9:
                val = val + APA(i, j)
            if i == j:
                val = val + w.q_diag[i] * dt
            Pn[i][j] = val
            Pn[j][i] = val
    xs, Ps = x_new, Pn

    # ---- sensor updates (exact subspace) -------------------------------------
    row = 4
    for idx, noise in zip(w.sensor_idx, w.sensor_noise):
        k = len(idx)
        z = [tick[:, row + i] for i in range(k)]
        apply_f = tick[:, row + k] > 0.5
        row += k + 1
        nu = []
        for i, c in enumerate(idx):
            d_ = z[i] - xs[c]
            nu.append(wrap_angle(d_) if c in _ANGLES else d_)
        S = [[Ps[idx[a]][idx[b]] + (noise[a] if a == b else 0.0) for b in range(k)]
             for a in range(k)]
        RHS = [[Ps[r][idx[b]] for b in range(k)] for r in range(15)]
        K = _chol_solve_cols(S, RHS, k, 15)

        x2 = [xs[i] + sum(K[i][b] * nu[b] for b in range(k)) for i in range(15)]
        for c in _ANGLES:
            x2[c] = wrap_angle(x2[c])
        P2 = [[None] * 15 for _ in range(15)]
        for i in range(15):
            for j in range(i, 15):
                dij = sum(K[i][b] * Ps[idx[b]][j] for b in range(k))
                dji = sum(K[j][b] * Ps[idx[b]][i] for b in range(k))
                val = Ps[i][j] - 0.5 * (dij + dji)
                P2[i][j] = val
                P2[j][i] = val
        xs = [torch.where(apply_f, x2[i], xs[i]) for i in range(15)]
        Ps = [[torch.where(apply_f, P2[i][j], Ps[i][j]) for j in range(15)] for i in range(15)]

    return (torch.stack(xs, 1),
            torch.stack([torch.stack(Ps[i], 1) for i in range(15)], 1))


def _lib():
    fn = _build.load("ekf15_tick").ekf15_tick_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                        ctypes.POINTER(_CWiring)] + [ctypes.c_void_p] * 6)
        fn.restype = ctypes.c_int
    return fn


def _check(x, P, tick, w: Ekf15Wiring, what):
    dev = x.device
    B = x.shape[0]
    f32 = torch.float32
    _tensors.check(x, "x", (B, 15), f32, dev)
    _tensors.check(P, "P", (B, 15, 15), f32, dev)
    _tensors.check(tick, "tick", (B, w.rows), f32, dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on CUDA or CPU tensors, not {dev}")


def _run_kernel(B, w_c, rows, dev, x, P, tick, x_out, P_out, pd_out):
    """One K10 launch; every pointer argument is a tensor or an int address."""
    p = [a if isinstance(a, int) else (0 if a is None else a.data_ptr())
         for a in (x, P, tick, x_out, P_out, pd_out)]
    rc = _lib()(_tensors.device_index(dev), _tensors.stream(dev), B, rows, ctypes.byref(w_c),
                *(ctypes.c_void_p(v or None) for v in p))
    _build.check(rc, "fleet15_tick")
    fleet15_tick.launches += 1


def fleet15_tick(x, P, tick, w: Ekf15Wiring):
    """One whole fleet tick: x (B, 15), P (B, 15, 15), tick (B, rows) ->
    (x' (B, 15), P' (B, 15, 15))."""
    _check(x, P, tick, w, "fleet15_tick")
    if x.device.type == "cpu":
        return fleet15_tick_reference(x, P, tick, w)
    x_out, P_out = torch.empty_like(x), torch.empty_like(P)
    _run_kernel(x.shape[0], _c_wiring(w), w.rows, x.device, x, P, tick, x_out, P_out, None)
    return x_out, P_out


fleet15_tick.launches = 0


def run_ticks15(x0, P0, tick_t, w: Ekf15Wiring, graph: bool = True):
    """The fleet replay's tick loop: T ticks from (x0 (B, 15), P0 (B, 15,
    15)) on tick_t (T, B, rows) -> (x (T, B, 15), p_diag (T, B, 15), final
    P). On the card: one launch per tick, nothing between launches,
    replayed as a CUDA graph cached per shape and wiring unless
    ``graph=False``."""
    T, B = tick_t.shape[0], tick_t.shape[1]
    dev, f32 = x0.device, torch.float32
    _tensors.check(tick_t, "tick", (T, B, w.rows), f32, dev)
    _check(x0, P0, tick_t[0], w, "run_ticks15")
    if dev.type == "cpu":
        x_t = torch.empty((T, B, 15), dtype=f32, device=dev)
        pd_t = torch.empty((T, B, 15), dtype=f32, device=dev)
        x, P = x0, P0
        for t in range(T):
            x, P = fleet15_tick_reference(x, P, tick_t[t], w)
            x_t[t], pd_t[t] = x, torch.diagonal(P, dim1=1, dim2=2)
        return x_t, pd_t, P
    inp = dict(x0=x0, P0=P0, tick=tick_t)
    if graph:
        # the wiring goes into every launch by value: the capture bakes it in
        return graphs.run(("ekf15_kernels.run_ticks15", w), lambda x: _kernel_ticks15(x, w), inp)
    return _kernel_ticks15(inp, w)


def _kernel_ticks15(inp: dict, w: Ekf15Wiring):
    """``run_ticks15``' loop on the card, on its checked (contiguous)
    inputs: one K10 launch per tick on pointer offsets into the (T, B, ...)
    tensors. Capture-safe."""
    tick_t = inp["tick"]
    T, B = tick_t.shape[0], tick_t.shape[1]
    dev, f32 = tick_t.device, torch.float32
    x_t = torch.empty((T, B, 15), dtype=f32, device=dev)
    pd_t = torch.empty((T, B, 15), dtype=f32, device=dev)
    w_c = _c_wiring(w)
    rows = w.rows
    Pbuf = torch.empty((2, B, 15, 15), dtype=f32, device=dev)
    buf = [Pbuf[0].data_ptr(), Pbuf[1].data_ptr()]
    # byte strides of one tick in the (T, B, ...) tensors
    step_x, step_tick = B * 15 * 4, B * rows * 4
    x_p, P_p, tick_p = inp["x0"].data_ptr(), inp["P0"].data_ptr(), tick_t.data_ptr()
    x_o, pd_o = x_t.data_ptr(), pd_t.data_ptr()
    for t in range(T):
        _run_kernel(B, w_c, rows, dev, x_p, P_p, tick_p + t * step_tick, x_o + t * step_x,
                    buf[t & 1], pd_o + t * step_x)
        x_p, P_p = x_o + t * step_x, buf[t & 1]
    return x_t, pd_t, Pbuf[(T - 1) & 1]


def stage_ticks15(batched_timeline, cfg):
    """The fleet replay's tick inputs -> (tick (T, B, rows) f32, wiring):
    dt by ``diff`` with 0 prepended, cmd x/y and valid, and per wired
    sensor its k values and fresh & (age < timeout)."""
    tl = batched_timeline
    B, T = tl.ticks.shape
    dev, f32 = tl.ticks.device, torch.float32
    w, names, timeouts, use_cmd = wiring(cfg, tl.channels)
    ticks = tl.ticks.to(f32)
    parts = [torch.diff(ticks, dim=1, prepend=torch.zeros((B, 1), dtype=f32, device=dev))[..., None]]
    if use_cmd:
        cmd = tl.channels["cmd_vel"]
        parts += [cmd.value[..., 0:2], cmd.valid[..., None]]
    else:
        parts.append(torch.zeros((B, T, 3), dtype=f32, device=dev))
    for name, ix, to in zip(names, w.sensor_idx, timeouts):
        ch = tl.channels[name]
        parts += [ch.value[..., list(ix)], (ch.fresh & (ch.age < to))[..., None]]
    return torch.cat([p.to(f32) for p in parts], 2).transpose(0, 1).contiguous(), w


def run_fleet15(batched_timeline, cfg, x0=None, graph: bool = True):
    """Fleet replay of the 15-state EKF, one K10 launch per tick.

    ``batched_timeline`` leaves are (B, T, ...) tensors (``fleet.
    batch_timelines`` of ``ekf_15state.ekf15_timeline`` outputs). Returns
    (final (x (B, 15), P (B, 15, 15)), {"x": (T, B, 15), "p_diag": (T, B,
    15)}). Sensor wiring, process noise and control shaping are read from
    ``cfg`` as the dense ``ekf_15state.run`` reads them. ``graph``: see
    ``run_ticks15``."""
    from ..models import ekf_15state as e15

    B = batched_timeline.ticks.shape[0]
    tick_t, w = stage_ticks15(batched_timeline, cfg)
    s0 = e15.init_state(cfg, x0=x0, device=tick_t.device)
    x_t, pd_t, P = run_ticks15(s0.x.expand(B, 15).contiguous(),
                               s0.P.expand(B, 15, 15).contiguous(), tick_t, w, graph)
    return (x_t[-1], P), {"x": x_t, "p_diag": pd_t}
