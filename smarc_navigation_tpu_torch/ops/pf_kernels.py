"""K5-K8 and K13: the particle-filter kernels (PyTorch port of
``smarc_navigation_tpu/ops/pf_kernels.py``).

``predict_call_multi`` (K5) and ``predict_call`` (K6) launch
``csrc/pf_predict.cu``; ``expand_gather_call`` (K7), its window form
``expand_gather_window_call`` (a particle shard's slots from a
halo-extended window, ``parallel.resample_dist``) and
``jitter_moments_call`` (K8) launch ``csrc/pf_resample.cu``;
``gps_weights_call`` (K13, the GPS update's normalised weights, which the
JAX package leaves to XLA) launches ``csrc/pf_update.cu``, beside K14
(``resampling.systematic_counts``). Each wrapper
checks its arguments on every device (K13 on CUDA tensors: on the CPU its
plain version takes what it took before it), takes its plain PyTorch version
(``<name>_reference``, same signature) for CPU tensors, and launches the
kernel or raises for CUDA tensors; each counts its launches.

What the TPU kernels compute, kept here: the fused PF predict (Box-Muller
x/y/yaw noise, yaw integration and wrap, body->world step, absolute
z/roll/pitch substitution) with the per-tick pose moments accumulated on
the way, over up to K ticks per call; the ancestor expansion of monotone
systematic counts with the bank gather; and the x/y/yaw resample jitter
with the post-resample moments.

What is the TPU's and is not carried over: the (8, 128) lane partials, the
VMEM chunk size (``chunk``), the merged DMA windows with their ``W`` ladder
and exact fallback (``starts``, ``heads``, ``block``, ``batch``), the
bf16 one-hot matmul, and the polynomial sin/ln. Moment sums here are
(..., 8, P) partials, one per group of ``SUM_GROUP`` particles
(``finalize_moments`` sums the last axis either way).

Random numbers come from one counter-based generator, written once in
``csrc/pf_rng.cuh`` and once below in torch integer ops, keyed on
(seed, global particle index, draw index) and never on a block id: the
stream does not depend on the launch shape, the kernel and its plain
version draw bit-identical uniforms, and K8's ``seed_off`` and K5/K6's
``idx_off`` are particle offsets (a shard passes its first global index).
The TPU's hardware PRNG bits cannot be reproduced, so the port is held to
the JAX package with zero noise stds or by statistics.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build, _tensors
from ..utils.geometry import rpy_from_quat, wrap_angle
from . import resampling

N_SUMS = 8          # sx, sy, sxx, syy, sxy, s_sin, s_cos, count
SUM_GROUP = 1024    # particles per moment partial (256 threads x 4 particles)
MAX_K = 64          # ticks per K5 call (per-tick parameters live in shared memory)

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_TWO_PI = 2.0 * math.pi


def n_partials(n: int) -> int:
    """Moment partials of an n-particle bank."""
    return (n + SUM_GROUP - 1) // SUM_GROUP


# ---------------------------------------------------------------------------
# counter-based generator (bitwise the device functions of csrc/pf_rng.cuh)
# ---------------------------------------------------------------------------
# uint32 values are held in int64 tensors. A product of two uint32 values
# may overflow int64, so a constant c >= 2^31 is split as 2^31 + c': x·c'
# stays below 2^63, and x·2^31 mod 2^32 is (x & 1) << 31. Only the low 32
# bits are kept, as in the CUDA source.

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    if c < 1 << 31:
        return (x * c) & _M32
    return (x * (c - (1 << 31)) + ((x & 1) << 31)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A bijective 32-bit integer hash (xorshift-multiply, two rounds)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _draw_key(seed: torch.Tensor, draw: int) -> torch.Tensor:
    """Per-(seed, draw) key: mix32(seed + golden * (draw + 1))."""
    s = seed.to(torch.int64) & _M32
    return _mix32((s + ((_GOLDEN * (draw + 1)) & _M32)) & _M32)


def split_keys(key: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n) child keys of keys (...,), int64 tensors of uint32 values:
    the counterpart of ``jax.random.split``. Child i is
    mix32(mix32(key ^ golden) + i), a stream apart from the draw keys that
    ``uniforms`` derives from the parent."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    k = _mix32((key.to(torch.int64) & _M32) ^ _GOLDEN)
    return _mix32((k[..., None] + i) & _M32)


def uniforms(seed, idx: torch.Tensor, draw: int) -> torch.Tensor:
    """(0, 1) f32 uniforms of draw ``draw`` for particles ``idx`` (int64,
    global indices) under ``seed``: 24 bits of mix32(mix32(idx ^ k) + k)."""
    seed = torch.as_tensor(seed, device=idx.device)
    k = _draw_key(seed, draw)
    b = _mix32((_mix32((idx & _M32) ^ k) + k) & _M32)
    return (b >> 8).to(torch.float32) * (1.0 / 16777216.0) + (0.5 / 16777216.0)


def normal_pair(seed, idx: torch.Tensor, draw: int):
    """Box-Muller over draws (draw, draw+1) -> (r cos 2πu, r sin 2πu)."""
    r = torch.sqrt(-2.0 * torch.log(uniforms(seed, idx, draw)))
    ang = _TWO_PI * uniforms(seed, idx, draw + 1)
    return r * torch.cos(ang), r * torch.sin(ang)


def uniforms_call(seed: int, n: int, draw: int, device, seed_off: int = 0) -> torch.Tensor:
    """The generator's raw uniforms of draw ``draw`` under ``seed`` for
    particles ``seed_off + [0, n)``: computed by the CUDA source's own device
    function on a CUDA device (to hold it bit for bit against ``uniforms``),
    by ``uniforms`` on the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        idx = torch.arange(n, dtype=torch.int64) + seed_off
        return uniforms(torch.tensor(seed, dtype=torch.int32), idx, draw)
    lib = _build.load("pf_resample")
    fn = lib.pf_uniforms_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    out = torch.empty(n, dtype=torch.float32, device=device)
    rc = fn(_tensors.device_index(device),
            _tensors.stream(device), n, int(seed), int(seed_off), int(draw), _tensors.ptr(out))
    _build.check(rc, "uniforms_call")
    return out


def normals3(seed, idx: torch.Tensor, nxy: bool = True, nyaw: bool = True):
    """Standard normals for x, y (draws 0-1) and yaw (draws 2-3); None for
    the components that are switched off."""
    nx = ny = nw = None
    if nxy:
        nx, ny = normal_pair(seed, idx, 0)
    if nyaw:
        nw, _ = normal_pair(seed, idx, 2)
    return nx, ny, nw


# ---------------------------------------------------------------------------
# moments
# ---------------------------------------------------------------------------

def _partials(v: torch.Tensor, p: int) -> torch.Tensor:
    pad = p * SUM_GROUP - v.shape[-1]
    if pad:
        v = torch.cat([v, v.new_zeros(pad)])
    return v.reshape(p, SUM_GROUP).sum(1)


def _moment_partials(x, y, sy, cy) -> torch.Tensor:
    """(8, P) moment partials of one bank state (the kernels' layout)."""
    n = x.shape[0]
    p = n_partials(n)
    count = torch.full((p,), float(SUM_GROUP), dtype=x.dtype, device=x.device)
    count[-1] = float(n - (p - 1) * SUM_GROUP)
    return torch.stack([_partials(x, p), _partials(y, p), _partials(x * x, p),
                        _partials(y * y, p), _partials(x * y, p),
                        _partials(sy, p), _partials(cy, p), count])


def moment_sums(parts: torch.Tensor) -> torch.Tensor:
    """(8, P) moment partials of a (6, N) bank, for refreshes outside the
    kernels."""
    yaw = parts[5]
    return _moment_partials(parts[0], parts[1], torch.sin(yaw), torch.cos(yaw))


def finalize_moments(sums, z, roll, pitch):
    """Partials (..., 8, P) -> (mean6, cov3x3); broadcasts over leading
    time axes (z/roll/pitch substituted from odometry, as the reference)."""
    tot = torch.sum(sums, dim=-1)
    count = tot[..., 7]
    mx, my = tot[..., 0] / count, tot[..., 1] / count
    yaw = torch.atan2(tot[..., 5] / count, tot[..., 6] / count)

    def b(v):
        return torch.broadcast_to(torch.as_tensor(v, dtype=mx.dtype, device=mx.device),
                                  mx.shape)

    mean = torch.stack([mx, my, b(z), b(roll), b(pitch), yaw], dim=-1)
    zero = torch.zeros_like(mx)
    cxx = tot[..., 2] / count - mx * mx
    cyy = tot[..., 3] / count - my * my
    cxy = tot[..., 4] / count - mx * my
    cov = torch.stack([torch.stack([cxx, cxy, zero], -1),
                       torch.stack([cxy, cyy, zero], -1),
                       torch.stack([zero, zero, zero], -1)], -2)
    return mean, cov


# ---------------------------------------------------------------------------
# K5 / K6: fused predict + per-tick moments
# ---------------------------------------------------------------------------

def predict_call_multi_reference(parts, par16, seeds, nxy=True, nyaw=True,
                                 nticks=None, idx_off=0):
    """Plain PyTorch version of ``predict_call_multi``."""
    n, K = parts.shape[1], par16.shape[0]
    nt = K if nticks is None else int(nticks)
    x, y, z, roll_v, pitch_v, yaw = parts.unbind(0)
    idx = torch.arange(n, dtype=torch.int64, device=parts.device) + int(idx_off)
    sums = parts.new_zeros((K, N_SUMS, n_partials(n)))
    for t in range(nt):
        p = par16[t]
        scale = p[11]
        nx, ny, nw = normals3(seeds[t], idx, nxy, nyaw)
        roll, pitch = p[4], p[5]
        yaw = yaw + p[3]
        if nyaw:
            yaw = yaw + nw * (p[9] * scale)
        yaw = wrap_angle(yaw)
        cr, sr = torch.cos(roll), torch.sin(roll)
        cp, sp = torch.cos(pitch), torch.sin(pitch)
        sy, cy = torch.sin(yaw), torch.cos(yaw)
        x = x + (cy * cp) * p[0] + (cy * sp * sr - sy * cr) * p[1] \
            + (cy * sp * cr + sy * sr) * p[2]
        y = y + (sy * cp) * p[0] + (sy * sp * sr + cy * cr) * p[1] \
            + (sy * sp * cr - cy * sr) * p[2]
        if nxy:
            x = x + nx * (p[7] * scale)
            y = y + ny * (p[8] * scale)
        subst = p[12] > 0.5
        z = torch.where(subst, p[6], z)
        roll_v = torch.where(subst, roll, roll_v)
        pitch_v = torch.where(subst, pitch, pitch_v)
        sums[t] = _moment_partials(x, y, sy, cy)
    return torch.stack([x, y, z, roll_v, pitch_v, yaw]), sums


def predict_call_reference(parts, par16, seed, nxy=True, nyaw=True, idx_off=0):
    """Plain PyTorch version of ``predict_call``."""
    out, sums = predict_call_multi_reference(parts, par16[None], seed.reshape(1),
                                             nxy, nyaw, idx_off=idx_off)
    return out, sums[0]


def _predict_lib():
    lib = _build.load("pf_predict")
    fn = lib.pf_predict_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 7
                       + [ctypes.c_void_p] * 5)
        fn.restype = ctypes.c_int
    return fn


def _check_predict(parts, par16, seeds, K, idx_off, what):
    dev = parts.device
    n = parts.shape[1] if parts.dim() == 2 else -1
    _tensors.check(parts, "parts", (6, n), torch.float32, dev)
    _tensors.check(par16, "par16", (K, 16) if seeds.dim() else (16,), torch.float32, dev)
    _tensors.check(seeds, "seeds", (K,) if seeds.dim() else (), torch.int32, dev)
    if not 1 <= K <= MAX_K:
        raise ValueError(f"{what}: {K} ticks per call, the kernel takes 1..{MAX_K}")
    if not 0 <= idx_off <= (1 << 31) - 1 - n:
        raise ValueError(f"{what}: particle index offset {idx_off} out of range")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on CUDA or CPU tensors, not {dev}")


def _predict_launch(parts, par16, seeds, K, nticks, nxy, nyaw, single, idx_off):
    dev = parts.device
    n = parts.shape[1]
    out = torch.empty_like(parts)
    sums = torch.empty((K, N_SUMS, n_partials(n)), dtype=torch.float32, device=dev)
    P = _tensors.ptr
    rc = _predict_lib()(
        _tensors.device_index(dev),
        _tensors.stream(dev), n, K, nticks, int(nxy), int(nyaw), int(single), int(idx_off),
        P(parts), P(par16), P(seeds), P(out), P(sums))
    _build.check(rc, "predict_call" if single else "predict_call_multi")
    return out, sums


def predict_call_multi(
    parts: torch.Tensor,    # (6, N) f32
    par16: torch.Tensor,    # (K, 16) f32 per-tick parameters (see make_par16)
    seeds: torch.Tensor,    # (K,) int32 per-tick seeds
    nxy: bool = True,       # x/y motion noise on (False: compiled out)
    nyaw: bool = True,      # yaw motion noise on
    nticks=None,            # real ticks this call (<= K); None = all K
    idx_off: int = 0,       # generator index of local particle 0 (a shard's first)
):
    """Up to K fused predict ticks -> (new_parts, per-tick sums (K, 8, P)).

    Ticks [nticks, K) are not executed and their sums rows are zero. The
    bank is read and written once for all ticks. A particle shard passes
    its first global index as ``idx_off``: its noise is then the unsharded
    bank's, column for column."""
    K = par16.shape[0]
    _check_predict(parts, par16, seeds, K, idx_off, "predict_call_multi")
    nt = K if nticks is None else int(nticks)
    if not 0 <= nt <= K:
        raise ValueError(f"predict_call_multi: nticks {nt} not in [0, {K}]")
    if parts.device.type == "cpu":
        return predict_call_multi_reference(parts, par16, seeds, nxy, nyaw, nt, idx_off)
    out = _predict_launch(parts, par16, seeds, K, nt, nxy, nyaw, False, idx_off)
    predict_call_multi.launches += 1
    return out


predict_call_multi.launches = 0


def predict_call(
    parts: torch.Tensor,    # (6, N) f32
    par16: torch.Tensor,    # (16,) f32 tick parameters (see make_par16)
    seed: torch.Tensor,     # () int32
    nxy: bool = True,
    nyaw: bool = True,
    idx_off: int = 0,       # generator index of local particle 0
):
    """One fused predict tick -> (new_parts, sums (8, P)): the kernel of
    ``predict_call_multi`` instantiated for K = 1, so the two share one op
    order and give bitwise equal banks from equal inputs."""
    _check_predict(parts, par16, seed, 1, idx_off, "predict_call")
    if parts.device.type == "cpu":
        return predict_call_reference(parts, par16, seed, nxy, nyaw, idx_off)
    out, sums = _predict_launch(parts, par16, seed, 1, 1, nxy, nyaw, True, idx_off)
    predict_call.launches += 1
    return out, sums[0]


predict_call.launches = 0


def make_par16(odom, dt, motion_sd, do_noise=1.0, subst=1.0) -> torch.Tensor:
    """Tick parameter row for ``predict_call`` from a 13-dim odom sample:
    [vdt_x, vdt_y, vdt_z, wz·dt, roll, pitch, z, sd_x, sd_y, sd_yaw, 0,
    do_noise, subst, 0, 0, 0]."""
    f32 = torch.float32
    odom = odom.to(f32)
    dt = torch.as_tensor(dt, dtype=f32, device=odom.device)
    abs_rpy = rpy_from_quat(odom[3:7])
    vdt = odom[7:10] * dt
    z = torch.zeros((), dtype=f32, device=odom.device)

    def s(v):
        return torch.as_tensor(v, dtype=f32, device=odom.device)

    return torch.stack([vdt[0], vdt[1], vdt[2], odom[12] * dt, abs_rpy[0], abs_rpy[1],
                        odom[2], s(motion_sd[0]), s(motion_sd[1]), s(motion_sd[5]), z,
                        s(do_noise), s(subst), z, z, z])


def fused_predict_moments(parts, odom, dt, motion_sd, seed, do_noise=True):
    """One fused PF predict pass (K6). Returns (new_parts, mean6, cov3x3)."""
    par16 = make_par16(odom, dt, motion_sd, do_noise=float(do_noise))
    seed = torch.as_tensor(seed, dtype=torch.int32, device=parts.device)
    out, sums = predict_call(parts, par16, seed)
    abs_rpy = rpy_from_quat(odom[3:7].to(torch.float32))
    mean, cov = finalize_moments(sums, odom[2].to(torch.float32), abs_rpy[0], abs_rpy[1])
    return out, mean, cov


# ---------------------------------------------------------------------------
# K13: the GPS update's normalised weights
# ---------------------------------------------------------------------------

def fast_logw(parts, gps_map_xy, params):
    """GPS log-weights of the kernel path without the reference's constant
    log-normalizer (as its fast path). The map-frame position is written out
    elementwise in a fixed order, so a column shard of the bank gets the
    same bits as the whole bank."""
    r, t = params.r_m2o, params.t_m2o
    x, y, z = parts[0], parts[1], parts[2]
    dx = gps_map_xy[0] - (r[0, 0] * x + r[0, 1] * y + r[0, 2] * z + t[0])
    dy = gps_map_xy[1] - (r[1, 0] * x + r[1, 1] * y + r[1, 2] * z + t[1])
    logw = -0.5 * (dx * dx + dy * dy) / params.meas_var
    return torch.where(torch.isfinite(logw), logw, -math.inf)


def gps_weights_call_reference(parts, gps_map_xy, params):
    """Plain PyTorch version of ``gps_weights_call``."""
    return resampling.normalize_weights_det(fast_logw(parts, gps_map_xy, params))


def gps_weights_call(
    parts: torch.Tensor,        # (6, N) f32 bank
    gps_map_xy: torch.Tensor,   # (2,) f32 map-frame fix
    params,                     # PFParams: r_m2o (3, 3), t_m2o (3,), meas_var () f32
):
    """The GPS update's normalised weights (N,) of a bank:
    ``resampling.normalize_weights_det(fast_logw(parts, gps_map_xy,
    params))`` bit for bit, in one launch (csrc/pf_update.cu): the
    log-weights in ``fast_logw``'s order of operations, the non-finite
    guard, the max, exp(logw − max) + 1e-30 and ``tree_sum``'s folds, at
    any N. The rotation, the fix and ``meas_var`` are read on the device (no
    host sync). CPU tensors take the plain version as they are."""
    if parts.device.type == "cpu":
        return gps_weights_call_reference(parts, gps_map_xy, params)
    dev, f32 = parts.device, torch.float32
    if dev.type != "cuda":
        raise ValueError(f"gps_weights_call runs on CUDA or CPU tensors, not {dev}")
    n = parts.shape[1] if parts.dim() == 2 else -1
    _tensors.check(parts, "parts", (6, n), f32, dev)
    _tensors.check(gps_map_xy, "gps_map_xy", (2,), f32, dev)
    _tensors.check(params.r_m2o, "r_m2o", (3, 3), f32, dev)
    _tensors.check(params.t_m2o, "t_m2o", (3,), f32, dev)
    _tensors.check(params.meas_var, "meas_var", (), f32, dev)
    out = torch.empty(n, dtype=f32, device=dev)
    scratch = torch.empty(_build.scratch_words("pf_update", "pf_weights_scratch_words", n),
                          dtype=f32, device=dev)
    fn = _build.load("pf_update").pf_weights_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7
        fn.restype = ctypes.c_int
    P = _tensors.ptr
    rc = fn(_tensors.device_index(dev), _tensors.stream(dev), n, P(parts), P(gps_map_xy),
            P(params.r_m2o), P(params.t_m2o), P(params.meas_var), P(out), P(scratch))
    _build.check(rc, "gps_weights_call")
    _K13.launches += 1
    return out


# counted on the wrapper itself, not through its module name, which an
# observer may have replaced (as for K14, ``resampling.systematic_counts``)
_K13 = gps_weights_call
_K13.launches = 0


# ---------------------------------------------------------------------------
# K7 / K8: ancestor expansion + gather, resample jitter + moments
# ---------------------------------------------------------------------------

def jitter_moments_call_reference(parts, jitter_sd, seed, seed_off=0):
    """Plain PyTorch version of ``jitter_moments_call``."""
    n = parts.shape[1]
    idx = torch.arange(n, dtype=torch.int64, device=parts.device) + int(seed_off)
    nx, ny, nw = normals3(seed, idx)
    out = parts.clone()
    out[0] = parts[0] + nx * jitter_sd[0]
    out[1] = parts[1] + ny * jitter_sd[1]
    out[5] = parts[5] + nw * jitter_sd[2]
    return out, _moment_partials(out[0], out[1], torch.sin(out[5]), torch.cos(out[5]))


def expand_gather_call_reference(m_cum, parts, jitter_sd=None, seed=None):
    """Plain PyTorch version of ``expand_gather_call``."""
    out = parts[:, resampling._expand_blocks(m_cum).long()]
    if jitter_sd is None:
        return out
    return jitter_moments_call_reference(out, jitter_sd, seed)


def expand_gather_window_call_reference(m_ext, parts, out_off, n_out):
    """Plain PyTorch version of ``expand_gather_window_call``: the
    reference's own non-kernel branch (``resample_dist.py:152-155``),
    ``searchsorted(side="right")`` then a clip."""
    slots = torch.arange(n_out, dtype=m_ext.dtype, device=m_ext.device) + int(out_off)
    anc = torch.searchsorted(m_ext, slots, right=True).clamp(max=m_ext.shape[0] - 1)
    return parts[:, anc]


def _resample_lib():
    lib = _build.load("pf_resample")
    fn = lib.pf_resample_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 6
                       + [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
    return fn


def _check_bank(parts, jitter_sd, seed, what):
    dev = parts.device
    if parts.dim() != 2 or parts.shape[0] not in (6, 8):
        raise ValueError(f"{what}: bank of shape {tuple(parts.shape)}, expected (6 or 8, N)")
    _tensors.check(parts, "parts", tuple(parts.shape), torch.float32, dev)
    if jitter_sd is not None:
        _tensors.check(jitter_sd, "jitter_sd", (3,), torch.float32, dev)
        _tensors.check(seed, "seed", (), torch.int32, dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on CUDA or CPU tensors, not {dev}")


def _resample_launch(m_cum, parts, jitter_sd, seed, seed_off, what, out_off=0, n_out=None):
    dev = parts.device
    rows, n_in = parts.shape
    n = n_in if n_out is None else n_out
    jitter = jitter_sd is not None
    out = torch.empty((rows, n), dtype=parts.dtype, device=dev)
    sums = (torch.empty((N_SUMS, n_partials(n)), dtype=torch.float32, device=dev)
            if jitter else None)
    # K7's scratch: the ancestors of its first phase, per 1024-slot group the
    # count of ancestors written (its second phase waits for a full one), and
    # the count of first-phase blocks that are through
    gather = m_cum is not None
    anc = torch.empty(n, dtype=torch.int32, device=dev) if gather else None
    ready = torch.zeros(n_partials(n) + 1, dtype=torch.int32, device=dev) if gather else None
    P = _tensors.ptr
    rc = _resample_lib()(
        _tensors.device_index(dev),
        _tensors.stream(dev), n, n_in, int(out_off), rows, int(gather), int(jitter),
        P(m_cum), P(parts), P(jitter_sd), P(seed), int(seed_off), P(out), P(sums), P(anc),
        P(ready))
    _build.check(rc, what)
    return (out, sums) if jitter else out


def _seed_tensor(seed, device):
    if seed is None:
        raise ValueError("a jitter needs its seed")
    return torch.as_tensor(seed, dtype=torch.int32, device=device)


def expand_gather_call(
    m_cum: torch.Tensor,    # (N,) int32 monotone cumulative counts, ending at N
    parts: torch.Tensor,    # (6 or 8, N) f32 bank
    jitter_sd: torch.Tensor = None,  # (3,) x/y/yaw stds: jitter the gathered
                                     #   bank and return (8, P) moment sums too
    seed=None,              # () int32 jitter seed (with jitter_sd)
):
    """Ancestor expansion + bank gather: output slot j takes ancestor
    i = min{i : m_cum[i] > j}, exact for every count vector (degenerate
    weights included; no window, no fallback). Returns the bank, or
    (bank, sums) with ``jitter_sd``."""
    n = parts.shape[1] if parts.dim() == 2 else -1
    if jitter_sd is not None:
        seed = _seed_tensor(seed, parts.device)
    _check_bank(parts, jitter_sd, seed, "expand_gather_call")
    _tensors.check(m_cum, "m_cum", (n,), torch.int32, parts.device)
    if parts.device.type == "cpu":
        return expand_gather_call_reference(m_cum, parts, jitter_sd, seed)
    res = _resample_launch(m_cum, parts, jitter_sd, seed, 0, "expand_gather_call")
    expand_gather_call.launches += 1
    return res


expand_gather_call.launches = 0


def expand_gather_window_call(
    m_ext: torch.Tensor,    # (n_in,) int32 monotone counts, values below or past the window too
    parts: torch.Tensor,    # (6 or 8, n_in) f32 bank columns of the window
    out_off: int,           # the global output slot of column 0
    n_out: int,             # output slots
):
    """K7's window form: output slot j of n_out takes ancestor
    min{i : m_ext[i] > out_off + j}, clamped to n_in - 1, of the n_in
    input columns -> (rows, n_out). A particle shard resamples its own
    slots from a halo-extended window of the counts and the bank
    (``parallel.resample_dist``); ``expand_gather_call`` is this form at
    ``out_off`` 0 and n_out = n_in. No jitter: a shard jitters through
    ``jitter_moments_call``."""
    n_in = parts.shape[1] if parts.dim() == 2 else -1
    _check_bank(parts, None, None, "expand_gather_window_call")
    _tensors.check(m_ext, "m_ext", (n_in,), torch.int32, parts.device)
    out_off, n_out = int(out_off), int(n_out)
    if not (1 <= n_out <= 1 << 30 and 0 <= out_off <= (1 << 30)):
        raise ValueError(f"expand_gather_window_call: n_out {n_out} / out_off {out_off}")
    if parts.device.type == "cpu":
        return expand_gather_window_call_reference(m_ext, parts, out_off, n_out)
    res = _resample_launch(m_ext, parts, None, None, 0, "expand_gather_window_call",
                           out_off, n_out)
    expand_gather_window_call.launches += 1
    return res


expand_gather_window_call.launches = 0


def jitter_moments_call(
    parts: torch.Tensor,      # (6 or 8, N) resampled bank
    jitter_sd: torch.Tensor,  # (3,) x/y/yaw stds
    seed,                     # () int32
    seed_off: int = 0,        # global particle index of local particle 0
):
    """x/y/yaw resample jitter + (8, P) moment sums as a standalone pass:
    the same device function as ``expand_gather_call``'s fused tail, so
    ``expand_gather_call(m, p, sd, s)`` equals
    ``jitter_moments_call(expand_gather_call(m, p), sd, s)`` bit for bit.
    A particle shard passes its first global index as ``seed_off``."""
    seed = _seed_tensor(seed, parts.device)
    _check_bank(parts, jitter_sd, seed, "jitter_moments_call")
    if parts.device.type == "cpu":
        return jitter_moments_call_reference(parts, jitter_sd, seed, seed_off)
    res = _resample_launch(None, parts, jitter_sd, seed, seed_off, "jitter_moments_call")
    jitter_moments_call.launches += 1
    return res


jitter_moments_call.launches = 0


def systematic_resample_gather(parts, weights, u, jitter_sd=None, seed=None):
    """Systematic resample + gather -> (6, N) (or (parts, sums) with
    ``jitter_sd``): counts by ``resampling.systematic_counts`` (K14 on the
    card), expansion and gather in K7.
    Ancestors are ``resampling.systematic_resample``'s for the same ``u``
    (a scalar uniform or a ``torch.Generator``)."""
    m_cum = resampling.systematic_counts(weights, u)
    return expand_gather_call(m_cum, parts, jitter_sd, seed)
