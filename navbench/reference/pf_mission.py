"""Float64 reference of the GPS-weighted particle filter (upstream
``auv_particle_filter``: motion ``auv_particle.py:38-70``, GPS weighting
``auv_particle.py:100-106`` and ``auv_pf.py:135-166``, resampling and
jitter ``auv_pf.py:169-198``, estimate ``auv_pf.py:218-253``), in plain
PyTorch over one mission's timeline. It imports nothing of either
navigation package and no kernel: the stream of random numbers it draws is
restated from the port's documentation of it.

The stream. A ``torch.Generator`` seeded as the judged replay's, drawn in
the program's order and dtypes: the initial bank's (6, n) float32
normals, then per tick a predict seed (int32 in [0, 2^31 - 1)), a
resample uniform (float32) and a jitter seed. Each particle's normals come
from the counter-based generator of the port's kernels (``csrc/
pf_rng.cuh``), restated here in int64 torch ops: ``mix32`` (two
xorshift-multiply rounds on 32 bits), the per-(seed, draw) key
``mix32(seed + golden * (draw + 1))``, the 24-bit uniform
``(mix32(mix32(idx ^ key) + key) >> 8 + 0.5) / 2^24`` of particle ``idx``
in float32,
and Box-Muller over draws (d, d + 1): x and y noise from draws 0-1 (cos,
sin), yaw noise from draws 2-3 (cos), keyed by the predict seed of the
tick or by the update's jitter seed and the output slot.

Everything else is float64: the motion (yaw integrated with the odometry
rate and its noise, wrapped to [-pi, pi); x, y advanced by
R(roll, pitch, yaw) v dt plus noise; z, roll and pitch read from the
odometry once any has arrived), the GPS log-weight, the normalisation, the
systematic resample against the reference's own CDF (``cumsum``) and the
moments, every tick.

Near ties (``counts``). The program's CDF carries its float32 rounding and
its weights' (its particles are float32), and its ``n cdf - u`` is rounded
again, so a systematic point that lies that close to an ancestor boundary
can fall to the ancestor on the boundary's other side (at 2^20 particles
an ulp of the CDF is a sixteenth of a slot). Given the judged run's
cumulative counts of each resample (``m_cum``: slot j takes the smallest i
with m_cum[i] > j), the reference takes the judged run's ancestor for a
slot wherever its own point lies within ``tie(n)`` of that ancestor's
interval of its own CDF, and its own ancestor elsewhere: the two banks
hold the same particles, and a resample that differs by more than rounding
leaves lineages of its own that every later number sees. This is the SLAM
reference's rule for associations, restated for ancestors.

Departures from upstream, each the port's documented choice:

- the resample is the systematic scheme (upstream's default is residual;
  the cell's path, ``run.py pf --pallas``, resamples systematically), with
  one uniform ``u`` and positions (j + u) / n;
- the weight floor is 1e-30 relative to the largest weight (upstream adds
  1e-200 to the raw likelihoods; both vanish beside any weight here);
- the yaw mean is the circular mean (upstream averages wrapped angles);
- only x, y and yaw are jittered (upstream draws all six rows; the other
  three variances are zero, and the next predict overwrites z, roll and
  pitch);
- the estimate at an update tick is the jittered bank's.

``hold`` (the control): a dtype that the bank is rounded to after every
step and the unnormalised weights before the CDF, to hold them in a lower
precision than the configuration's float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

F64 = torch.float64
M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9


def tie(n: int) -> float:
    """The largest distance, in CDF units, of a point outside the judged
    run's ancestor's interval that counts as a near tie at ``n``
    particles: 2^-10 / sqrt(n). The judged CDF's error is its weights'
    relative error (float32 particles drift ~1e-4 m from float64 ones over
    a mission, so ~1e-4 in a weight) summed over the ancestors before a
    point, ~1e-4 / sqrt(n), plus the float32 rounding of the CDF and of
    n cdf - u, an ulp or two of 2^-24 each: 2^-10 / sqrt(n) is ten times the
    first and, at 2^20 particles (one slot, 16 ulps), eight times the
    second."""
    return 2.0 ** -10 / math.sqrt(n)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 of uint32 values held in int64: c >= 2^31 is split as
    2^31 + c', so no product overflows 63 bits."""
    if c < 1 << 31:
        return (x * c) & M32
    return (x * (c - (1 << 31)) + ((x & 1) << 31)) & M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def draw_key(seed: int, draw: int) -> int:
    s = (int(seed) & M32) + ((GOLDEN * (draw + 1)) & M32)
    return int(mix32(torch.tensor(s & M32, dtype=torch.int64)))


def uniform(seed: int, idx: torch.Tensor, draw: int) -> torch.Tensor:
    """The generator's (0, 1) uniforms of draw ``draw`` for particles
    ``idx`` (int64) under ``seed``: (b + 0.5) / 2^24 of the top 24 bits b,
    rounded to float32 as the kernels hold it (to even where b >= 2^23),
    then widened to float64."""
    k = draw_key(seed, draw)
    b = mix32((mix32((idx & M32) ^ k) + k) & M32)
    return (((b >> 8).to(F64) + 0.5) / 16777216.0).to(torch.float32).to(F64)


def normal_pair(seed: int, idx: torch.Tensor, draw: int):
    """Box-Muller over draws (draw, draw + 1): (r cos 2 pi u, r sin 2 pi u)."""
    r = torch.sqrt(-2.0 * torch.log(uniform(seed, idx, draw)))
    a = 2.0 * math.pi * uniform(seed, idx, draw + 1)
    return r * torch.cos(a), r * torch.sin(a)


def draws(gen: torch.Generator, n: int, T: int) -> tuple:
    """The generator's draws in the program's order: (initial normals
    (6, n), predict seeds (T,), resample uniforms (T,), jitter seeds (T,))."""
    dev = gen.device
    init = torch.randn((6, n), generator=gen, device=dev, dtype=torch.float32)
    seeds = torch.randint(0, 2 ** 31 - 1, (T,), generator=gen, device=dev, dtype=torch.int32)
    res_u = torch.rand((T,), generator=gen, device=dev, dtype=torch.float32)
    jseeds = torch.randint(0, 2 ** 31 - 1, (T,), generator=gen, device=dev, dtype=torch.int32)
    return init, seeds.cpu().tolist(), res_u.cpu().to(F64).tolist(), jseeds.cpu().tolist()


def rpy_from_quat(q: np.ndarray) -> np.ndarray:
    """(T, 4) xyzw quaternions -> (T, 3) roll, pitch, yaw (tf getRPY)."""
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    roll = np.arctan2(2 * (y * z + w * x), 1 - 2 * (x * x + y * y))
    pitch = np.arcsin(np.clip(-2 * (x * z - w * y), -1.0, 1.0))
    yaw = np.arctan2(2 * (x * y + w * z), 1 - 2 * (y * y + z * z))
    return np.stack([roll, pitch, yaw], -1)


def wrap(a):
    return torch.remainder(a + math.pi, 2 * math.pi) - math.pi


def counts_of(anc: torch.Tensor) -> torch.Tensor:
    """The cumulative counts (int32) of a sorted ancestor vector: m_cum[i]
    is the number of slots whose ancestor is i or lower."""
    i = torch.arange(anc.shape[0], dtype=anc.dtype, device=anc.device)
    return torch.searchsorted(anc, i, right=True).to(torch.int32)


def ancestors_of(m_cum: torch.Tensor) -> torch.Tensor:
    """The ancestors (int64) of cumulative counts: slot j takes the smallest
    i with m_cum[i] > j."""
    n = m_cum.shape[0]
    j = torch.arange(n, dtype=m_cum.dtype, device=m_cum.device)
    return torch.searchsorted(m_cum.contiguous(), j, right=True).clamp(max=n - 1)


def replay(tl: dict, cfg: dict, n: int, gen: torch.Generator, device="cpu", hold=None,
           counts=None, record=False, tol=None) -> dict:
    """One mission (a navbench timeline dict, no mission axis) replayed from
    the generator ``gen`` -> {"mean" (T, 6), "cov" (T, 3, 3), "updated"
    (T,), "bank" (6, n) final} as numpy float64, and "ties": {"taken" (the
    share of slots that took the judged run's ancestor over the reference's
    own), "refused" (slots whose judged ancestor lay beyond ``tol``, by default
    ``tie(n)``),
    "gap" (the largest distance of a point outside a judged ancestor's
    interval that differed from the reference's own, in CDF units)}.
    ``counts``: the judged run's cumulative counts (n,) of each resample in
    order, for the near ties; ``record``: also return the reference's own as
    "counts"."""
    dev = torch.device(device)
    tol = tie(n) if tol is None else tol
    od, gps, div = tl["channels"]["odom"], tl["channels"]["gps"], tl["channels"]["diving"]
    ticks = np.asarray(tl["ticks"], np.float64)
    T = len(ticks)
    vals = np.asarray(od["value"], np.float64)
    fresh = np.asarray(od["fresh"], bool)
    rpy = rpy_from_quat(vals[:, 3:7])
    upd = np.asarray(gps["fresh"], bool) & (np.asarray(div["value"])[:, 0] < 0.5)
    gxy = np.asarray(gps["value"], np.float64)[:, 0:2]
    sd_m = np.sqrt(np.asarray(cfg["motion_cov"], np.float64))
    sd_j = np.sqrt(np.asarray(cfg["res_noise_cov"], np.float64))
    meas_var = float(cfg["measurement_std"]) ** 2

    def held(x):
        return x if hold is None else x.to(hold).to(F64)

    init, seeds, res_u, jseeds = draws(gen, n, T)
    bank = held(init.to(dev, F64) * torch.sqrt(torch.as_tensor(cfg["init_cov"], dtype=F64,
                                                               device=dev))[:, None])
    x, y, z, roll, pitch, yaw = bank.unbind(0)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    mean, cov = np.zeros((T, 6)), np.zeros((T, 3, 3))
    k, taken, refused, gap_max, own = 0, 0, 0, 0.0, []
    t_prev, seen = 0.0, False
    for t in range(T):
        if fresh[t]:
            dt = max(ticks[t] - t_prev, 0.0)
            t_prev, seen = ticks[t], True
            yaw = yaw + vals[t, 12] * dt
            if sd_m[5] > 0:
                yaw = yaw + normal_pair(seeds[t], idx, 2)[0] * sd_m[5]
            yaw = held(wrap(yaw))
            cr, sr = math.cos(rpy[t, 0]), math.sin(rpy[t, 0])
            cp, sp = math.cos(rpy[t, 1]), math.sin(rpy[t, 1])
            cy, sy = torch.cos(yaw), torch.sin(yaw)
            v0, v1, v2 = vals[t, 7] * dt, vals[t, 8] * dt, vals[t, 9] * dt
            x = x + (cy * cp) * v0 + (cy * sp * sr - sy * cr) * v1 + (cy * sp * cr + sy * sr) * v2
            y = y + (sy * cp) * v0 + (sy * sp * sr + cy * cr) * v1 + (sy * sp * cr - cy * sr) * v2
            if sd_m[0] > 0 or sd_m[1] > 0:
                nx, ny = normal_pair(seeds[t], idx, 0)
                x, y = x + nx * sd_m[0], y + ny * sd_m[1]
            x, y = held(x), held(y)
        if seen:
            z = torch.full_like(x, vals[t, 2])
            roll, pitch = torch.full_like(x, rpy[t, 0]), torch.full_like(x, rpy[t, 1])
        if upd[t]:
            logw = -0.5 * ((gxy[t, 0] - x) ** 2 + (gxy[t, 1] - y) ** 2) / meas_var
            w = held(torch.exp(logw - logw.max())) + 1e-30
            cdf = torch.cumsum(w / w.sum(), 0)
            cdf[-1] = 1.0
            pos = (idx.to(F64) + res_u[t]) / n
            anc = torch.searchsorted(cdf, pos, right=True).clamp(max=n - 1)
            if counts is not None and k < len(counts):
                a = ancestors_of(counts[k].to(dev))
                lo = torch.where(a > 0, cdf[(a - 1).clamp(min=0)], 0.0)
                gap = (lo - pos).clamp(min=0) + (pos - cdf[a]).clamp(min=0)
                other = a != anc
                take = other & (gap <= tol)
                taken += int(take.sum())
                refused += int(other.sum()) - int(take.sum())
                gap_max = max(gap_max, float(gap[take].max())) if bool(take.any()) else gap_max
                anc = torch.where(take, a, anc)
            k += 1
            if record:
                own.append(counts_of(anc))
            nx, ny = normal_pair(jseeds[t], idx, 0)
            nw = normal_pair(jseeds[t], idx, 2)[0]
            x = held(x[anc] + nx * sd_j[0])
            y = held(y[anc] + ny * sd_j[1])
            yaw = held(yaw[anc] + nw * sd_j[5])
        mx, my = x.mean(), y.mean()
        s, c = torch.sin(yaw).mean(), torch.cos(yaw).mean()
        dx, dy = x - mx, y - my
        mean[t] = [float(mx), float(my), vals[t, 2], rpy[t, 0], rpy[t, 1], float(torch.atan2(s, c))]
        cxx, cyy, cxy = float((dx * dx).mean()), float((dy * dy).mean()), float((dx * dy).mean())
        cov[t, 0:2, 0:2] = [[cxx, cxy], [cxy, cyy]]
    bank = torch.stack([x, y, z, roll, pitch, yaw]).cpu().numpy()
    out = dict(mean=mean, cov=cov, updated=upd, bank=bank,
               ties=dict(taken=taken / (n * max(k, 1)), refused=refused, gap=gap_max))
    if record:
        out["counts"] = own
    return out
