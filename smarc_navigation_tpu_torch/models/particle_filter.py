"""GPS-weighted Monte-Carlo localization (PyTorch port of
``smarc_navigation_tpu/models/particle_filter.py``).

The bank is one (6, N) tensor, rows x, y, z, roll, pitch, yaw; see the
reference's module docstring for the mapping onto ``auv_particle_filter``
(motion ``auv_particle.py:38-70``, GPS weighting ``:100-106``, resampling
and jitter ``auv_pf.py:169-198``, dive gating ``:122-133``).

Two paths, as in the reference:

* the dense path (``step``/``run`` with ``use_pallas=False``): plain torch
  predict, weights, any of the four resampling schemes, estimate;
* the kernel path (``use_pallas=True``; the parameter keeps the reference's
  name and here means "the CUDA kernels"): ``run_fast_segmented`` runs each
  stretch of ticks between GPS updates as one multi-tick predict (K5,
  ``ops.pf_kernels.predict_call_multi``), ``run_fast`` one predict per tick
  (K6, ``predict_call``); every GPS update is the systematic resample with
  the fused jitter (K7, ``expand_gather_call``). On CPU tensors the kernels'
  plain versions run.

Randomness: a ``torch.Generator`` takes the place of the JAX key. The
kernel path draws all of it up front in ``_tick_precompute`` (per-tick
predict seeds, resample uniforms and jitter seeds); the tick loops then run
from given particles and draws, which lets the tests hand both packages the
same values. With the same generator state, ``run_fast`` and
``run_fast_segmented`` draw the same numbers and give bitwise equal banks,
noise included (the kernels' generator is keyed per tick and particle).

A mission fleet (``parallel.fleet``) carries its banks as one
``FleetPFState``: particles (B, 6, N) and one key per mission for the
counter-based generator of ``ops.pf_kernels``, in place of the reference's
(B, 2) PRNG keys. ``fleet_init``, ``fleet_predict`` and
``fleet_update_resample`` step every bank at once, drawing on the banks'
device: the same keys draw the same bits on the card and on the CPU.

Particle sharding (``pmesh=``, a ``parallel.mesh.Mesh`` with a
``particle`` axis): the bank's columns split over the devices of the mesh's
first row, driven from this process. The systematic resample goes through
``parallel.resample_dist`` (blocked-CDF prefix, halo exchange, K7's window
form; one host sync per resample for its fit check); the other schemes
sample the joined bank. The kernel paths keep each shard's (6, ns) columns
on its device for the whole replay: K5 (or K6) with the shard's first
global index as ``idx_off``, and on GPS ticks ``_update_resample_fast_shard``
(weights through ``resampling.normalize_weights_det_shard``, ancestors
through the distributed resample, the jitter and moments through K8 with
``seed_off``). Every pmesh path is bitwise its unsharded self, the moments
too: a shard tiles by ``resampling.CDF_BLOCK``, a multiple of
``pf_kernels.SUM_GROUP``, so the shards' moment partials side by side are
the unsharded ones.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..configs import PFConfig
from ..ops import pf_kernels, resampling
from ..ops.timeline import Timeline, build_timeline
from ..parallel import mesh as mesh_lib
from ..parallel import resample_dist
from ..utils import trace
from ..utils.geometry import quat_from_rpy_np, rotmat_from_rpy, rpy_from_quat, wrap_angle


class PFParams(NamedTuple):
    init_cov: torch.Tensor      # (6,)
    motion_cov: torch.Tensor    # (6,)
    res_noise_cov: torch.Tensor # (6,)
    meas_var: torch.Tensor      # scalar, meas_std²
    r_m2o: torch.Tensor         # (3,3) map <- odom rotation
    t_m2o: torch.Tensor         # (3,)


class PFState(NamedTuple):
    particles: torch.Tensor     # (6, N)
    generator: torch.Generator
    t_prev: torch.Tensor


class FleetPFState(NamedTuple):
    particles: torch.Tensor     # (B, 6, N)
    key: torch.Tensor           # (B,) int64 holding uint32 keys (pf_kernels.split_keys)
    t_prev: torch.Tensor        # (B,)


def make_params(
    cfg: PFConfig = PFConfig(),
    r_m2o: np.ndarray | None = None,
    t_m2o: np.ndarray | None = None,
    dtype=torch.float32,
    device="cuda",
) -> PFParams:
    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return PFParams(
        init_cov=t(cfg.init_cov),
        motion_cov=t(cfg.motion_cov),
        res_noise_cov=t(cfg.res_noise_cov),
        meas_var=t(cfg.measurement_std ** 2),
        r_m2o=t(np.eye(3) if r_m2o is None else r_m2o),
        t_m2o=t(np.zeros(3) if t_m2o is None else t_m2o),
    )


def _generator(generator, device) -> torch.Generator:
    if generator is not None:
        return generator
    return torch.Generator(device=device).manual_seed(0)


def _randn(shape, g: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    return torch.randn(shape, generator=g, device=g.device,
                       dtype=like.dtype).to(like.device)


def _randint(shape, g: torch.Generator, device) -> torch.Tensor:
    return torch.randint(0, 2 ** 31 - 1, shape, generator=g, device=g.device,
                         dtype=torch.int32).to(device)


def init_state(
    n_particles: int,
    params: PFParams,
    generator: torch.Generator | None = None,
    mu0=None,
) -> PFState:
    like = params.init_cov
    g = _generator(generator, like.device)
    base = like.new_zeros(6) if mu0 is None else torch.as_tensor(mu0, dtype=like.dtype,
                                                                  device=like.device)
    noise = _randn((6, n_particles), g, like) * torch.sqrt(params.init_cov)[:, None]
    return PFState(particles=(base[:, None] + noise).contiguous(), generator=g,
                   t_prev=like.new_zeros(()))


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

def motion_model(p: torch.Tensor, odom: torch.Tensor, dt, noise: torch.Tensor) -> torch.Tensor:
    """odom = [x,y,z, quat4, v3, w3] (13,). One particle step."""
    quat, v, wz = odom[3:7], odom[7:10], odom[12]
    rot = p[3:6] + torch.stack([0.0 * wz, 0.0 * wz, wz]) * dt + noise[3:6]
    abs_rpy = rpy_from_quat(quat)
    rpy = torch.stack([abs_rpy[0], abs_rpy[1], wrap_angle(rot[2])])
    step = rotmat_from_rpy(rpy) @ (v * dt) + noise[0:3]
    return torch.stack([p[0] + step[0], p[1] + step[1], odom[2], rpy[0], rpy[1], rpy[2]])


def log_weight(p: torch.Tensor, gps_map_xy: torch.Tensor, params: PFParams) -> torch.Tensor:
    """log N(gps; particle position in map frame, meas_var·I₂)."""
    pos_map = params.r_m2o @ p[0:3] + params.t_m2o
    d = gps_map_xy - pos_map[0:2]
    return -0.5 * torch.sum(d * d) / params.meas_var - torch.log(
        2 * math.pi * params.meas_var)


def _col(x):
    """A per-bank value (a number, or a tensor over the leading bank axes)
    against the particle axis."""
    return x[..., None] if isinstance(x, torch.Tensor) and x.dim() else x


def motion_model_batch(parts: torch.Tensor, odom: torch.Tensor, dt,
                       noise: torch.Tensor) -> torch.Tensor:
    """``motion_model`` over a whole (6, N) bank, row math; or over banks
    (..., 6, N) with odom (..., 13), dt (...,) and noise (..., 6, N)."""
    quat = odom[..., 3:7]
    v = odom[..., 7:10] * _col(dt)
    wz = odom[..., 12]
    abs_rpy = rpy_from_quat(quat)[..., None]

    yaw = wrap_angle(parts[..., 5, :] + _col(wz * dt) + noise[..., 5, :])
    # roll/pitch are absolute (the reference overwrites their noise)
    roll = torch.broadcast_to(abs_rpy[..., 0, :], yaw.shape)
    pitch = torch.broadcast_to(abs_rpy[..., 1, :], yaw.shape)

    cr, sr = torch.cos(abs_rpy[..., 0, :]), torch.sin(abs_rpy[..., 0, :])
    cp, sp = torch.cos(abs_rpy[..., 1, :]), torch.sin(abs_rpy[..., 1, :])
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    v0, v1, v2 = (v[..., i, None] for i in range(3))
    step_x = (cy * cp) * v0 + (cy * sp * sr - sy * cr) * v1 + (cy * sp * cr + sy * sr) * v2
    step_y = (sy * cp) * v0 + (sy * sp * sr + cy * cr) * v1 + (sy * sp * cr - cy * sr) * v2

    x = parts[..., 0, :] + step_x + noise[..., 0, :]
    y = parts[..., 1, :] + step_y + noise[..., 1, :]
    z = torch.broadcast_to(odom[..., 2, None], yaw.shape)
    return torch.stack([x, y, z, roll, pitch, yaw], dim=-2)


# ---------------------------------------------------------------------------
# filter steps
# ---------------------------------------------------------------------------

def predict(state: PFState, odom: torch.Tensor, dt, params: PFParams,
            n3: torch.Tensor | None = None) -> PFState:
    """Motion step with x/y/yaw noise (z is substituted, roll/pitch are
    absolute, so only three noise rows are drawn). ``n3`` (3, N) gives the
    standard normals instead of drawing them from the state's generator."""
    parts = state.particles
    n = parts.shape[1]
    sd = torch.sqrt(params.motion_cov)
    if n3 is None:
        n3 = _randn((3, n), state.generator, parts)
    noise = parts.new_zeros((6, n))
    noise[0] = n3[0] * sd[0]
    noise[1] = n3[1] * sd[1]
    noise[5] = n3[2] * sd[5]
    return PFState(particles=motion_model_batch(parts, odom, dt, noise),
                   generator=state.generator, t_prev=state.t_prev)


def _gps_weights(particles: torch.Tensor, gps_map_xy: torch.Tensor,
                 params: PFParams) -> torch.Tensor:
    """Normalized GPS-likelihood weights of a (6, N) bank, or of banks
    (..., 6, N) with fixes (..., 2) (``auv_pf.py:135-166``); a non-finite
    particle gets zero weight. The normalization is the order-pinned
    ``resampling.normalize_weights_det``."""
    pos_map = params.r_m2o @ particles[..., 0:3, :] + params.t_m2o[:, None]
    dx = gps_map_xy[..., 0, None] - pos_map[..., 0, :]
    dy = gps_map_xy[..., 1, None] - pos_map[..., 1, :]
    logw = -0.5 * (dx * dx + dy * dy) / params.meas_var - torch.log(
        2 * math.pi * params.meas_var)
    logw = torch.where(torch.isfinite(logw), logw, -math.inf)
    return resampling.normalize_weights_det(logw)


def fleet_keys(batch: int, seed: int = 0, device="cuda") -> torch.Tensor:
    """(B,) per-mission keys from one seed (the reference splits one PRNG
    key into B)."""
    return pf_kernels.split_keys(torch.tensor(seed, dtype=torch.int64, device=device), batch)


def fleet_normals(key: torch.Tensor, n: int, rows: int, idx_off: int = 0) -> torch.Tensor:
    """(B, rows, n) standard normals under keys (B,): row 2r and 2r+1 are
    the Box-Muller pair of draws 2r, 2r+1 of the counter-based generator
    (``pf_kernels.normal_pair``), so rows x, y, yaw of a predict are the
    kernels' own ``normals3`` layout when ``rows`` = 3. Draws are keyed on
    the global particle index ``idx_off + j``: a particle shard passes its
    first index and gets the unsharded bank's columns."""
    idx = torch.arange(n, dtype=torch.int64, device=key.device) + idx_off
    zs = [z for r in range((rows + 1) // 2) for z in pf_kernels.normal_pair(key[:, None], idx, 2 * r)]
    return torch.stack(zs[:rows], 1)


def fleet_init(batch: int, n_particles: int, params: PFParams, seed: int = 0) -> FleetPFState:
    """Every mission's initial bank on the device of ``params``, drawn
    under its own key (``fleet_keys``), as ``init_state`` draws one bank."""
    like = params.init_cov
    key, sub = pf_kernels.split_keys(fleet_keys(batch, seed, like.device), 2).unbind(-1)
    noise = fleet_normals(sub, n_particles, 6).to(like.dtype)
    return FleetPFState(particles=(noise * torch.sqrt(params.init_cov)[:, None]).contiguous(),
                        key=key, t_prev=like.new_zeros(batch))


def fleet_predict(states: FleetPFState, odom: torch.Tensor, ticks: torch.Tensor,
                  fresh: torch.Tensor, params: PFParams, idx_off: int = 0) -> FleetPFState:
    """``predict`` of every bank whose odometry is fresh (odom (B, 13),
    ticks and fresh (B,)); the others, their keys and their t_prev pass
    unchanged, as under the reference's vmapped ``lax.cond``. No host
    sync. A particle shard of the banks passes its first global particle
    index as ``idx_off``."""
    parts = states.particles
    key, sub = pf_kernels.split_keys(states.key, 2).unbind(-1)
    n3 = fleet_normals(sub, parts.shape[-1], 3, idx_off).to(parts.dtype)
    sd = torch.sqrt(params.motion_cov)
    noise = torch.zeros_like(parts)
    noise[:, 0] = n3[:, 0] * sd[0]
    noise[:, 1] = n3[:, 1] * sd[1]
    noise[:, 5] = n3[:, 2] * sd[5]
    dt = torch.clamp(ticks - states.t_prev, min=0.0)
    moved = motion_model_batch(parts, odom, dt, noise)
    return FleetPFState(particles=torch.where(fresh[:, None, None], moved, parts),
                        key=torch.where(fresh, key, states.key),
                        t_prev=torch.where(fresh, ticks, states.t_prev))


def _uses_dist_resample(pmesh, n: int) -> bool:
    """Whether ``fleet_update_resample`` takes the distributed resample for
    banks of n particles on ``pmesh``: the shards tile by
    ``resampling.CDF_BLOCK`` (the reference's test, ``:232-246``)."""
    if pmesh is None:
        return False
    P_ = pmesh.shape[mesh_lib.PARTICLE_AXIS]
    return n % P_ == 0 and (n // P_) % resampling.CDF_BLOCK == 0


def fleet_update_resample(
    states: FleetPFState,       # particles (B, 6, N), key (B,)
    gps_map_xy: torch.Tensor,   # (B, 2)
    params: PFParams,
    pmesh=None,
    use_pallas: bool = False,
    u: torch.Tensor | None = None,
    noise: torch.Tensor | None = None,
    scheme: str = "systematic",
) -> FleetPFState:
    """Batched ``update_resample`` for a mission fleet, every bank at once:
    the GPS weights, the ancestors (by default the blocked-CDF systematic
    sampler), one gather along the particle axis, then the resample jitter.

    Each mission's key splits into its next key and the keys of the
    resample uniforms and of the jitter, as the reference splits its PRNG
    key. ``u`` ((B,) for "systematic", (B, N) for the other schemes) and
    ``noise`` (B, 6, N) standard normals replace those draws.

    With ``pmesh`` (the systematic scheme only, as the reference) the
    resample of every mission runs through the fleet form of the
    distributed resample (``resample_dist.
    systematic_resample_gather_dist_batched``: missions over the mission
    axis, each bank's columns over the particle axis) where the shard width
    tiles by ``resampling.CDF_BLOCK``; narrower banks keep the per-bank
    sampler (``:232-246``). Both give the same ancestors. ``use_pallas``
    changes nothing here (the kernel runs on CUDA banks either way)."""
    parts = states.particles
    B, rows, n = parts.shape
    if pmesh is not None and scheme != "systematic":
        raise ValueError("particle-axis sharding (pmesh) requires the systematic scheme")
    use_dist = _uses_dist_resample(pmesh, n)
    key, k_res, k_noise = pf_kernels.split_keys(states.key, 3).unbind(-1)
    if u is None:
        idx = (torch.zeros_like(k_res) if scheme == "systematic"
               else torch.arange(n, dtype=torch.int64, device=parts.device))
        u = pf_kernels.uniforms(k_res if scheme == "systematic" else k_res[:, None], idx, 0)
    w = _gps_weights(parts, gps_map_xy, params)
    if use_dist:
        parts = resample_dist.systematic_resample_gather_dist_batched(
            parts, w, u.to(w.dtype), pmesh, use_pallas=use_pallas)
    else:
        anc = resampling.SCHEMES[scheme](u.to(w.dtype), w).long()
        parts = torch.gather(parts, 2, anc[:, None, :].expand(B, rows, n))
    if noise is None:
        noise = fleet_normals(k_noise, n, 6).to(parts.dtype)
    parts = parts + noise * torch.sqrt(params.res_noise_cov)[None, :, None]
    return FleetPFState(particles=parts, key=key, t_prev=states.t_prev)


def update_resample(
    state: PFState,
    gps_map_xy: torch.Tensor,
    params: PFParams,
    scheme: str = "residual",
    use_pallas: bool = False,
    pmesh=None,
    u=None,
    noise: torch.Tensor | None = None,
) -> PFState:
    """GPS weight update + resample + jitter (``auv_pf.py:135-198``).

    ``u`` gives the scheme's uniforms (a scalar for "systematic", (N,) for
    the others) and ``noise`` the (6, N) standard normals of the jitter;
    each is drawn from the state's generator when not given. With
    ``use_pallas`` the systematic scheme gathers through K7.

    ``pmesh``: a mesh with a ``particle`` axis routes the systematic
    resample through the distributed resample (``parallel.resample_dist``:
    blocked-CDF prefix, halo exchange, K7's window form per shard); the
    other schemes sample the joined bank. The same draws give bitwise the
    unsharded result."""
    parts = state.particles
    n = parts.shape[1]
    w = _gps_weights(parts, gps_map_xy, params)
    u = state.generator if u is None else u
    if pmesh is not None and scheme == "systematic":
        parts = resample_dist.systematic_resample_gather_dist(parts, w, u, pmesh,
                                                              use_pallas=use_pallas)
    elif use_pallas and scheme == "systematic":
        parts = pf_kernels.systematic_resample_gather(parts, w, u)
    else:
        parts = parts[:, resampling.SCHEMES[scheme](u, w).long()]
    if noise is None:
        noise = _randn((6, n), state.generator, parts)
    parts = parts + noise * torch.sqrt(params.res_noise_cov)[:, None]
    return PFState(particles=parts, generator=state.generator, t_prev=state.t_prev)


def estimate(particles: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean pose (circular yaw mean) + 3×3 position sample covariance
    (``auv_pf.py:218-253``) of a (6, N) bank, or of each bank of (..., 6, N)."""
    mean = torch.mean(particles, dim=-1)
    s = torch.mean(torch.sin(particles[..., 5, :]), -1)
    c = torch.mean(torch.cos(particles[..., 5, :]), -1)
    mean = torch.cat([mean[..., 0:5], torch.atan2(s, c)[..., None]], -1)
    d = particles[..., 0:3, :] - mean[..., 0:3, None]
    cov = (d @ d.transpose(-1, -2)) / particles.shape[-1]
    return mean, cov


def step(
    cfg: PFConfig,
    params: PFParams,
    state: PFState,
    tick,
    scheme: str = "residual",
    use_pallas: bool = False,
    pmesh=None,
):
    """One PF tick: predict on fresh odometry, GPS update + resample when a
    fresh fix arrives and the vehicle is not diving (host-side branches: one
    sync per tick). ``use_pallas=True`` takes the kernel path: predict and
    pose moments through K6 (``fused_predict_moments``), the systematic
    gather through K7. ``pmesh``: the update's resample as in
    ``update_resample``; the predict is elementwise over the bank, so the
    same on any split."""
    odom = tick.channels["odom"]
    gps = tick.channels["gps"]
    diving = tick.channels["diving"]
    dt = torch.clamp(tick.ticks - state.t_prev, min=0.0)
    fresh = bool(odom.fresh)
    do_update = bool(gps.fresh & (diving.value[0] < 0.5))

    if use_pallas:
        if fresh:
            seed = _randint((), state.generator, state.particles.device)
            parts, mean, cov = pf_kernels.fused_predict_moments(
                state.particles, odom.value, dt, torch.sqrt(params.motion_cov), seed)
            pred = PFState(particles=parts, generator=state.generator, t_prev=tick.ticks)
        else:
            mean, cov = estimate(state.particles)
            pred = state
    elif fresh:
        pred = predict(state, odom.value, dt, params)._replace(t_prev=tick.ticks)
    else:
        pred = state

    new_state = (update_resample(pred, gps.value[0:2], params, scheme, use_pallas, pmesh)
                 if do_update else pred)
    if do_update or not use_pallas:
        mean, cov = estimate(new_state.particles)
    out = {"mean": mean, "cov": cov,
           "updated": torch.tensor(do_update, device=state.particles.device)}
    return new_state, out


# ---------------------------------------------------------------------------
# the kernel path
# ---------------------------------------------------------------------------

def _jitter_sd(params):
    sd = torch.sqrt(params.res_noise_cov)
    return torch.stack([sd[0], sd[1], sd[5]])


def _update_resample_fast(parts, gps_map_xy, u, seed, params):
    """Weights -> systematic resample with the x/y/yaw jitter and the
    post-resample moment sums fused into the gather (K7). ``u`` is the
    resample uniform, ``seed`` the jitter seed. z/roll/pitch are not
    jittered: the next predict substitutes them from odometry. On the card
    an update is three kernels, each under a span of its own: the weights
    (K13, ``pf_kernels.gps_weights_call``), the counts (K14, behind
    ``resampling.systematic_counts``, called through the module so that an
    observer of that attribute sees every resample) and the gather (K7); on
    the CPU their plain versions."""
    with trace.span("pf.update"):
        with trace.span("pf.weights"):
            w = pf_kernels.gps_weights_call(parts, gps_map_xy, params)
        with trace.span("pf.counts"):
            m_cum = resampling.systematic_counts(w, u)
        with trace.span("pf.gather"):
            return pf_kernels.expand_gather_call(m_cum, parts, _jitter_sd(params), seed)


def _update_resample_fast_shard(parts, gps_map_xy, u, seed, params, axis_name):
    """Shard body of the GPS update of the particle-sharded kernel paths
    (``parts`` the list of (6, ns) shards; ``gps_map_xy``, ``seed`` and
    ``params`` one copy per shard, ``u`` the resample uniform), in the
    reference's order (``particle_filter.py:436-494``) and BITWISE
    ``_update_resample_fast`` on the joined bank:

    * the weights through ``resampling.normalize_weights_det_shard`` (pmax
      and the order-pinned tree sum decompose over the shards);
    * the ancestors through ``resample_dist.systematic_gather_shard`` (K7's
      window form on each shard's halo-extended window);
    * the x/y/yaw jitter and moment partials through K8
      (``jitter_moments_call``) with the shard's first global index as
      ``seed_off``: K7(jitter) is K8(K7) bit for bit.

    Returns (shards, each shard's (8, ns / SUM_GROUP) moment partials)."""
    logw = [pf_kernels.fast_logw(p, g, prm) for p, g, prm in zip(parts, gps_map_xy, params)]
    w = resampling.normalize_weights_det_shard(logw, axis_name)
    ns = parts[0].shape[1]
    parts = resample_dist.systematic_gather_shard(
        parts, w, u, axis_name=axis_name, halo=resample_dist._clamped_halo(4096, ns),
        block=min(512, ns), use_pallas=True)
    out = [pf_kernels.jitter_moments_call(p, _jitter_sd(prm), sd, seed_off=i * ns)
           for i, (p, sd, prm) in enumerate(zip(parts, seed, params))]
    return [o[0] for o in out], [o[1] for o in out]


class TickInputs(NamedTuple):
    """Per-tick inputs of the kernel path, vectorized over the timeline."""

    par16: torch.Tensor        # (T, 16) predict parameters (see make_par16)
    seeds: torch.Tensor        # (T,) int32 predict seeds
    do_update: torch.Tensor    # (T,) bool GPS update this tick
    gps_xy: torch.Tensor       # (T, 2)
    res_u: torch.Tensor        # (T,) resample uniforms
    noise_seeds: torch.Tensor  # (T,) int32 resample-jitter seeds
    vals: torch.Tensor         # (T, 13) odometry
    rpy: torch.Tensor          # (T, 3) odometry attitude
    lf: torch.Tensor           # (T,) stamp of the last fresh odometry so far


def _tick_precompute(timeline: Timeline, params: PFParams, generator) -> TickInputs:
    """Vectorized per-tick scalar math shared by the kernel paths: par16
    rows, gating flags, and every random draw (seeds, uniforms)."""
    od = timeline.channels["odom"]
    gps = timeline.channels["gps"]
    diving = timeline.channels["diving"]
    ticks = timeline.ticks
    T = ticks.shape[0]
    dev = ticks.device
    f32 = torch.float32

    fresh = od.fresh
    # stamp of the last fresh-odom tick up to i; t_prev_i the one strictly before
    lf = torch.cummax(torch.where(fresh, ticks, 0.0), 0).values
    t_prev = torch.cat([ticks.new_zeros(1), lf[:-1]])
    dts = torch.clamp(ticks - t_prev, min=0.0).to(f32)
    scale = fresh.to(f32)
    subst = (torch.cumsum(fresh.to(torch.int32), 0) > 0).to(f32)

    rpy = rpy_from_quat(od.value[:, 3:7]).to(f32)
    vals = od.value.to(f32)
    sd = torch.sqrt(params.motion_cov).to(f32)
    zero = torch.zeros((T,), dtype=f32, device=dev)
    par16 = torch.stack([
        vals[:, 7] * dts * scale, vals[:, 8] * dts * scale,
        vals[:, 9] * dts * scale, vals[:, 12] * dts * scale,
        rpy[:, 0], rpy[:, 1], vals[:, 2],
        zero + sd[0], zero + sd[1], zero + sd[5],
        zero, scale, subst, zero, zero, zero], dim=1)
    g = generator
    seeds = _randint((T,), g, dev)
    res_u = torch.rand((T,), generator=g, device=g.device, dtype=f32).to(dev)
    noise_seeds = _randint((T,), g, dev)
    do_update = gps.fresh & (diving.value[:, 0] < 0.5)
    return TickInputs(par16, seeds, do_update, gps.value[:, 0:2].to(f32), res_u,
                      noise_seeds, vals, rpy, lf)


def _segment_plan(upd: np.ndarray, k_max: int):
    """Host-side split of [0,T) into runs ending at each update tick (and at
    k_max): list of (start, length, has_update)."""
    T = len(upd)
    segs = []
    start = 0
    for t in range(T):
        if upd[t] or (t - start + 1) == k_max:
            segs.append((start, t - start + 1, bool(upd[t])))
            start = t + 1
    if start < T:
        segs.append((start, T - start, False))
    return segs


def _segment_arrays(upd_host: np.ndarray, k_max: int):
    """Numpy slot tables of the segmented path: (idx (S,K), valid (S,K),
    upd_seg (S,), upd_tick (S,), upd_slot (S,), flat_slot (T,))."""
    segs = _segment_plan(upd_host, k_max)
    S, K, T = len(segs), k_max, len(upd_host)
    idx = np.zeros((S, K), np.int32)
    valid = np.zeros((S, K), bool)
    upd_seg = np.zeros((S,), bool)
    upd_tick = np.zeros((S,), np.int32)
    upd_slot = np.zeros((S,), np.int32)
    for s, (start, length, has_upd) in enumerate(segs):
        idx[s, :length] = np.arange(start, start + length)
        idx[s, length:] = start + length - 1
        valid[s, :length] = True
        upd_seg[s] = has_upd
        upd_tick[s] = start + length - 1
        upd_slot[s] = length - 1
    flat_slot = np.zeros((T,), np.int32)
    for s, (start, length, _h) in enumerate(segs):
        flat_slot[start:start + length] = s * K + np.arange(length)
    return idx, valid, upd_seg, upd_tick, upd_slot, flat_slot


def _segment_inputs(pre: TickInputs, idx, valid, upd_tick):
    """Per-segment inputs from the tick precompute: (seg_par (S,K,16),
    seg_seeds (S,K), seg_gps (S,2), seg_u (S,), seg_nseed (S,)). Pad slots
    repeat the segment's last tick with no motion and no noise."""
    dev = pre.par16.device
    idx = torch.as_tensor(idx, dtype=torch.int64, device=dev)
    upd_tick = torch.as_tensor(upd_tick, dtype=torch.int64, device=dev)
    mask = torch.as_tensor(valid, device=dev)[..., None].to(pre.par16.dtype)
    # cols 0..3 = v·dt / wz·dt, 11 = noise scale
    kill = torch.tensor([1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0],
                        dtype=pre.par16.dtype, device=dev)
    seg_par = (pre.par16[idx] * (mask + (1 - mask) * (1 - kill))).contiguous()
    return (seg_par, pre.seeds[idx].contiguous(), pre.gps_xy[upd_tick],
            pre.res_u[upd_tick], pre.noise_seeds[upd_tick])


def _run_segments(pre: TickInputs, s0_particles, plan, params, nxy, nyaw_on):
    """The segment loop of ``run_fast_segmented`` from given particles and
    draws: one K5 call per segment (its real ticks only), then the GPS
    update (K7 with the jitter) where the segment ends on one; its moments
    replace the update tick's. Returns (final particles, mean (T,6),
    cov (T,3,3))."""
    idx, valid, upd_seg, upd_tick, upd_slot, flat_slot = plan
    S, K = idx.shape
    with trace.span("pf.segment_inputs"):
        seg_par, seg_seeds, seg_gps, seg_u, seg_nseed = _segment_inputs(
            pre, idx, valid, upd_tick)
    parts = s0_particles
    sums_all = []
    for s in range(S):
        with trace.span("pf.predict"):
            parts, sums = pf_kernels.predict_call_multi(
                parts, seg_par[s], seg_seeds[s], nxy=nxy, nyaw=nyaw_on,
                nticks=int(upd_slot[s]) + 1)
        if upd_seg[s]:
            parts, s2 = _update_resample_fast(parts, seg_gps[s], seg_u[s],
                                              seg_nseed[s], params)
            sums[int(upd_slot[s])] = s2
        sums_all.append(sums)
    with trace.span("pf.finalize"):
        flat = torch.as_tensor(flat_slot, dtype=torch.int64, device=parts.device)
        sums_t = torch.stack(sums_all).reshape(S * K, pf_kernels.N_SUMS, -1)[flat]
        mean, cov = pf_kernels.finalize_moments(
            sums_t, pre.vals[:, 2], pre.rpy[:, 0], pre.rpy[:, 1])
    return parts, mean, cov


def _run_ticks(pre: TickInputs, s0_particles, params, nxy, nyaw_on):
    """The tick loop of ``run_fast`` from given particles and draws: one K6
    call per tick, the GPS update (K7) on update ticks. Returns (final
    particles, mean (T,6), cov (T,3,3))."""
    upd = pre.do_update.cpu().numpy()
    parts = s0_particles
    sums_all = []
    for t in range(len(upd)):
        parts, sums = pf_kernels.predict_call(parts, pre.par16[t], pre.seeds[t],
                                              nxy=nxy, nyaw=nyaw_on)
        if upd[t]:
            parts, sums = _update_resample_fast(parts, pre.gps_xy[t], pre.res_u[t],
                                                pre.noise_seeds[t], params)
        sums_all.append(sums)
    mean, cov = pf_kernels.finalize_moments(
        torch.stack(sums_all), pre.vals[:, 2], pre.rpy[:, 0], pre.rpy[:, 1])
    return parts, mean, cov


def _shards(pmesh, n: int):
    """(the 1 x P mesh of ``pmesh``'s first row, the shard width ns) of an
    n-particle bank on the kernel paths: n splits evenly and each shard
    tiles by ``resampling.CDF_BLOCK``, as the distributed resample needs."""
    row = pmesh.row(0)
    P_ = row.shape[mesh_lib.PARTICLE_AXIS]
    if n % P_ or (n // P_) % resampling.CDF_BLOCK:
        raise ValueError(f"particle count {n} does not split over particle axis {P_} into "
                         f"shards that tile by {resampling.CDF_BLOCK}")
    return row, n // P_


def _join_sums(sums, device) -> torch.Tensor:
    """Per-shard moment partials (..., 8, ns / SUM_GROUP) side by side: the
    unsharded partials (ns is a multiple of ``SUM_GROUP``)."""
    return torch.cat([x.to(device) for x in sums], -1)


def _run_segments_sharded(pre: TickInputs, s0_particles, plan, params, nxy, nyaw_on, pmesh):
    """``_run_segments`` over the particle shards of ``pmesh``: each shard's
    columns stay on its device; per segment one K5 call per shard (its
    first global index as ``idx_off``), then on a GPS tick
    ``_update_resample_fast_shard``. Returns what ``_run_segments`` does,
    the bank and moments joined on the caller's device."""
    idx, valid, upd_seg, upd_tick, upd_slot, flat_slot = plan
    S, K = idx.shape
    dev = s0_particles.device
    row, ns = _shards(pmesh, s0_particles.shape[1])
    with trace.span("pf.segment_inputs"):
        seg = mesh_lib.replicate(_segment_inputs(pre, idx, valid, upd_tick), row)
    prm = mesh_lib.replicate(params, row)
    bank = mesh_lib.particle_sharding(row, 2, 1)
    parts = bank.shard(s0_particles)[0]
    sums_all = []
    for s in range(S):
        nt = int(upd_slot[s]) + 1
        out = [pf_kernels.predict_call_multi(p, g[0][s], g[1][s], nxy=nxy, nyaw=nyaw_on,
                                             nticks=nt, idx_off=i * ns)
               for i, (p, g) in enumerate(zip(parts, seg))]
        parts, sums = [o[0] for o in out], [o[1] for o in out]
        if upd_seg[s]:
            parts, s2 = _update_resample_fast_shard(
                parts, [g[2][s] for g in seg], seg[0][3][s], [g[4][s] for g in seg], prm,
                mesh_lib.PARTICLE_AXIS)
            for x, y in zip(sums, s2):
                x[nt - 1] = y
        sums_all.append(_join_sums(sums, dev))
    flat = torch.as_tensor(flat_slot, dtype=torch.int64, device=dev)
    sums_t = torch.stack(sums_all).reshape(S * K, pf_kernels.N_SUMS, -1)[flat]
    mean, cov = pf_kernels.finalize_moments(
        sums_t, pre.vals[:, 2], pre.rpy[:, 0], pre.rpy[:, 1])
    return bank.join([parts], dev), mean, cov


def _run_ticks_sharded(pre: TickInputs, s0_particles, params, nxy, nyaw_on, pmesh):
    """``_run_ticks`` over the particle shards of ``pmesh``: one K6 call
    per shard and tick (``idx_off`` the shard's first global index), the
    GPS update through ``_update_resample_fast_shard``."""
    upd = pre.do_update.cpu().numpy()
    dev = s0_particles.device
    row, ns = _shards(pmesh, s0_particles.shape[1])
    tk = mesh_lib.replicate((pre.par16, pre.seeds, pre.gps_xy, pre.res_u, pre.noise_seeds), row)
    prm = mesh_lib.replicate(params, row)
    bank = mesh_lib.particle_sharding(row, 2, 1)
    parts = bank.shard(s0_particles)[0]
    sums_all = []
    for t in range(len(upd)):
        out = [pf_kernels.predict_call(p, g[0][t], g[1][t], nxy=nxy, nyaw=nyaw_on, idx_off=i * ns)
               for i, (p, g) in enumerate(zip(parts, tk))]
        parts, sums = [o[0] for o in out], [o[1] for o in out]
        if upd[t]:
            parts, sums = _update_resample_fast_shard(
                parts, [g[2][t] for g in tk], tk[0][3][t], [g[4][t] for g in tk], prm,
                mesh_lib.PARTICLE_AXIS)
        sums_all.append(_join_sums(sums, dev))
    mean, cov = pf_kernels.finalize_moments(
        torch.stack(sums_all), pre.vals[:, 2], pre.rpy[:, 0], pre.rpy[:, 1])
    return bank.join([parts], dev), mean, cov


def _noise_flags(params: PFParams):
    """Which motion-noise rows are on (zero-std rows are compiled out of
    the predict kernel; the reference default zeroes x/y, auv_pf.launch:18)."""
    mc = params.motion_cov.cpu().numpy()
    return bool(mc[0] > 0 or mc[1] > 0), bool(mc[5] > 0)


def run_fast_segmented(
    timeline: Timeline,
    params: PFParams,
    cfg: PFConfig = PFConfig(),
    n_particles: int | None = None,
    generator: torch.Generator | None = None,
    k_max: int = 12,
    pmesh=None,
):
    """Segmented kernel path: the mission is split on the host into runs of
    at most ``k_max`` ticks that end at each GPS-update tick, and each run
    is ONE multi-tick predict (K5) with the bank held in registers. Same
    semantics as ``run_fast`` (update-tick moments are post-resample).
    With ``pmesh`` the bank's columns split over the mesh's particle axis
    for the whole replay (``_run_segments_sharded``): bitwise the unsharded
    bank and moments."""
    n = cfg.particle_count if n_particles is None else n_particles
    dev = timeline.ticks.device
    with trace.span("pf.precompute"):
        g = _generator(generator, dev)
        ch = timeline.channels
        upd_host = (ch["gps"].fresh & (ch["diving"].value[:, 0] < 0.5)).cpu().numpy()
        plan = _segment_arrays(upd_host, k_max)
        nxy, nyaw_on = _noise_flags(params)

        s0 = init_state(n, params, g)
        pre = _tick_precompute(timeline, params, g)
    if pmesh is not None:
        final_parts, mean, cov = _run_segments_sharded(pre, s0.particles, plan, params, nxy,
                                                       nyaw_on, pmesh)
    else:
        final_parts, mean, cov = _run_segments(pre, s0.particles, plan, params, nxy, nyaw_on)
    out = {"mean": mean, "cov": cov, "updated": torch.as_tensor(upd_host, device=dev)}
    return PFState(particles=final_parts, generator=g, t_prev=pre.lf[-1]), out


def run_fast(
    timeline: Timeline,
    params: PFParams,
    cfg: PFConfig = PFConfig(),
    n_particles: int | None = None,
    generator: torch.Generator | None = None,
    pmesh=None,
):
    """Per-tick kernel path of ``run``: per-tick scalars precomputed over the
    timeline, one fused predict (K6) per tick, the GPS update (K7) on update
    ticks, moments finalized after the loop from the stacked partials. With
    ``pmesh``, per particle shard (``_run_ticks_sharded``), bitwise the
    unsharded run."""
    n = cfg.particle_count if n_particles is None else n_particles
    g = _generator(generator, timeline.ticks.device)
    nxy, nyaw_on = _noise_flags(params)
    s0 = init_state(n, params, g)
    pre = _tick_precompute(timeline, params, g)
    if pmesh is not None:
        final_parts, mean, cov = _run_ticks_sharded(pre, s0.particles, params, nxy, nyaw_on,
                                                    pmesh)
    else:
        final_parts, mean, cov = _run_ticks(pre, s0.particles, params, nxy, nyaw_on)
    out = {"mean": mean, "cov": cov, "updated": pre.do_update}
    return PFState(particles=final_parts, generator=g, t_prev=pre.lf[-1]), out


def run(
    timeline: Timeline,
    params: PFParams,
    cfg: PFConfig = PFConfig(),
    n_particles: int | None = None,
    generator: torch.Generator | None = None,
    scheme: str = "residual",
    use_pallas: bool = False,
    segmented: bool | None = None,
    pmesh=None,
):
    """Full-mission PF replay -> (final state, outputs stacked over ticks:
    mean (T,6), cov (T,3,3), updated (T,)). ``use_pallas=True`` with
    scheme="systematic" takes the kernel path; ``segmented`` picks
    ``run_fast_segmented`` (True, the default: timelines are always concrete
    here) or ``run_fast`` (False).

    ``pmesh``: a mesh with a ``particle`` axis shards the bank. The kernel
    paths keep each shard on its device for the whole replay; the dense
    path draws its noise for the whole bank from ``generator`` (so sharded
    equals unsharded) and resamples through the distributed resample (the
    systematic scheme) or on the joined bank (the others)."""
    if use_pallas and scheme == "systematic":
        if segmented is None or segmented:
            return run_fast_segmented(timeline, params, cfg, n_particles, generator,
                                      pmesh=pmesh)
        return run_fast(timeline, params, cfg, n_particles, generator, pmesh=pmesh)

    n = cfg.particle_count if n_particles is None else n_particles
    state = init_state(n, params, _generator(generator, timeline.ticks.device))
    outs = []
    for k in range(timeline.num_ticks):
        state, out = step(cfg, params, state, timeline.slice_tick(k), scheme, use_pallas, pmesh)
        outs.append(out)
    return state, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def pf_timeline(mission, freq_hz: float = 10.0) -> Timeline:
    """PF timeline from a simulated mission (numpy leaves): odometry
    (ground-truth-derived 13-dim), GPS fixes, diving flag; bit for bit the
    reference's."""
    s = mission.streams
    t_odom = np.arange(0.0, mission.spec.duration_s, 0.1)
    gt = mission.gt_at(t_odom)
    quat = quat_from_rpy_np(gt[:, 3:6])
    k = np.clip((t_odom * mission.spec.sim_hz).astype(int), 0, len(mission.t) - 1)
    odom13 = np.concatenate([gt[:, 0:3], quat, mission.vel_body[k], mission.gyro[k]], axis=1)
    dive = (gt[:, 2] < mission.spec.gps_surface_z).astype(np.float32)[:, None]
    return build_timeline(
        t0=0.0,
        t1=mission.spec.duration_s,
        freq_hz=freq_hz,
        channels={
            "odom": (t_odom, odom13),
            "gps": (s["gps"]["stamps"], s["gps"]["values"]),
            "diving": (t_odom, dive),
        },
    )
