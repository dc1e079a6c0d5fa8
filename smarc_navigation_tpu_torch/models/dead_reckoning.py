"""Dead-reckoning odometry providers (PyTorch port of
``smarc_navigation_tpu/models/dead_reckoning.py``).

Two families, as in the reference (SURVEY.md §2.2):

* ``sam_dr`` — the SAM vehicle dead-reckoning chain
  (``sam_dead_reckoning/scripts/dr_node.py:165-246``): integrate STIM gyro
  yaw (roll/pitch absolute from the orientation quaternion), integrate DVL
  body velocity gated by staleness and sanity bounds with a SAM motion-model
  fallback, substitute pressure depth directly. ``run_sam_dr`` is the tick
  loop; ``run_sam_dr_vectorized`` the closed form (two cumsums, no loop).

* ``odom_provider`` — the LoLo odometry provider
  (``auv_odom_provider/src/odom_provider.cpp:240-324``): Bézier-extrapolate
  stale DVL over the last-5 window, smooth the DVL axes with scalar KFs,
  rotate the body displacement into the odom frame, accumulate increments.

Every step broadcasts over leading mission axes: the tick loops take a
single-mission timeline (leaves (T, ...)) or a batched one (leaves
(B, T, ...)) and run on the device of its tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..configs import DRConfig, OdomProviderConfig, SAMConfig
from ..ops import bezier, oned_kf
from ..ops.timeline import Timeline, build_timeline
from ..utils.geometry import rotmat_from_rpy, rpy_from_quat, wrap_angle
from . import motion_model


def _matvec(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", R, v)


def _tick_at(timeline: Timeline, k: int):
    """Tick k of a single-mission (leaves (T, ...)) or batched (leaves
    (B, T, ...)) timeline."""
    axis = timeline.ticks.dim() - 1
    return timeline.map(lambda x: x.select(axis, k))


def _stack_ticks(timeline: Timeline, outs: list) -> torch.Tensor:
    return torch.stack(outs, dim=timeline.ticks.dim() - 1)


# ===========================================================================
# SAM dead-reckoning (dr_node)
# ===========================================================================

class DRState(NamedTuple):
    pos: torch.Tensor          # (..., 3) odom-frame position
    rpy: torch.Tensor          # (..., 3) attitude (yaw integrated, roll/pitch absolute)
    lin_vel: torch.Tensor      # (..., 3) latest body velocity used
    vel_rot: torch.Tensor      # (..., 3) latest body rates
    t_stim_prev: torch.Tensor  # (...,)


def dr_init(dtype=torch.float32, device="cuda", batch: tuple = ()) -> DRState:
    z3 = torch.zeros(tuple(batch) + (3,), dtype=dtype, device=device)
    return DRState(pos=z3, rpy=z3, lin_vel=z3, vel_rot=z3,
                   t_stim_prev=torch.zeros(tuple(batch), dtype=dtype, device=device))


def dr_step(
    cfg: DRConfig,
    sam_cfg: SAMConfig,
    state: DRState,
    tick,
) -> Tuple[DRState, torch.Tensor]:
    """One DR tick. ``tick`` is a per-tick Timeline slice with channels imu
    (quat4+gyro3), dvl (vel3), depth (z1), control (rpm, dr).

    Returns (new_state, odom_out (..., 9)) with odom = [pose6, body_vel3]."""
    imu = tick.channels["imu"]
    dvl = tick.channels["dvl"]
    depth = tick.channels["depth"]
    ctl = tick.channels["control"]

    # attitude: integrate gyro yaw between IMU stamps, absolute roll/pitch
    # (dr_node.py:281-308)
    gyro = imu.value[..., 4:7]
    dt_imu = torch.clamp(imu.stamp - state.t_stim_prev, min=0.0)
    rot = state.rpy + gyro * dt_imu[..., None]
    abs_rpy = rpy_from_quat(imu.value[..., 0:4])
    rot = torch.stack([abs_rpy[..., 0], abs_rpy[..., 1], wrap_angle(rot[..., 2])], dim=-1)
    fresh = imu.fresh[..., None]
    new_rpy = torch.where(fresh, rot, state.rpy)
    t_stim = torch.where(imu.fresh, imu.stamp, state.t_stim_prev)
    vel_rot = torch.where(fresh, gyro, state.vel_rot)

    # linear velocity: DVL if fresh and sane, else the motion-model fallback
    # (dr_node.py:176-201)
    v = dvl.value
    dvl_ok = ((dvl.age < cfg.dvl_period) & (torch.abs(v[..., 1]) < cfg.dvl_vy_max)
              & (v[..., 0] < cfg.dvl_vx_max) & (v[..., 0] > cfg.dvl_vx_min))
    d_angle = torch.clamp(-ctl.value[..., 1], -cfg.thrust_vec_max_rad, cfg.thrust_vec_max_rad)
    mm_vel = motion_model.dr_fallback_velocity(
        torch.stack([ctl.value[..., 0], d_angle], dim=-1), cfg.dr_period, sam_cfg)
    lin_vel = torch.where(dvl_ok[..., None], v, mm_vel)
    # no DVL contact yet -> no linear integration at all (dvl_on gate)
    lin_vel = torch.where(dvl.valid[..., None], lin_vel, torch.zeros_like(lin_vel))

    # integrate x/y in the odom frame; depth measured directly
    # (dr_node.py:204-208)
    step_odom = _matvec(rotmat_from_rpy(new_rpy), lin_vel * cfg.dr_period)
    z = torch.where(depth.valid, depth.value[..., 0], state.pos[..., 2])
    pos = torch.cat([state.pos[..., 0:2] + step_odom[..., 0:2], z[..., None]], dim=-1)

    new_state = DRState(pos=pos, rpy=new_rpy, lin_vel=lin_vel, vel_rot=vel_rot,
                        t_stim_prev=t_stim)
    return new_state, torch.cat([pos, new_rpy, lin_vel], dim=-1)


def run_sam_dr_vectorized(timeline: Timeline, cfg: DRConfig = DRConfig(),
                          sam_cfg: SAMConfig = SAMConfig()) -> torch.Tensor:
    """Closed-form SAM DR replay: the tick recurrence is associative, so the
    whole mission is ~25 elementwise ops and two cumsums over the tick axis:

    * yaw_t = wrap(cumsum of gyro_z * dt between fresh IMU stamps): the wrap
      commutes with the sum modulo 2π, and only cos/sin and the wrapped
      output consume it;
    * roll/pitch/velocities/depth are queue-latest channel values;
    * pos_xy = cumsum of R(rpy_t) (v_t * dr_period).

    ``run_sam_dr``'s result up to the f32 rounding of the cumsums; takes a
    single-mission (T, ...) or batched (B, T, ...) timeline."""
    imu = timeline.channels["imu"]
    dvl = timeline.channels["dvl"]
    depth = timeline.channels["depth"]
    ctl = timeline.channels["control"]

    # attitude: absolute roll/pitch; yaw integrated over fresh-IMU intervals
    abs_rpy = rpy_from_quat(imu.value[..., 0:4])
    # the previous tick's queue-latest stamp is the stamp of the last fresh
    # IMU before this tick; -inf (no message yet) clamps to the loop's t0=0
    prev_stamp = torch.clamp(torch.cat([torch.zeros_like(imu.stamp[..., :1]),
                                        imu.stamp[..., :-1]], dim=-1), min=0.0)
    dyaw = torch.where(imu.fresh,
                       imu.value[..., 6] * torch.clamp(imu.stamp - prev_stamp, min=0.0),
                       torch.zeros_like(imu.stamp))
    yaw = torch.cumsum(dyaw, dim=-1)
    seen_imu = torch.cumsum(imu.fresh.to(torch.int32), dim=-1) > 0
    zero = torch.zeros_like(yaw)
    rpy = torch.stack([torch.where(seen_imu, abs_rpy[..., 0], zero),
                       torch.where(seen_imu, abs_rpy[..., 1], zero),
                       torch.where(seen_imu, yaw, zero)], dim=-1)

    # velocity: DVL gated by staleness and sanity, motion-model fallback
    v = dvl.value
    dvl_ok = ((dvl.age < cfg.dvl_period) & (torch.abs(v[..., 1]) < cfg.dvl_vy_max)
              & (v[..., 0] < cfg.dvl_vx_max) & (v[..., 0] > cfg.dvl_vx_min))
    d_angle = torch.clamp(-ctl.value[..., 1], -cfg.thrust_vec_max_rad, cfg.thrust_vec_max_rad)
    mm_vel = motion_model.dr_fallback_velocity(
        torch.stack([ctl.value[..., 0], d_angle], dim=-1), cfg.dr_period, sam_cfg)
    lin_vel = torch.where(dvl_ok[..., None], v, mm_vel)
    lin_vel = torch.where(dvl.valid[..., None], lin_vel, torch.zeros_like(lin_vel))

    # position: cumsum of odom-frame steps; depth substituted directly
    step = _matvec(rotmat_from_rpy(rpy), lin_vel * cfg.dr_period)
    pos_xy = torch.cumsum(step[..., 0:2], dim=-2)
    pos_z = torch.where(depth.valid, depth.value[..., 0], zero)

    rpy_out = torch.cat([rpy[..., 0:2], wrap_angle(rpy[..., 2:3])], dim=-1)
    return torch.cat([pos_xy, pos_z[..., None], rpy_out, lin_vel], dim=-1)


def run_sam_dr(timeline: Timeline, cfg: DRConfig = DRConfig(),
               sam_cfg: SAMConfig = SAMConfig()) -> torch.Tensor:
    """Replay a whole mission tick by tick: -> (..., T, 9) [pose6,
    body_vel3] per tick."""
    ticks = timeline.ticks
    state = dr_init(ticks.dtype, ticks.device, ticks.shape[:-1])
    outs = []
    for k in range(timeline.num_ticks):
        state, out = dr_step(cfg, sam_cfg, state, _tick_at(timeline, k))
        outs.append(out)
    return _stack_ticks(timeline, outs)


def sam_timeline(mission, cfg: DRConfig = DRConfig()) -> Timeline:
    """The SAM DR tick timeline of a simulated or recorded mission (numpy
    leaves; ``.to(device)`` ships it)."""
    s = mission.streams
    return build_timeline(
        t0=0.0,
        t1=mission.spec.duration_s,
        freq_hz=1.0 / cfg.dr_period,
        channels={
            "imu": (s["imu"]["stamps"], s["imu"]["values"]),
            "dvl": (s["dvl"]["stamps"], s["dvl"]["values"]),
            "depth": (s["depth"]["stamps"], s["depth"]["values"]),
            "control": (s["control"]["stamps"], s["control"]["values"]),
        },
    )


# ===========================================================================
# LoLo odometry provider (odom_provider)
# ===========================================================================

class OdomState(NamedTuple):
    cumul: torch.Tensor        # (..., 6) accumulated odom pose
    t_prev: torch.Tensor       # (...,)
    kf: oned_kf.OneDKFState    # (..., 3) per-DVL-axis smoother


def odom_init(cfg: OdomProviderConfig, init_pose=None, dtype=torch.float32,
              device="cuda", batch: tuple = ()) -> OdomState:
    """``init_pose``: the starting 6-DOF pose. The reference initializes from
    the ground-truth topic once its queues fill (``odom_provider.cpp:
    261-284``); replays pass the first GT/GPS-derived pose."""
    batch = tuple(batch)
    cumul = (torch.zeros(batch + (6,), dtype=dtype, device=device) if init_pose is None
             else torch.as_tensor(init_pose, dtype=dtype, device=device).expand(batch + (6,)))
    return OdomState(
        cumul=cumul,
        t_prev=torch.zeros(batch, dtype=dtype, device=device),
        kf=oned_kf.init(cfg.kf_mu0, cfg.kf_sigma0,
                        like=torch.zeros(batch + (3,), dtype=dtype, device=device)),
    )


def odom_step(
    cfg: OdomProviderConfig,
    r_base_dvl: torch.Tensor,   # (3,3) DVL->base extrinsic rotation
    state: OdomState,
    tick,
) -> Tuple[OdomState, torch.Tensor]:
    """One 30 Hz odometry tick (``odom_provider.cpp:240-324``)."""
    imu = tick.channels["imu"]          # quat in the odom frame
    dvlw = tick.windows["dvl"]          # last-W window
    t_now = tick.ticks

    # staleness: if the newest DVL is older than the gate, Bézier-extrapolate
    # the window (odom_provider.cpp:291-295 -> 126-165)
    stale = (t_now - dvlw.stamp[..., -1]) > cfg.dvl_stale_s
    v_interp = bezier.bezier_interpolate(dvlw.value, dvlw.stamp, t_now)
    v_raw = torch.where(stale[..., None], v_interp, dvlw.value[..., -1, :])

    # scalar-KF smooth each axis (odom_provider.cpp:311-313)
    kf_next = oned_kf.step(state.kf, v_raw, cfg.kf_r, cfg.kf_q)
    v = kf_next.mu

    # body displacement -> odom frame (odom_provider.cpp:167-206)
    dt = torch.clamp(t_now - state.t_prev, min=0.0)
    disp_base = _matvec(r_base_dvl, v * dt[..., None])
    rpy_t = rpy_from_quat(imu.value[..., 0:4])
    disp_odom = _matvec(rotmat_from_rpy(rpy_t), disp_base)
    drpy = wrap_angle(rpy_t - state.cumul[..., 3:6])

    cumul = state.cumul + torch.cat([disp_odom, drpy], dim=-1)
    cumul = torch.cat([cumul[..., 0:3], wrap_angle(cumul[..., 3:6])], dim=-1)
    return OdomState(cumul=cumul, t_prev=t_now, kf=kf_next), cumul


def run_odom_provider(
    timeline: Timeline,
    cfg: OdomProviderConfig = OdomProviderConfig(),
    r_base_dvl: torch.Tensor | None = None,
    init_pose=None,
) -> torch.Tensor:
    """Replay: -> (..., T, 6) accumulated odom pose per tick."""
    ticks = timeline.ticks
    if r_base_dvl is None:
        r_base_dvl = torch.eye(3, dtype=ticks.dtype, device=ticks.device)
    state = odom_init(cfg, init_pose, ticks.dtype, ticks.device, ticks.shape[:-1])
    outs = []
    for k in range(timeline.num_ticks):
        state, out = odom_step(cfg, r_base_dvl, state, _tick_at(timeline, k))
        outs.append(out)
    return _stack_ticks(timeline, outs)


def odom_timeline(mission, cfg: OdomProviderConfig = OdomProviderConfig()) -> Timeline:
    s = mission.streams
    return build_timeline(
        t0=0.0,
        t1=mission.spec.duration_s,
        freq_hz=cfg.system_freq,
        channels={"imu": (s["imu"]["stamps"], s["imu"]["values"])},
        windows={"dvl": (s["dvl"]["stamps"], s["dvl"]["values"], cfg.dvl_window)},
    )
