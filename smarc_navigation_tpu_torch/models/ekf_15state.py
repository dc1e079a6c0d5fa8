"""15-state EKF — the ``robot_localization`` dual-EKF equivalent (PyTorch
port of ``smarc_navigation_tpu/models/ekf_15state.py``).

The reference's SAM stack runs two instances of robot_localization's
``ekf_localization_node`` (15-state: position, orientation, linear velocity,
angular velocity, linear acceleration) configured through YAML/launch
(``sam_dead_reckoning/launch/dual_ekf_test.launch:100-230``,
``params/ekf_sam.yaml``): a *local* filter fusing depth pose + DVL twist +
SBG yaw/yaw-rate + STIM roll/pitch/rates with a thrust-derived control
input, and a *global* filter adding GPS x/y. Here:

* the omega-kinematics transition is a pure function and its 15×15
  Jacobian comes from ``torch.func.jacfwd``;
* every sensor is a boolean 15-mask + noise diagonal (the YAML ``*_config``
  matrices) applied as a masked identity measurement update;
* the control term is robot_localization's acceleration shaping,
  gain·(cmd_vel − v) clamped to the acceleration limits.

``run``/``run_dual`` replay one mission on the dense path; ``run_fleet`` and
``run_dual_fleet`` replay a fleet through one K10 launch per tick
(``ops.ekf15_kernels``).

State layout (robot_localization order): [x y z, roll pitch yaw, vx vy vz,
vroll vpitch vyaw, ax ay az]; velocities body-frame, position world-frame.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch.func import jacfwd

from ..ops.timeline import build_timeline
from ..utils.geometry import Transform, rotmat_from_rpy, rpy_from_quat, wrap_angle
from ..utils.linalg import spd_solve, symmetrize

STATE_DIM = 15
POS, ATT, VEL, RATE, ACC = slice(0, 3), slice(3, 6), slice(6, 9), slice(9, 12), slice(12, 15)


@dataclasses.dataclass(frozen=True)
class SensorSpec15:
    """One fused input: which state components it measures + its noise."""

    channel: str
    mask: Tuple[bool, ...]        # 15 bools (the YAML *_config matrix)
    noise_diag: Tuple[float, ...]  # 15-wide; only masked entries used
    timeout_s: float = 0.1        # sensor_timeout (launch :104)


# the reference's dual-filter wiring, from dual_ekf_test.launch +
# params/ekf_sam.yaml (see the reference module for the line citations)
LOCAL_SENSORS = (
    SensorSpec15(  # pose0 depth: z only
        "depth", (False,) * 2 + (True,) + (False,) * 12, (0.0,) * 2 + (0.1,) + (0.0,) * 12
    ),
    SensorSpec15(  # twist0 DVL: vx, vy
        "dvl",
        (False,) * 6 + (True, True, False) + (False,) * 6,
        (0.0,) * 6 + (0.01, 0.01, 0.0) + (0.0,) * 6,
    ),
    SensorSpec15(  # odom1 GPS: x, y (in the LOCAL filter too)
        "gps", (True, True) + (False,) * 13, (1.0, 1.0) + (0.0,) * 13
    ),
    SensorSpec15(  # imu0 SBG: yaw + yaw rate
        "sbg",
        (False,) * 5 + (True,) + (False,) * 5 + (True,) + (False,) * 3,
        (0.0,) * 5 + (0.01,) + (0.0,) * 5 + (0.01,) + (0.0,) * 3,
    ),
    SensorSpec15(  # imu1 STIM: roll, pitch + roll/pitch rates
        "stim",
        (False,) * 3 + (True, True, False) + (False,) * 3 + (True, True, False) + (False,) * 3,
        (0.0,) * 3 + (0.01, 0.01, 0.0) + (0.0,) * 3 + (0.01, 0.01, 0.0) + (0.0,) * 3,
    ),
)

# ekf_loc_global wiring: odom0 GPS (x, y), pose0 depth (z), twist0 DVL
# (vx, vy), imu0 SBG with full orientation + rates; imu1 STIM unused
GLOBAL_SENSORS = (
    SensorSpec15(
        "gps", (True, True) + (False,) * 13, (1.0, 1.0) + (0.0,) * 13
    ),
    SensorSpec15(
        "depth", (False,) * 2 + (True,) + (False,) * 12, (0.0,) * 2 + (0.1,) + (0.0,) * 12
    ),
    SensorSpec15(
        "dvl",
        (False,) * 6 + (True, True, False) + (False,) * 6,
        (0.0,) * 6 + (0.01, 0.01, 0.0) + (0.0,) * 6,
    ),
    SensorSpec15(
        "sbg",
        (False,) * 3 + (True,) * 3 + (False,) * 3 + (True,) * 3 + (False,) * 3,
        (0.0,) * 3 + (0.01,) * 3 + (0.0,) * 3 + (0.01,) * 3 + (0.0,) * 3,
    ),
)

# process/initial covariances, params/ekf_sam.yaml (x y z r p y vx vy vz
# vr vp vy ax ay az); the global filter's own tuning differs in x, y and vy
LOCAL_PROCESS_NOISE_DIAG = (
    1e-3, 1e-2, 1e-2, 0.3, 0.3, 0.01, 0.5, 0.01, 0.1, 0.3, 0.3, 0.3, 0.3, 0.3, 0.3
)
LOCAL_INITIAL_COV_DIAG = (
    1e-3, 1e-3, 1e-3, 1.0, 1.0, 1e-1, 1e-3, 1e-3, 1e-3, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0
)
GLOBAL_PROCESS_NOISE_DIAG = (
    1.0, 1.0, 1e-3, 0.3, 0.3, 0.01, 0.5, 0.5, 0.1, 0.3, 0.3, 0.3, 0.3, 0.3, 0.3
)
GLOBAL_INITIAL_COV_DIAG = (
    1.0, 1.0, 1e-9, 1.0, 1.0, 1e-9, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0
)


@dataclasses.dataclass(frozen=True)
class Ekf15Config:
    frequency: float = 100.0                      # launch :103
    sensors: Tuple[SensorSpec15, ...] = LOCAL_SENSORS
    process_noise_diag: Tuple[float, ...] = LOCAL_PROCESS_NOISE_DIAG
    initial_cov_diag: Tuple[float, ...] = LOCAL_INITIAL_COV_DIAG
    # control shaping (launch :212-227: use_control, control_config x/y,
    # acceleration/deceleration limits and gains all 0.1 on x, y)
    use_control: bool = True
    control_gains: Tuple[float, ...] = (0.1, 0.1, 0.0)
    control_limits: Tuple[float, ...] = (0.1, 0.1, 0.0)


def global_config(frequency: float = 100.0) -> Ekf15Config:
    """The ekf_loc_global instance: GPS + depth + DVL + full-SBG sensor set
    with the global yaml tuning (map-frame world)."""
    return Ekf15Config(
        frequency=frequency,
        sensors=GLOBAL_SENSORS,
        process_noise_diag=GLOBAL_PROCESS_NOISE_DIAG,
        initial_cov_diag=GLOBAL_INITIAL_COV_DIAG,
    )


class Ekf15State(NamedTuple):
    x: torch.Tensor      # (15,)
    P: torch.Tensor      # (15, 15)
    t_prev: torch.Tensor


def init_state(cfg: Ekf15Config, x0=None, dtype=torch.float32, device="cuda") -> Ekf15State:
    x = (torch.zeros(STATE_DIM, dtype=dtype, device=device) if x0 is None
         else torch.as_tensor(x0, dtype=dtype, device=device))
    return Ekf15State(
        x=x,
        P=torch.diag(torch.as_tensor(cfg.initial_cov_diag, dtype=dtype, device=device)),
        t_prev=torch.zeros((), dtype=dtype, device=device),
    )


# ---------------------------------------------------------------------------
# transition
# ---------------------------------------------------------------------------

def _euler_rate_matrix(rpy: torch.Tensor) -> torch.Tensor:
    """Body rates -> Euler angle rates."""
    r, p = rpy[0], rpy[1]
    sr, cr = torch.sin(r), torch.cos(r)
    cp = torch.cos(p)
    tp = torch.tan(p)
    one, zero = torch.ones_like(sr), torch.zeros_like(sr)
    return torch.stack([
        torch.stack([one, sr * tp, cr * tp]),
        torch.stack([zero, cr, -sr]),
        torch.stack([zero, sr / cp, cr / cp]),
    ])


def transition(x: torch.Tensor, dt, accel_cmd: torch.Tensor | None = None) -> torch.Tensor:
    """Discrete omega-kinematics step (robot_localization's motion model)."""
    pos, rpy, v, w, a = x[POS], x[ATT], x[VEL], x[RATE], x[ACC]
    if accel_cmd is not None:
        a = a + accel_cmd  # control-shaped acceleration adds to the state term
    R = rotmat_from_rpy(rpy)
    pos_n = pos + R @ (v * dt + 0.5 * a * dt * dt)
    rpy_n = wrap_angle(rpy + _euler_rate_matrix(rpy) @ (w * dt))
    v_n = v + a * dt
    return torch.cat([pos_n, rpy_n, v_n, w, x[ACC]])


def control_accel(cfg: Ekf15Config, v: torch.Tensor, cmd_vel: torch.Tensor) -> torch.Tensor:
    """Control-to-acceleration shaping: gain·(cmd − v) clamped to limits."""
    g = torch.as_tensor(cfg.control_gains, dtype=v.dtype, device=v.device)
    lim = torch.as_tensor(cfg.control_limits, dtype=v.dtype, device=v.device)
    return torch.minimum(torch.maximum(g * (cmd_vel - v[:3]), -lim), lim)


def predict(state: Ekf15State, cfg: Ekf15Config, dt, accel_cmd=None) -> Ekf15State:
    def f(x):
        return transition(x, dt, accel_cmd)

    x_n = f(state.x)
    F = jacfwd(f)(state.x)
    Q = torch.diag(torch.as_tensor(cfg.process_noise_diag, dtype=state.x.dtype,
                                   device=state.x.device)) * dt
    P_n = symmetrize(F @ state.P @ F.T + Q)
    return Ekf15State(x=x_n, P=P_n, t_prev=state.t_prev)


# ---------------------------------------------------------------------------
# masked identity update
# ---------------------------------------------------------------------------

def update(
    state: Ekf15State,
    z15: torch.Tensor,        # (15,) measurement padded to full state layout
    spec_mask: torch.Tensor,  # (15,) bool
    noise_diag: torch.Tensor,
    apply: torch.Tensor,      # scalar bool: sensor fresh & within timeout
) -> Ekf15State:
    """EKF update through a masked identity H. Unmeasured components get a
    huge noise instead of a shape change (their Kalman gain is ~0 and the
    ``apply`` flag gates the whole update anyway)."""
    x, P = state.x, state.P
    big = torch.full_like(x, 1e12)
    r = torch.where(spec_mask, torch.clamp_min(noise_diag, 1e-9), big)
    nu = z15 - x
    nu = torch.cat([nu[0:3], wrap_angle(nu[3:6]), nu[6:]])
    nu = torch.where(spec_mask, nu, 0.0)

    S = P + torch.diag(r)
    K = spd_solve(S, P).T                  # P S⁻¹ (H = I)
    x_n = x + K @ nu
    x_n = torch.cat([x_n[0:3], wrap_angle(x_n[3:6]), x_n[6:]])
    P_n = symmetrize((torch.eye(STATE_DIM, dtype=x.dtype, device=x.device) - K) @ P)
    return Ekf15State(
        x=torch.where(apply, x_n, x),
        P=torch.where(apply, P_n, P),
        t_prev=state.t_prev,
    )


# ---------------------------------------------------------------------------
# tick + replay (dual pair)
# ---------------------------------------------------------------------------

def step(cfg: Ekf15Config, state: Ekf15State, tick) -> Tuple[Ekf15State, dict]:
    t_now = tick.ticks
    dt = torch.clamp_min(t_now - state.t_prev, 0.0)

    accel_cmd = None
    if cfg.use_control and "cmd_vel" in tick.channels:
        cmd = tick.channels["cmd_vel"]
        accel_cmd = torch.where(cmd.valid, control_accel(cfg, state.x[VEL], cmd.value[0:3]),
                                torch.zeros_like(state.x[VEL]))
    st = predict(state, cfg, dt, accel_cmd)

    for spec in cfg.sensors:
        if spec.channel not in tick.channels:
            # configured input not wired in this mission (e.g. a GPS-denied
            # replay without a gps channel): like a never-publishing topic
            continue
        ch = tick.channels[spec.channel]
        apply = ch.fresh & (ch.age < spec.timeout_s)
        st = update(
            st,
            ch.value[0:STATE_DIM],
            torch.as_tensor(spec.mask, device=st.x.device),
            torch.as_tensor(spec.noise_diag, dtype=st.x.dtype, device=st.x.device),
            apply,
        )

    st = st._replace(t_prev=t_now)
    return st, {"x": st.x, "p_diag": torch.diagonal(st.P)}


def run(timeline, cfg: Ekf15Config = Ekf15Config(), state0=None):
    """Replay one mission (tensor-leaved Timeline) -> (final state, outputs
    stacked over ticks)."""
    s0 = init_state(cfg, device=timeline.ticks.device) if state0 is None else state0
    state, outs = s0, []
    for k in range(timeline.num_ticks):
        state, out = step(cfg, state, timeline.slice_tick(k))
        outs.append(out)
    return state, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def map_to_odom_correction(x_global: torch.Tensor, x_local: torch.Tensor) -> Transform:
    """The dual-EKF map->odom tf: T_map_odom = T_map_base · T_odom_base⁻¹,
    from the global filter's map-frame pose and the local filter's
    odom-frame pose (what ekf_loc_global broadcasts with ``publish_tf``).
    Accepts leading batch/time axes; maps odom-frame points into the map
    frame."""
    t_map_base = Transform(rot=rotmat_from_rpy(x_global[..., 3:6]), trans=x_global[..., 0:3])
    t_odom_base = Transform(rot=rotmat_from_rpy(x_local[..., 3:6]), trans=x_local[..., 0:3])
    return t_map_base.compose(t_odom_base.inverse())


def run_dual(
    timeline_local,
    timeline_global,
    cfg_local: Ekf15Config = Ekf15Config(),
    cfg_global: Ekf15Config | None = None,
):
    """The dual-EKF pair (dual_ekf_test.launch:102-345): local filter in the
    odom frame, global filter in the map frame with its own yaml tuning.
    Returns both runs plus the per-tick map->odom corrections."""
    if cfg_global is None:
        cfg_global = global_config(frequency=cfg_local.frequency)
    final_l, out_l = run(timeline_local, cfg_local)
    final_g, out_g = run(timeline_global, cfg_global)
    map_odom = map_to_odom_correction(out_g["x"], out_l["x"])
    return (final_l, out_l), (final_g, out_g), map_odom


def ekf15_timeline(mission, cfg: Ekf15Config, include_gps: bool = False):
    """The dual-EKF sensor timeline (numpy leaves) from a simulated mission:
    depth, DVL, SBG (yaw/yaw-rate), STIM (roll/pitch/rates), cmd_vel,
    optional GPS, each padded into the 15-wide state layout. The attitude
    and the control acceleration are computed in float32 PyTorch on the
    CPU."""
    from . import motion_model

    s = mission.streams

    def pad(vals, idx):
        out = np.zeros((len(vals), STATE_DIM))
        for k, i in enumerate(idx):
            out[:, i] = vals[:, k]
        return out

    depth = pad(s["depth"]["values"], [2])
    dvl = pad(s["dvl"]["values"][:, 0:2], [6, 7])

    imu_q = s["imu"]["values"][:, 0:4]
    rpy = rpy_from_quat(torch.as_tensor(imu_q, dtype=torch.float32)).numpy()
    gyro = s["imu"]["values"][:, 4:7]
    sbg = pad(np.stack([rpy[:, 2], gyro[:, 2]], -1), [5, 11])
    stim = pad(np.concatenate([rpy[:, 0:2], gyro[:, 0:2]], -1), [3, 4, 9, 10])

    # control channel: the launch remaps cmd_vel -> motion_acc, the SAM
    # motion model's body-plane thrust response on x/y
    ctl = s["control"]["values"]
    acc_mm = motion_model.acceleration(torch.as_tensor(ctl, dtype=torch.float32)).numpy()
    cmd = np.zeros((len(ctl), 3))
    cmd[:, 0:2] = acc_mm[:, 0:2]

    channels = {
        "depth": (s["depth"]["stamps"], depth),
        "dvl": (s["dvl"]["stamps"], dvl),
        "sbg": (s["imu"]["stamps"], sbg),
        "stim": (s["imu"]["stamps"], stim),
        "cmd_vel": (s["control"]["stamps"], cmd),
    }
    if include_gps:
        channels["gps"] = (s["gps"]["stamps"], pad(s["gps"]["values"], [0, 1]))
    return build_timeline(
        t0=0.0, t1=mission.spec.duration_s, freq_hz=cfg.frequency, channels=channels
    )


def run_fleet(batched_timeline, cfg: Ekf15Config = Ekf15Config(), x0=None,
              graph: bool = True):
    """Fleet replay through K10, one launch per tick
    (``ops.ekf15_kernels.run_fleet15``; on CUDA tensors a cached CUDA graph
    of the tick loop unless ``graph=False``)."""
    from ..ops import ekf15_kernels

    return ekf15_kernels.run_fleet15(batched_timeline, cfg, x0=x0, graph=graph)


def run_dual_fleet(
    batched_local,
    batched_global,
    cfg_local: Ekf15Config = Ekf15Config(),
    cfg_global: Ekf15Config | None = None,
    graph: bool = True,
):
    """The dual-EKF pair at fleet scale: both filters of every mission
    through K10 (two replays, each with its own sensor wiring and so its own
    cached CUDA graph on the card unless ``graph=False``) plus the batched
    per-tick map->odom corrections (T, B, ...)."""
    if cfg_global is None:
        cfg_global = global_config(frequency=cfg_local.frequency)
    final_l, out_l = run_fleet(batched_local, cfg_local, graph=graph)
    final_g, out_g = run_fleet(batched_global, cfg_global, graph=graph)
    map_odom = map_to_odom_correction(out_g["x"], out_l["x"])
    return (final_l, out_l), (final_g, out_g), map_odom
