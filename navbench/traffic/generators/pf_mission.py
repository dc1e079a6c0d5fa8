"""Generator ``pf_mission``: ``distinct`` simulated missions of the
GPS-weighted particle filter, each the mission of ``run.py pf`` (the
simulator's lawnmower survey with the mix's ``mission`` parameters,
``traffic/sim.MissionSpec``) on a 10 Hz tick grid: odometry (the
ground-truth pose as a 13-dim nav_msgs/Odometry row) at ``odom_hz``, the
GPS fixes, and the diving flag (the vehicle below ``gps_surface_z``). The
seed picks the missions' seeds.

A frozen numpy copy of the port's ``models/particle_filter.pf_timeline``;
``navbench/tests/test_pf_traffic.py`` holds it to checksums recorded from
the port's own ``pf_timeline`` (``navbench/traffic/pf_checksums.json``)."""

from __future__ import annotations

import numpy as np

from navbench.traffic import sim
from navbench.traffic.generate import mission_seeds, quat_from_rpy_np
from navbench.traffic.timeline import build_timeline, stack

FREQ_HZ = 10.0          # the filter's tick grid (pf_timeline's default)


def pf_mission_timeline(duration: float, seed: int, mission: dict, odom_hz: float) -> dict:
    """One simulated PF mission on the 10 Hz tick grid."""
    m = sim.simulate(sim.MissionSpec(duration_s=duration, seed=seed, **mission))
    gps = m.streams["gps"]
    t_odom = np.arange(0.0, duration, 1.0 / odom_hz)
    gt = m.gt_at(t_odom)
    quat = quat_from_rpy_np(gt[:, 3:6])
    k = np.clip((t_odom * m.spec.sim_hz).astype(int), 0, len(m.t) - 1)
    odom13 = np.concatenate([gt[:, 0:3], quat, m.vel_body[k], m.gyro[k]], axis=1)
    dive = (gt[:, 2] < m.spec.gps_surface_z).astype(np.float32)[:, None]
    return build_timeline(
        t0=0.0, t1=duration, freq_hz=FREQ_HZ,
        channels={"odom": (t_odom, odom13), "gps": (gps["stamps"], gps["values"]),
                  "diving": (t_odom, dive)})


def make(mix: dict, cfg: dict, seed: int) -> dict:
    """{"distinct": stacked timeline of the distinct missions (leading axis
    N), "seeds": their simulator seeds}."""
    seeds = mission_seeds(seed, mix["distinct"])
    tl = stack([pf_mission_timeline(mix["duration_s"], s, mix["mission"], mix["odom_hz"])
                for s in seeds])
    return dict(distinct=tl, seeds=seeds)
