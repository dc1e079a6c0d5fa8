"""Generator ``slam_fleet``: ``distinct`` simulated SLAM survey missions
(the port's ``io/workloads.slam_mission_timeline``), each on the
configuration's tick grid with odometry (ground-truth pose as a 13-dim
nav_msgs/Odometry row), GPS, diving and MBES detection events; the seed
picks the missions' seeds. A fleet of ``missions`` lanes tiles them: lane
b flies mission b % distinct. The mix's ``mission`` holds the simulator's
survey parameters (``traffic/sim.MissionSpec``)."""

from __future__ import annotations

import numpy as np

from navbench.traffic import sim
from navbench.traffic.generate import mission_seeds, quat_from_rpy_np
from navbench.traffic.timeline import build_timeline, stack


def slam_mission_timeline(cfg: dict, duration: float, seed: int, mission: dict) -> dict:
    """One simulated SLAM mission on cfg's tick grid (``system_freq``), MBES
    bursts padded to ``max_obs``."""
    m = sim.simulate(sim.MissionSpec(duration_s=duration, seed=seed, **mission))
    ticks = np.arange(0, duration + 1e-9, 1.0 / cfg["system_freq"])
    gt = m.gt_at(ticks)
    quat = quat_from_rpy_np(gt[:, 3:6])
    k = np.clip((ticks * m.spec.sim_hz).astype(int), 0, len(m.t) - 1)
    odom13 = np.concatenate([gt[:, 0:3], quat, m.vel_body[k], m.gyro[k]], axis=1)
    det, gps = m.streams["mbes_detections"], m.streams["gps"]
    return build_timeline(
        t0=0.0, t1=duration, freq_hz=cfg["system_freq"],
        channels={"odom": (ticks, odom13), "gps": (gps["stamps"], gps["values"]),
                  "diving": (ticks, np.zeros((len(ticks), 1)))},
        events={"mbes": (det["stamps"], det["values"], det["burst"], cfg["max_obs"])})


def make(mix: dict, cfg: dict, seed: int) -> dict:
    """{"distinct": stacked timeline of the distinct missions (leading axis
    N), "lane_mission": (B,) the mission each lane flies, "seeds"}."""
    seeds = mission_seeds(seed, mix["distinct"])
    tl = stack([slam_mission_timeline(cfg, mix["duration_s"], s, mix["mission"]) for s in seeds])
    lanes = np.arange(mix["missions"]) % mix["distinct"]
    return dict(distinct=tl, lane_mission=lanes, seeds=seeds)
