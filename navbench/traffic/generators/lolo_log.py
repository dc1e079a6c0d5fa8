"""Generator ``lolo_log``: ``missions`` recorded-log stream sets, each a
LoLo survey as ``data/make_sample_log.py`` writes it (simulator streams,
MBES renamed, a 13-dim odometry stream at ``odom_hz`` from ground truth),
in the port's log schema (``io/logs.py``); the seed picks the missions'
seeds. ``traffic/generate.log_to_timeline`` is the frozen form of the
port's binning of such a log onto the tick grid."""

from __future__ import annotations

import numpy as np

from navbench.traffic import sim
from navbench.traffic.generate import mission_seeds, quat_from_rpy_np


def lolo_log(mix: dict, seed: int) -> dict:
    """One LoLo survey's streams in the log schema: {name: {"stamps",
    "values"[, "burst"]}}."""
    m = sim.simulate(sim.MissionSpec(duration_s=mix["duration_s"], seed=seed, **mix["mission"]))
    streams = {}
    for name, s in m.streams.items():
        streams[name] = {k: s[k] for k in ("stamps", "values", "burst") if k in s}
    streams["gt"] = {"stamps": m.t, "values": m.gt_at(m.t)}
    streams["mbes"] = streams.pop("mbes_detections")
    ticks = np.arange(0.0, m.spec.duration_s, 1.0 / mix["odom_hz"])
    gt = m.gt_at(ticks)
    k = np.clip((ticks * m.spec.sim_hz).astype(int), 0, len(m.t) - 1)
    odom13 = np.concatenate([gt[:, 0:3], quat_from_rpy_np(gt[:, 3:6]), m.vel_body[k],
                             m.gyro[k]], axis=1)
    streams["odom"] = {"stamps": ticks, "values": odom13}
    return streams


def make(mix: dict, cfg: dict, seed: int) -> list:
    return [lolo_log(mix, s) for s in mission_seeds(seed, mix["missions"])]
