"""The benchmark's traffic generators. A traffic mix is a JSON file of
parameters, ``navbench/traffic/mixes/<traffic>.json``, whose ``generator``
names a module ``navbench/traffic/generators/<generator>.py``; its
``make(mix, cfg, seed)`` builds the traffic, all numpy, from the run's
seed. A later mix that a new generator serves adds that module as a file
of its own. What the generators share is here: the mission seeds drawn
from the run's seed, the quaternion of the logs' odometry, and the
frozen form of the port's binning of a recorded log onto the tick grid.
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np

from .timeline import build_timeline

GENERATORS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "generators")


def mission_seeds(seed: int, n: int) -> list:
    """n mission seeds drawn from the run's seed (any whole number)."""
    rng = np.random.default_rng(seed % 2**64)
    return [int(s) for s in rng.integers(0, 2**31 - 1, n)]


def quat_from_rpy_np(rpy):
    """(..., 3) rpy -> (..., 4) xyzw quaternion (tf createQuaternionFromRPY)."""
    rpy = np.asarray(rpy)
    hr, hp, hy = rpy[..., 0] * 0.5, rpy[..., 1] * 0.5, rpy[..., 2] * 0.5
    cr, sr = np.cos(hr), np.sin(hr)
    cp, sp = np.cos(hp), np.sin(hp)
    cy, sy = np.cos(hy), np.sin(hy)
    return np.stack([sr * cp * cy - cr * sp * sy, cr * sp * cy + sr * cp * sy,
                     cr * cp * sy - sr * sp * cy, cr * cp * cy + sr * sp * sy], axis=-1)


def generator(name: str, root: str | None = None):
    """The generator module ``<root>/traffic/generators/<name>.py`` (root:
    the benchmark's folder)."""
    d = os.path.join(root, "traffic", "generators") if root else GENERATORS
    spec = importlib.util.spec_from_file_location(f"navbench_generator_{name}",
                                                  os.path.join(d, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make(mix: dict, cfg: dict, seed: int, root: str | None = None):
    """The traffic of a mix, by the generator it names."""
    return generator(mix["generator"], root).make(mix, cfg, seed)


def log_to_timeline(streams: dict, freq_hz: float, channels: tuple, events: dict) -> dict:
    """The port's ``io/logs.log_to_timeline`` for latest-value channels and
    event streams: stamps relative to the earliest used stream's first, the
    grid from 0 to the latest used stamp."""
    used = list(channels) + list(events)
    base = min(streams[n]["stamps"][0] for n in used if len(streams[n]["stamps"]))
    t1 = max(streams[n]["stamps"][-1] for n in used if len(streams[n]["stamps"])) - base

    def rel(n):
        return np.asarray(streams[n]["stamps"], np.float64) - base

    return build_timeline(
        t0=0.0, t1=t1, freq_hz=freq_hz,
        channels={n: (rel(n), streams[n]["values"]) for n in channels},
        events={n: (rel(n), streams[n]["values"],
                    streams[n].get("burst", np.arange(len(streams[n]["stamps"]))), k)
                for n, k in events.items()})
