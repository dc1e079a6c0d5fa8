"""Recorded-log ingestion: the rosbag-replay workflow without ROS.

The reference validates filters by replaying recorded rosbags
(``auv_ekf_localization/rosbags/rosbag_handler.py:7-49``; record hooks in
``auv_ekf_localization/launch/ekf_localization.launch:44-46`` and
``auv_ekf_slam/launch/ekf_slam.launch:47-48``). This module defines the
equivalent recorded-mission format (port of
``smarc_navigation_tpu/io/logs.py``: host numpy, the reference's code):

**Log schema** — one ``.npz`` file holding stamped streams:

    <name>/stamps : (M,) float64 seconds (monotonic per stream)
    <name>/values : (M, D) float64 payload rows
    <name>/burst  : (M,) int64, OPTIONAL — groups detection rows into
                    bursts (PoseArray messages); presence marks the stream
                    as an event stream
    __meta__      : json string with free-form metadata (topic names,
                    vehicle, conversion provenance)

Stream payload conventions (matching ``io.observability.flatten_odometry``
and the timeline consumers):

    odom   (13) [pos3, quat4(xyzw), v_body3, gyro3]   nav_msgs/Odometry
    imu    (10) [quat4(xyzw), gyro3, acc3]            sensor_msgs/Imu
    dvl    (3)  body velocities                       TwistStamped
    depth  (1)  z                                     PoseWithCovarianceStamped
    gps    (2)  map-frame x, y (or UTM offsets)       converted NavSatFix
    mbes   (3)  base-frame detection xyz (event)      PoseArray
    gt     (6)  pose [xyz, rpy]                       gazebo gt topic

CSV is accepted for single streams: first column = stamp, rest = values
(``load_csv_stream``). ``smarc_navigation_tpu_torch.io.bag_convert``
converts rosbags to this schema on a ROS host. ``log_to_timeline`` returns
a numpy-leaved ``Timeline``; ``Timeline.to(device)`` (or
``ops.timeline.timeline_from_numpy``) puts it on a device.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from ..ops.timeline import Timeline, build_timeline

SCHEMA_VERSION = 1


def save_log(path: str, streams: Dict[str, dict], meta: Optional[dict] = None) -> None:
    """Write stamped streams to the npz log schema."""
    arrays = {}
    for name, s in streams.items():
        stamps = np.asarray(s["stamps"], np.float64)
        values = np.atleast_2d(np.asarray(s["values"], np.float64))
        if values.shape[0] != len(stamps):
            if values.shape[1] == len(stamps):  # column-major input
                values = values.T
            else:
                raise ValueError(f"stream {name!r}: stamps/values mismatch")
        arrays[f"{name}/stamps"] = stamps
        arrays[f"{name}/values"] = values
        if "burst" in s and s["burst"] is not None:
            arrays[f"{name}/burst"] = np.asarray(s["burst"], np.int64)
    arrays["__meta__"] = np.asarray(
        json.dumps({"schema_version": SCHEMA_VERSION, **(meta or {})})
    )
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **arrays)


def load_log(path: str) -> Tuple[Dict[str, dict], dict]:
    """Read an npz log -> ({name: {stamps, values[, burst]}}, meta)."""
    with np.load(path, allow_pickle=False) as z:
        meta = {}
        streams: Dict[str, dict] = {}
        for key in z.files:
            if key == "__meta__":
                meta = json.loads(str(z[key]))
                continue
            name, _, field = key.rpartition("/")
            if not name:
                raise ValueError(f"malformed log key {key!r} (want name/field)")
            streams.setdefault(name, {})[field] = z[key]
    for name, s in streams.items():
        if "stamps" not in s or "values" not in s:
            raise ValueError(f"stream {name!r} missing stamps/values")
    return streams, meta


def load_csv_stream(path: str, delimiter: str = ",") -> dict:
    """Stamped CSV (first column = seconds, rest = payload) -> one stream."""
    raw = np.loadtxt(path, delimiter=delimiter, ndmin=2, dtype=np.float64)
    return {"stamps": raw[:, 0], "values": raw[:, 1:]}


def log_to_timeline(
    streams: Dict[str, dict],
    freq_hz: float,
    channels: Optional[Tuple[str, ...]] = None,
    windows: Optional[Dict[str, int]] = None,
    events: Optional[Dict[str, int]] = None,   # name -> max_per_tick
    t0: Optional[float] = None,
    t1: Optional[float] = None,
    stats: Optional[dict] = None,
) -> Timeline:
    """Bin recorded streams onto a tick grid.

    Streams carrying a ``burst`` field are event channels (pass their
    ``max_per_tick`` via ``events``); everything else defaults to
    latest-value channels unless listed in ``windows``. Stamps are
    normalized so the grid starts at the earliest requested stream (the
    reference nodes likewise key everything off message stamps).
    """
    windows = windows or {}
    events = dict(events or {})
    if channels is None:
        channels = tuple(
            n for n in streams
            if n not in windows and "burst" not in streams[n] and n not in events
        )
    for n in streams:
        if "burst" in streams[n] and n not in events:
            raise ValueError(f"event stream {n!r} needs max_per_tick via events=")

    used = list(channels) + list(windows) + list(events)
    missing = [n for n in used if n not in streams]
    if missing:
        raise KeyError(f"streams not in log: {missing}; have {sorted(streams)}")

    starts = [streams[n]["stamps"][0] for n in used if len(streams[n]["stamps"])]
    ends = [streams[n]["stamps"][-1] for n in used if len(streams[n]["stamps"])]
    if not starts:
        raise ValueError("no stamped data in any requested stream")
    base = min(starts)
    t0 = 0.0 if t0 is None else t0
    t1 = (max(ends) - base) if t1 is None else t1

    def rel(n):
        return np.asarray(streams[n]["stamps"], np.float64) - base

    return build_timeline(
        t0=t0,
        t1=t1,
        freq_hz=freq_hz,
        channels={n: (rel(n), streams[n]["values"]) for n in channels},
        windows={n: (rel(n), streams[n]["values"], w) for n, w in windows.items()},
        events={
            n: (
                rel(n),
                streams[n]["values"],
                streams[n].get("burst", np.arange(len(streams[n]["stamps"]))),
                k,
            )
            for n, k in events.items()
        },
        stats=stats,
    )


def mission_to_log(mission, path: Optional[str] = None) -> Dict[str, dict]:
    """Serialize a simulated Mission's raw streams into the log schema
    (exercises the exact path recorded missions replay through — and is
    the fixture generator for loader tests)."""
    streams: Dict[str, dict] = {}
    for name, s in mission.streams.items():
        entry = {"stamps": s["stamps"], "values": s["values"]}
        if "burst" in s:
            entry["burst"] = s["burst"]
        streams[name] = entry
    # ground truth as its own stream (the gazebo gt topic of the reference)
    gt = mission.gt_at(mission.t)
    streams["gt"] = {"stamps": mission.t, "values": gt}
    if path is not None:
        save_log(path, streams, meta={"source": "io.sim", "seed": mission.spec.seed})
    return streams
