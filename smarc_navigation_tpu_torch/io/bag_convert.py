"""rosbag -> npz log converter (host-only tool).

Bridges the reference's recorded-bag workflow
(``auv_ekf_localization/rosbags/rosbag_handler.py:7-20`` reads bags
message-by-message) to the ``io.logs`` npz schema. Runs on a ROS host
where ``rosbag`` is importable; this repo's image has no ROS, so the
import is deferred and the message flatteners below are pure functions
over duck-typed messages (unit-tested with stubs).

Usage (on a ROS host):

    python -m smarc_navigation_tpu_torch.io.bag_convert mission.bag mission.npz \
        --odom /lolo_auv/ekf_odom --gt /lolo_auv/gt_in_odom \
        --imu /sam/core/sbg_imu --dvl /sam/dr/dvl_twist \
        --depth /sam/dr/pressure_depth --detections /lolo_auv/rocks

Every topic maps to one stream named by its role; payload layouts match
the ``io.logs`` conventions. Port of
``smarc_navigation_tpu/io/bag_convert.py`` (host numpy, unchanged).
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np


# --------------------------------------------------------------------------
# pure message flatteners (duck-typed: any object with the ROS msg fields)
# --------------------------------------------------------------------------

def flatten_odometry(msg) -> List[float]:
    """nav_msgs/Odometry -> 13 [pos3, quat4(xyzw), v_body3, gyro3]."""
    p = msg.pose.pose.position
    q = msg.pose.pose.orientation
    v = msg.twist.twist.linear
    w = msg.twist.twist.angular
    return [p.x, p.y, p.z, q.x, q.y, q.z, q.w, v.x, v.y, v.z, w.x, w.y, w.z]


def flatten_imu(msg) -> List[float]:
    """sensor_msgs/Imu -> 10 [quat4(xyzw), gyro3, acc3]."""
    q = msg.orientation
    w = msg.angular_velocity
    a = msg.linear_acceleration
    return [q.x, q.y, q.z, q.w, w.x, w.y, w.z, a.x, a.y, a.z]


def flatten_twist(msg) -> List[float]:
    """geometry_msgs/TwistStamped (or TwistWithCovarianceStamped) -> 6."""
    tw = msg.twist
    tw = getattr(tw, "twist", tw)  # unwrap WithCovariance
    return [tw.linear.x, tw.linear.y, tw.linear.z,
            tw.angular.x, tw.angular.y, tw.angular.z]


def flatten_pose_z(msg) -> List[float]:
    """PoseWithCovarianceStamped (press_to_depth output) -> 1 [z]."""
    return [msg.pose.pose.position.z]


def flatten_navsat(msg) -> List[float]:
    """sensor_msgs/NavSatFix -> 3 [lat_deg, lon_deg, status]."""
    return [msg.latitude, msg.longitude, float(msg.status.status)]


def flatten_pose_array(msg) -> List[List[float]]:
    """geometry_msgs/PoseArray (landmark detections) -> list of xyz rows;
    one call = one burst (the reference consumes one PoseArray per tick,
    ``ekf_slam.cpp:323-331``)."""
    return [[p.position.x, p.position.y, p.position.z] for p in msg.poses]


def stamp_seconds(msg, bag_time=None) -> float:
    """Header stamp in seconds; falls back to bag receive time."""
    header = getattr(msg, "header", None)
    if header is not None:
        s = header.stamp
        sec = getattr(s, "secs", None)
        if sec is None:  # ROS2-style
            sec, nsec = s.sec, s.nanosec
        else:
            nsec = s.nsecs
        if sec or nsec:
            return float(sec) + float(nsec) * 1e-9
    if bag_time is not None:
        return float(bag_time.to_sec())
    raise ValueError("message has no usable stamp")


_FLATTENERS = {
    "odom": flatten_odometry,
    "gt": flatten_odometry,
    "imu": flatten_imu,
    "dvl": flatten_twist,
    "depth": flatten_pose_z,
    "gps": flatten_navsat,
}


def accumulate(streams: Dict[str, dict], role: str, stamp: float, msg) -> None:
    """Route one message into the stream dict (list-of-rows form)."""
    if role == "detections":
        rows = flatten_pose_array(msg)
        s = streams.setdefault(
            "mbes", {"stamps": [], "values": [], "burst": []}
        )
        burst_id = s["burst"][-1] + 1 if s["burst"] else 0
        for r in rows:
            s["stamps"].append(stamp)
            s["values"].append(r)
            s["burst"].append(burst_id)
        return
    flat = _FLATTENERS[role](msg)
    s = streams.setdefault(role, {"stamps": [], "values": []})
    s["stamps"].append(stamp)
    s["values"].append(flat)


def finalize(streams: Dict[str, dict]) -> Dict[str, dict]:
    out = {}
    for name, s in streams.items():
        entry = {
            "stamps": np.asarray(s["stamps"], np.float64),
            "values": np.asarray(s["values"], np.float64),
        }
        if "burst" in s:
            entry["burst"] = np.asarray(s["burst"], np.int64)
        out[name] = entry
    return out


def convert(bag_path: str, out_path: str, topic_roles: Dict[str, str]) -> dict:
    """Read a rosbag and write the npz log. ``topic_roles``: topic -> role
    (odom/gt/imu/dvl/depth/gps/detections). Returns per-stream counts."""
    try:
        import rosbag  # noqa: F401 — only available on a ROS host
    except ImportError as e:
        raise RuntimeError(
            "rosbag is not installed — run this converter on a ROS host "
            "(it is intentionally not a dependency of this package)"
        ) from e
    from .logs import save_log

    streams: Dict[str, dict] = {}
    with rosbag.Bag(bag_path, "r") as bag:
        for topic, msg, t in bag.read_messages(topics=list(topic_roles)):
            role = topic_roles[topic]
            accumulate(streams, role, stamp_seconds(msg, t), msg)
    final = finalize(streams)
    save_log(out_path, final, meta={"source_bag": bag_path, "topics": topic_roles})
    return {name: len(s["stamps"]) for name, s in final.items()}


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser(prog="smarc_navigation_tpu_torch.io.bag_convert")
    p.add_argument("bag")
    p.add_argument("out")
    for role in ("odom", "gt", "imu", "dvl", "depth", "gps", "detections"):
        p.add_argument(f"--{role}", help=f"topic to record as the {role} stream")
    args = p.parse_args(argv)
    roles = {
        getattr(args, role): role
        for role in ("odom", "gt", "imu", "dvl", "depth", "gps", "detections")
        if getattr(args, role)
    }
    if not roles:
        p.error("map at least one topic (e.g. --odom /lolo_auv/ekf_odom)")
    counts = convert(args.bag, args.out, roles)
    print(f"wrote {args.out}: " + ", ".join(f"{k}={v}" for k, v in counts.items()))


if __name__ == "__main__":
    main()
