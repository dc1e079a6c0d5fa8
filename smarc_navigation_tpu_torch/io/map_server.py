"""Landmark map loading / serving.

Replaces the reference's MapServer ROS service
(``auv_ekf_localization/scripts/map_provider_node.py:24-55``): parse a
Gazebo-world YAML of model poses, keep entries below a depth threshold,
hand the result to the localization filter as its known map. Also covers
the EKF node's direct Gazebo world scraping (``ekf_localization.cpp:163-207``)
via ``save_map``/``load_map`` npz round-trips for simulated worlds.
Port of ``smarc_navigation_tpu/io/map_server.py`` (host numpy; PyYAML is
imported only by ``parse_map_yaml``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def parse_map_yaml(path: str, rocks_depth: float = -90.0) -> np.ndarray:
    """YAML of {world: [{position: {x,y,z}}, ...]} -> (N, 3) landmarks with
    z below ``rocks_depth`` (the reference's depth filter)."""
    import yaml

    with open(path) as stream:
        data = yaml.safe_load(stream)
    first_group = next(iter(data.values()))
    pts = [
        [m["position"]["x"], m["position"]["y"], m["position"]["z"]]
        for m in first_group
        if m["position"]["z"] < rocks_depth
    ]
    return np.asarray(pts, np.float64).reshape(-1, 3)


def save_map(path: str, landmarks: np.ndarray, ids: Optional[np.ndarray] = None) -> None:
    landmarks = np.asarray(landmarks)
    if ids is None:
        ids = np.arange(len(landmarks))
    np.savez(path, landmarks=landmarks, ids=np.asarray(ids))


def load_map(path: str):
    data = np.load(path)
    return data["landmarks"], data["ids"]


def filter_by_depth(landmarks: np.ndarray, rocks_depth: float) -> np.ndarray:
    landmarks = np.asarray(landmarks)
    return landmarks[landmarks[:, 2] < rocks_depth]
