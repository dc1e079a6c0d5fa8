"""Checksums of generated traffic: sha256 over every array of a timeline
dict or a log's streams, in sorted key order, with dtype and shape. The
recorded values (``checksums.json``) were taken from the port's own
generators (``io/workloads.slam_mission_timeline``, ``io/sim`` with
``io/logs.mission_to_log`` as ``data/make_sample_log.py`` drives it, and
``io/logs.log_to_timeline``) when this frozen copy was made;
``navbench/tests/test_traffic.py`` holds the copy to them."""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "checksums.json")

# (what, seed) pairs recorded; the configuration and mixes are the cells'
CASES = (("slam_mission", 0), ("slam_mission", 2**31 + 5), ("lolo_log", 42), ("lolo_log", 7),
         ("lolo_timeline", 42))


def digest(tree) -> str:
    h = hashlib.sha256()

    def walk(x, path):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], path + "/" + k)
        elif isinstance(x, (float, int)):
            h.update(f"{path}={x!r};".encode())
        else:
            a = np.ascontiguousarray(x)
            h.update(f"{path}:{a.dtype.str}:{a.shape};".encode())
            h.update(a.tobytes())

    walk(tree, "")
    return h.hexdigest()


def load() -> dict:
    with open(FILE) as f:
        return json.load(f)
