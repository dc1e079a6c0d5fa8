"""What decides ``correct``: each number that the cell's driver reports
(its ``judge``) against the limit of the same name in the cell's workload
file. The numbers are the driver's (``compare/slam.py`` for the SLAM
drivers); a number the driver does not report reads as failed."""

from __future__ import annotations

import math


def worst(readings: list) -> dict:
    """The largest reading of each number over several comparisons."""
    return {k: max(r[k] for r in readings if k in r) for k in {k for r in readings for k in r}}


def _ok(v, limit) -> bool:
    return v is not None and math.isfinite(v) and v <= limit


def verdict(nums: dict, limits: dict) -> bool:
    return all(_ok(nums.get(k), lim) for k, lim in limits.items())


def report(nums: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} in the workload file's order, for the
    result line."""
    return {k: {"value": nums.get(k), "limit": lim} for k, lim in limits.items()}
