"""ctypes loader for the native host runtime (``csrc/smarcnav_native.cc``,
the package's own copy of the reference's ``native/smarcnav_native.cc``).

Builds the shared library with ``g++ -O3 -shared -fPIC`` at first use into
``build/libsmarcnav.so`` and exposes, with the reference's signatures:

* ``jv_assign`` / ``jv_assign_batch`` — exact Jonker-Volgenant assignment,
  the host path of SLAM data association (``ops.assignment.hungarian_host``),
  the same algorithm and tie rule as ``ops.assignment.hungarian``.
* ``latest_index`` / ``bin_events`` — timeline binning of recorded sensor
  logs (the only O(events) Python loop in mission preprocessing).

This is host code, not a kernel. The build is stamped with the source's
sha256 and never trusted on its mtime. Without a compiler ``available()``
is False and the callers take their Python or scipy paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG, "csrc", "smarcnav_native.cc")
_LIB = os.path.join(_PKG, "build", "libsmarcnav.so")
_STAMP = _LIB + ".srchash"  # sha256 of the source the cached library was built from

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _src_hash() -> str:
    with open(_SRC, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _build(src_hash: str) -> bool:
    """Compile into a private file, then move it into place, so that
    processes building at once never load a half-written library."""
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                       check=True, capture_output=True)
        os.replace(tmp, _LIB)
        stamp_tmp = f"{_STAMP}.{os.getpid()}.tmp"
        with open(stamp_tmp, "w") as f:
            f.write(src_hash)
        os.replace(stamp_tmp, _STAMP)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError, OSError):
        return False


def _cached_lib_current(src_hash: str) -> bool:
    """A cached library is trusted only if its recorded source hash matches
    the source in the package — never on mtime (a checkout gives every file
    the same mtime)."""
    try:
        with open(_STAMP) as f:
            return f.read().strip() == src_hash
    except OSError:
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    src_hash = _src_hash()
    if not os.path.exists(_LIB) or not _cached_lib_current(src_hash):
        if not _build(src_hash):
            return None
    lib = ctypes.CDLL(_LIB)
    c_dp = ctypes.POINTER(ctypes.c_double)
    c_ip = ctypes.POINTER(ctypes.c_int)
    c_lp = ctypes.POINTER(ctypes.c_int64)
    c_up = ctypes.POINTER(ctypes.c_uint8)
    lib.jv_assign.argtypes = [c_dp, ctypes.c_int, ctypes.c_int, c_ip]
    lib.jv_assign.restype = ctypes.c_int
    lib.jv_assign_batch.argtypes = [c_dp, ctypes.c_int, ctypes.c_int, ctypes.c_int, c_ip]
    lib.jv_assign_batch.restype = ctypes.c_int
    lib.latest_index.argtypes = [c_dp, ctypes.c_int64, c_dp, ctypes.c_int64, c_lp]
    lib.latest_index.restype = None
    lib.bin_events.argtypes = [
        c_dp, c_dp, c_lp, ctypes.c_int64, ctypes.c_int,
        c_dp, ctypes.c_int64, ctypes.c_int, c_dp, c_up,
    ]
    lib.bin_events.restype = ctypes.c_int64
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def jv_assign(cost: np.ndarray) -> np.ndarray:
    """(R, C) float cost -> (C,) int32 col_to_row (exact minimum)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable (no g++?)")
    cost = np.ascontiguousarray(cost, np.float64)
    R, C = cost.shape
    out = np.empty(C, np.int32)
    rc = lib.jv_assign(_ptr(cost, ctypes.c_double), R, C, _ptr(out, ctypes.c_int))
    if rc != 0:
        raise ValueError(f"jv_assign failed rc={rc} (C<=R required)")
    return out


def jv_assign_batch(costs: np.ndarray) -> np.ndarray:
    """(B, R, C) float costs -> (B, C) int32 col_to_row."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable (no g++?)")
    costs = np.ascontiguousarray(costs, np.float64)
    B, R, C = costs.shape
    out = np.empty((B, C), np.int32)
    rc = lib.jv_assign_batch(_ptr(costs, ctypes.c_double), B, R, C,
                             _ptr(out, ctypes.c_int))
    if rc != 0:
        raise ValueError(f"jv_assign_batch failed rc={rc}")
    return out


def latest_index(stamps: np.ndarray, ticks: np.ndarray) -> np.ndarray:
    """Index of the latest stamp <= each tick, -1 if none (stamps sorted)."""
    lib = _load()
    if lib is None:
        return np.searchsorted(stamps, ticks, side="right") - 1
    stamps = np.ascontiguousarray(stamps, np.float64)
    ticks = np.ascontiguousarray(ticks, np.float64)
    out = np.empty(len(ticks), np.int64)
    lib.latest_index(_ptr(stamps, ctypes.c_double), len(stamps),
                     _ptr(ticks, ctypes.c_double), len(ticks),
                     _ptr(out, ctypes.c_int64))
    return out


def bin_events(
    stamps: np.ndarray, values: np.ndarray, burst: np.ndarray,
    ticks: np.ndarray, max_per_tick: int,
):
    """-> (values (T,K,D) f64, mask (T,K) bool, dropped count), or None
    without the library (the caller then takes the Python binner)."""
    lib = _load()
    if lib is None:
        return None
    stamps = np.ascontiguousarray(stamps, np.float64)
    values = np.ascontiguousarray(values, np.float64)
    burst = np.ascontiguousarray(burst, np.int64)
    ticks = np.ascontiguousarray(ticks, np.float64)
    T, K, D = len(ticks), max_per_tick, values.shape[1] if values.size else 3
    out_v = np.zeros((T, K, D), np.float64)
    out_m = np.zeros((T, K), np.uint8)
    dropped = lib.bin_events(
        _ptr(stamps, ctypes.c_double), _ptr(values, ctypes.c_double),
        _ptr(burst, ctypes.c_int64), len(stamps), D,
        _ptr(ticks, ctypes.c_double), T, K,
        _ptr(out_v, ctypes.c_double), _ptr(out_m, ctypes.c_uint8),
    )
    return out_v, out_m.astype(bool), int(dropped)
