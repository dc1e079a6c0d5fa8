"""Frozen copy of the port's host-side timeline builders (``ops/timeline.py``:
``make_channel``, ``make_event_channel``, ``make_ticks``,
``build_timeline``), numpy only. A timeline here is a plain dict:

    {"ticks": (T,), "dt": float,
     "channels": {name: {"value", "stamp", "valid", "fresh", "age"}},
     "events": {name: {"value": (T, K, D), "mask": (T, K)}}}

The event binning is the port's Python loop (the port may bin with its
native library instead: the same loop, the same bits). Window channels are
left out: no cell reads one.
"""

from __future__ import annotations

import numpy as np


def _latest_index(stamps: np.ndarray, ticks: np.ndarray) -> np.ndarray:
    """Index of latest stamp <= tick, -1 if none."""
    return np.searchsorted(stamps, ticks, side="right") - 1


def make_channel(ticks, stamps, values, dtype=np.float32) -> dict:
    """Latest-value channel from raw stamped messages."""
    stamps = np.asarray(stamps, dtype=np.float64)
    values = np.asarray(values, dtype=dtype)
    if values.ndim == 1:
        values = values[:, None]
    if values.shape[0] != stamps.shape[0]:
        raise ValueError("values/stamps length mismatch")
    if len(stamps) == 0:
        T, D = len(ticks), max(values.shape[1] if values.ndim == 2 else 1, 1)
        return dict(value=np.zeros((T, D), dtype), stamp=np.full((T,), -np.inf, dtype),
                    valid=np.zeros((T,), bool), fresh=np.zeros((T,), bool),
                    age=np.full((T,), np.inf, dtype))
    order = np.argsort(stamps, kind="stable")
    stamps, values = stamps[order], values[order]
    idx = _latest_index(stamps, ticks)
    valid = idx >= 0
    safe = np.maximum(idx, 0)
    value = values[safe]
    value[~valid] = 0.0
    stamp = np.where(valid, stamps[safe], -np.inf)
    prev_idx = np.concatenate([[-1], idx[:-1]])
    fresh = valid & (idx != prev_idx)
    age = np.where(valid, ticks - stamp, np.inf)
    return dict(value=np.ascontiguousarray(value), stamp=stamp.astype(dtype), valid=valid,
                fresh=fresh, age=age.astype(dtype))


def make_event_channel(ticks, stamps, values, burst_id, max_per_tick, dtype=np.float32) -> dict:
    """Assign each detection to the first tick at/after its stamp; bursts
    landing on one tick merge up to ``max_per_tick``, the rest dropped."""
    T = len(ticks)
    D = values.shape[1] if values.size else 3
    out = np.zeros((T, max_per_tick, D), dtype=dtype)
    mask = np.zeros((T, max_per_tick), dtype=bool)
    if len(stamps):
        order = np.argsort(stamps, kind="stable")
        stamps, values = stamps[order], values[order]
        tick_of = np.searchsorted(ticks, stamps, side="left")
        fill = np.zeros(T, dtype=np.int64)
        for m in range(len(stamps)):
            t = tick_of[m]
            if t >= T:
                continue
            k = fill[t]
            if k < max_per_tick:
                out[t, k] = values[m]
                mask[t, k] = True
                fill[t] += 1
    return dict(value=out, mask=mask)


def make_ticks(t0: float, t1: float, freq_hz: float) -> np.ndarray:
    n = int(np.floor((t1 - t0) * freq_hz)) + 1
    return (t0 + np.arange(n) / freq_hz).astype(np.float64)


def build_timeline(t0, t1, freq_hz, channels=None, events=None, dtype=np.float32) -> dict:
    """channels: name -> (stamps, values); events: name -> (stamps, values,
    burst_id, K)."""
    ticks = make_ticks(t0, t1, freq_hz)
    chan = {n: make_channel(ticks, s, v, dtype) for n, (s, v) in (channels or {}).items()}
    ev = {n: make_event_channel(ticks, s, v, b, k, dtype)
          for n, (s, v, b, k) in (events or {}).items()}
    return dict(ticks=ticks.astype(dtype), dt=float(1.0 / freq_hz), channels=chan, events=ev)


def stack(timelines: list) -> dict:
    """B single-mission timelines -> one with a leading mission axis."""
    first = timelines[0]
    return dict(
        ticks=np.stack([t["ticks"] for t in timelines]), dt=first["dt"],
        channels={n: {k: np.stack([t["channels"][n][k] for t in timelines]) for k in c}
                  for n, c in first["channels"].items()},
        events={n: {k: np.stack([t["events"][n][k] for t in timelines]) for k in e}
                for n, e in first["events"].items()})
