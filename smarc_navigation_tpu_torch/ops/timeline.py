"""Sensor timeline: numpy builders plus torch containers.

The builders (``make_channel``, ``make_event_channel``, ``make_ticks``,
``build_timeline``) are the reference's host-side numpy code
(``smarc_navigation_tpu/ops/timeline.py``) kept bit-for-bit; they return
numpy-leaved containers. ``Timeline.to(device)`` (or
``timeline_from_numpy``) turns every leaf into a tensor on that device with
one host-to-device copy per leaf.

The whole mission is a struct-of-arrays on a fixed tick grid: for every
sensor channel the per-tick snapshot of "latest message at or before this
tick" plus freshness metadata, and for event sensors the padded burst of
detections assigned to each tick. Replays fold over the tick axis.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch


def _to_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


class _Leaves:
    """Shared helpers of the containers: map a function over every array
    leaf (static fields are copied as they are)."""

    _static: tuple = ()

    def map(self, fn: Callable[[Any], Any]):
        kw = {}
        for f in dataclasses.fields(self):
            x = getattr(self, f.name)
            if f.name in self._static:
                kw[f.name] = x
            elif isinstance(x, dict):
                kw[f.name] = {k: v.map(fn) for k, v in x.items()}
            else:
                kw[f.name] = fn(x)
        return type(self)(**kw)

    def leaves(self) -> list:
        """Array leaves in a fixed order (field order, dict insertion order)."""
        out = []

        def collect(x):
            out.append(x)
            return x

        self.map(collect)
        return out

    def to(self, device):
        """Every leaf as a tensor on ``device``."""
        return self.map(lambda x: _to_tensor(x, device))


@dataclasses.dataclass
class Channel(_Leaves):
    """Per-tick snapshot of one sensor channel.

    value (T, D) latest payload at or before each tick (zeros if none yet);
    stamp (T,) its stamp (-inf if none); valid (T,) any message so far;
    fresh (T,) a new message since the previous tick; age (T,) staleness."""

    value: Any
    stamp: Any
    valid: Any
    fresh: Any
    age: Any


@dataclasses.dataclass
class WindowChannel(_Leaves):
    """Like Channel, carrying the last W stamped messages per tick."""

    value: Any   # (T, W, D)
    stamp: Any   # (T, W)
    count: Any   # (T,)


@dataclasses.dataclass
class EventChannel(_Leaves):
    """Sparse per-tick event sets: value (T, K, D) padded detections
    assigned to each tick, mask (T, K) which slots are real."""

    value: Any
    mask: Any


@dataclasses.dataclass
class Timeline(_Leaves):
    """A full mission timeline on a fixed tick grid (leading batch dim B
    after ``parallel.fleet.batch_timelines``)."""

    ticks: Any
    dt: float
    channels: Dict[str, Channel] = dataclasses.field(default_factory=dict)
    windows: Dict[str, WindowChannel] = dataclasses.field(default_factory=dict)
    events: Dict[str, EventChannel] = dataclasses.field(default_factory=dict)

    _static = ("dt",)

    @property
    def num_ticks(self) -> int:
        return self.ticks.shape[-1]

    def slice_tick(self, k):
        """Per-tick view of a single-mission timeline."""
        return self.map(lambda x: x[k])


def timeline_from_numpy(tl: Timeline, device) -> Timeline:
    """A built (numpy-leaved) timeline as tensors on ``device``."""
    return tl.to(device)


def _latest_index(stamps: np.ndarray, ticks: np.ndarray) -> np.ndarray:
    """Index of latest stamp <= tick, -1 if none."""
    return np.searchsorted(stamps, ticks, side="right") - 1


def make_channel(
    ticks: np.ndarray,
    stamps: np.ndarray,
    values: np.ndarray,
    dtype=np.float32,
) -> Channel:
    """Build a latest-value Channel from raw stamped messages (host side)."""
    stamps = np.asarray(stamps, dtype=np.float64)
    values = np.asarray(values, dtype=dtype)
    if values.ndim == 1:
        values = values[:, None]
    if values.shape[0] != stamps.shape[0]:
        raise ValueError("values/stamps length mismatch")
    if len(stamps) == 0:
        # channel with no messages: permanently invalid (sensor dropout)
        T, D = len(ticks), max(values.shape[1] if values.ndim == 2 else 1, 1)
        return Channel(
            value=np.zeros((T, D), dtype),
            stamp=np.full((T,), -np.inf, dtype),
            valid=np.zeros((T,), bool),
            fresh=np.zeros((T,), bool),
            age=np.full((T,), np.inf, dtype),
        )
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
    return Channel(
        value=np.ascontiguousarray(value),
        stamp=stamp.astype(dtype),
        valid=valid,
        fresh=fresh,
        age=age.astype(dtype),
    )


def make_window_channel(
    ticks: np.ndarray,
    stamps: np.ndarray,
    values: np.ndarray,
    window: int,
    dtype=np.float32,
) -> WindowChannel:
    stamps = np.asarray(stamps, dtype=np.float64)
    values = np.atleast_2d(np.asarray(values, dtype=dtype))
    order = np.argsort(stamps, kind="stable")
    stamps, values = stamps[order], values[order]

    idx = _latest_index(stamps, ticks)  # (T,)
    offs = np.arange(-(window - 1), 1)  # oldest..newest
    widx = idx[:, None] + offs[None, :]
    count = np.clip(idx + 1, 0, window)
    widx = np.clip(widx, 0, max(len(stamps) - 1, 0))
    if len(stamps) == 0:
        raise ValueError("window channel needs at least one message")
    return WindowChannel(
        value=np.ascontiguousarray(values[widx]),
        stamp=stamps[widx].astype(dtype),
        count=count.astype(np.int32),
    )


def make_event_channel(
    ticks: np.ndarray,
    stamps: np.ndarray,
    values: np.ndarray,  # (M, D) one row per detection
    burst_id: np.ndarray,  # (M,) groups detections into bursts
    max_per_tick: int,
    dtype=np.float32,
    stats: Optional[dict] = None,
) -> EventChannel:
    """Assign each detection burst to the first tick at/after its stamp.

    Queue semantics: detections wait and are consumed by the next filter
    tick. Bursts landing on the same tick merge up to max_per_tick; extra
    detections are dropped, counted in ``stats["dropped"]`` and warned
    about. Binned by the native library (``native.bin_events``) when it
    builds, by the Python loop below otherwise: the same loop, the same
    bits."""
    T = len(ticks)
    D = values.shape[1] if values.size else 3
    dropped = 0
    if len(stamps):
        order = np.argsort(stamps, kind="stable")
        stamps, values, burst_id = stamps[order], values[order], np.asarray(burst_id)[order]
        from .. import native

        binned = native.bin_events(stamps, values, burst_id, ticks, max_per_tick)
        if binned is not None:
            out_v, out_m, dropped = binned
            _record_dropped(dropped, stats)
            return EventChannel(value=out_v.astype(dtype), mask=np.ascontiguousarray(out_m))
    out = np.zeros((T, max_per_tick, D), dtype=dtype)
    mask = np.zeros((T, max_per_tick), dtype=bool)
    if len(stamps):
        tick_of = np.searchsorted(ticks, stamps, side="left")
        fill = np.zeros(T, dtype=np.int64)
        for m in range(len(stamps)):
            t = tick_of[m]
            if t >= T:  # event after mission end — lost, like saturation
                dropped += 1
                continue
            k = fill[t]
            if k < max_per_tick:
                out[t, k] = values[m]
                mask[t, k] = True
                fill[t] += 1
            else:
                dropped += 1
    _record_dropped(dropped, stats)
    return EventChannel(value=out, mask=mask)


def _record_dropped(dropped: int, stats: Optional[dict]) -> None:
    if stats is not None:
        stats["dropped"] = stats.get("dropped", 0) + int(dropped)
    if dropped:
        warnings.warn(
            f"event channel saturated: {int(dropped)} detections beyond "
            "max_per_tick were dropped (raise max_per_tick or the tick rate)",
            stacklevel=3,
        )


def make_ticks(t0: float, t1: float, freq_hz: float) -> np.ndarray:
    n = int(np.floor((t1 - t0) * freq_hz)) + 1
    return (t0 + np.arange(n) / freq_hz).astype(np.float64)


def build_timeline(
    t0: float,
    t1: float,
    freq_hz: float,
    channels: Optional[Dict[str, tuple]] = None,   # name -> (stamps, values)
    windows: Optional[Dict[str, tuple]] = None,    # name -> (stamps, values, W)
    events: Optional[Dict[str, tuple]] = None,     # name -> (stamps, values, burst_id, K)
    dtype=np.float32,
    stats: Optional[dict] = None,   # out-param: per-event-channel build stats
) -> Timeline:
    ticks = make_ticks(t0, t1, freq_hz)
    chan = {
        name: make_channel(ticks, s, v, dtype) for name, (s, v) in (channels or {}).items()
    }
    win = {
        name: make_window_channel(ticks, s, v, w, dtype)
        for name, (s, v, w) in (windows or {}).items()
    }
    ev = {}
    for name, (s, v, b, k) in (events or {}).items():
        ch_stats: dict = {}
        ev[name] = make_event_channel(ticks, s, v, b, k, dtype, stats=ch_stats)
        if stats is not None:
            stats[name] = ch_stats
    return Timeline(
        ticks=ticks.astype(dtype),
        dt=float(1.0 / freq_hz),
        channels=chan,
        windows=win,
        events=ev,
    )
