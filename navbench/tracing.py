"""The traced sub-window of a ``--trace 1`` run: ``torch.profiler`` over the
first few units (replays or ticks) of the window, read back from its
Chrome trace into a ``Trace`` that the per-layer readers
(``navbench/layer_metrics/<metric>.py``) take their numbers from.

Device events are kernels, copies and fills; the traced window is the
host span of a ``navbench.window`` annotation around the traced units.
An idle stretch of the device inside it is named by the innermost host
event running at its middle (what the host was doing)."""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "python_function")
WINDOW = "navbench.window"


def names(key: str, name: str) -> bool:
    """Whether a kernel name is the function ``name`` (a whole identifier)."""
    return re.search(rf"(?<![A-Za-z0-9_]){name}(?![A-Za-z0-9_])", key) is not None


class Trace:
    """Device events (name, start µs, duration µs) inside the traced window,
    host events, the window's span, and ``units``: the ticks traced."""

    def __init__(self, events: list, units: int):
        win = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError("the trace holds no navbench.window span")
        self.t0 = float(win[0]["ts"])
        self.t1 = self.t0 + float(win[0]["dur"])
        self.units = units

        def inside(e):
            return "ts" in e and "dur" in e and self.t0 <= float(e["ts"]) <= self.t1

        self.device = sorted(((e["name"], float(e["ts"]), float(e["dur"])) for e in events
                              if e.get("cat") in DEVICE_CATS and inside(e)), key=lambda x: x[1])
        self.n_kernels = sum(1 for e in events if e.get("cat") == "kernel" and inside(e))
        self.host = sorted(((e["name"], float(e["ts"]), float(e["dur"])) for e in events
                            if e.get("cat") in HOST_CATS and inside(e)), key=lambda x: x[1])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self) -> list:
        """The union of device-busy intervals, clipped to the window (µs)."""
        out = []
        for _, s, d in self.device:
            s, e = max(s, self.t0), min(s + d, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def device_s(self, name: str = None) -> tuple:
        """(summed device seconds, count) of every device event, or of the
        kernels whose name is the function ``name``."""
        sel = [d for _, _, d in self.device] if name is None else \
            [d for n, _, d in self.device if names(n, name)]
        return sum(sel) * 1e-6, len(sel)

    def top_ops(self, k: int = 10) -> list:
        tot = defaultdict(float)
        for n, _, d in self.device:
            tot[n] += d * 1e-6
        return [[_short(n), s] for n, s in sorted(tot.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """Idle device seconds inside the window, summed by the innermost
        host event at each gap's middle."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        starts = [h[1] for h in self.host]
        tot = defaultdict(float)
        for s, e in zip(edges[0::2], edges[1::2]):
            if e <= s:
                continue
            mid = 0.5 * (s + e)
            name = "host: no traced call"
            # the latest-started host event still running at mid: the
            # innermost of nested calls (looked for among the last 256)
            i = bisect.bisect_right(starts, mid) - 1
            for h in self.host[max(i - 255, 0):i + 1][::-1]:
                if h[1] + h[2] >= mid:
                    name = h[0]
                    break
            tot[name] += (e - s) * 1e-6
        return [[_short(n), s] for n, s in sorted(tot.items(), key=lambda x: -x[1])[:k]]


def _short(name: str) -> str:
    """A kernel's or call's name without its trailing argument list; a name
    over 150 characters keeps its first 70 and last 77."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i].rstrip() or name
                break
    return name if len(name) <= 150 else name[:70] + "..." + name[-77:]


class Tracer:
    """Profiles from ``start()`` to ``stop(units)``; ``trace()`` reads it back
    once the run's window has closed."""

    def __init__(self, device):
        import torch

        self.cuda = torch.device(device).type == "cuda"
        self.prof = None
        self.units = 0
        self._ann = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._ann = record_function(WINDOW)
        self._ann.__enter__()

    def stop(self, units: int, sync):
        sync()
        self._ann.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.units = units

    @property
    def active(self) -> bool:
        return self.prof is not None and self.units == 0

    def trace(self) -> Trace:
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        return Trace(events, self.units)
