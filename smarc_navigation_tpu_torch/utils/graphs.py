"""Cached CUDA graphs of the port's tick loops: the counterpart of the
reference's jitted ``lax.scan`` (trace once per shape, run as one device
program, reuse the compiled program; ``ekf_slam.py:1271-1321`` caches it per
shape key).

``run(key, body, inputs)`` returns ``body(inputs)``. ``inputs`` is a flat
dict of tensors on one CUDA device, everything the body reads; the body's
result is a pytree (tuple, dict, NamedTuple) of tensors.

- The first call with a key runs ``body`` eagerly on a side stream over
  static copies of ``inputs`` (the warm-up PyTorch's graph docs ask for: it
  loads every kernel and library handle, and its result is this call's
  result), then captures ``body`` once into a ``torch.cuda.CUDAGraph`` on
  the graph's private memory pool. A capture or instantiate error raises;
  nothing re-runs the eager loop in its place.
- Every later call with the key copies its inputs into the entry's static
  buffers, replays the graph once and returns clones of the static outputs,
  so no call aliases or overwrites another's results. Under a profiler the
  three record the spans ``graphs.copy_in``, ``graphs.replay`` and
  ``graphs.clone_out`` (``utils/trace``).

The cache key is ``key`` plus the name, shape, dtype and device of every
input. ``key`` must hold everything else the capture bakes in: the
configuration, the sensor names, a kernel's wiring or schedule. The body
must be capture-safe: no host sync (``.item()``, ``bool(t)``, ``nonzero``)
and no tensor built from host data inside it.

Launch counts: the kernel wrappers count while the body runs, so the
warm-up counts its launches as any eager call does. The capture launches
nothing, so what the wrappers counted during it is taken back and recorded,
and each replay adds it again. A call thus counts the same launches whether
it captured or replayed.

The cache holds at most ``MAX_ENTRIES`` graphs (least recently used goes
first); each holds a memory pool (Σ alone is 20 MB at L=64, B=128 and
77 MB at L=256, B=32). ``clear()`` drops them all.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
from torch.utils._pytree import tree_leaves, tree_map

from . import trace

MAX_ENTRIES = 8

_cache: OrderedDict = OrderedDict()
captures = 0   # graphs captured since import (a call that hit the cache adds none)


class _Entry:
    __slots__ = ("graph", "inputs", "outputs", "launches")

    def __init__(self, graph, inputs, outputs, launches):
        self.graph, self.inputs, self.outputs, self.launches = graph, inputs, outputs, launches


def clear() -> None:
    """Drop every cached graph (and with it its memory pool)."""
    _cache.clear()


def size() -> int:
    """The number of cached graphs."""
    return len(_cache)


def _counted() -> tuple:
    """The package's kernel wrappers, each with its launch count."""
    from ..ops import ekf15_kernels, loc_kernels, pf_kernels, slam_da_kernels, slam_kernels

    return (slam_da_kernels.da_lanes, slam_da_kernels.hungarian_lanes,
            slam_kernels.sequential_update_fleet, slam_kernels.sequential_update,
            slam_kernels.symmetric_downdate, slam_kernels.sequential_update_marginal_fleet,
            pf_kernels.predict_call_multi, pf_kernels.predict_call,
            pf_kernels.expand_gather_call, pf_kernels.jitter_moments_call,
            loc_kernels.fleet_tick, ekf15_kernels.fleet15_tick)


def _signature(inputs: dict) -> tuple:
    return tuple((k, tuple(v.shape), v.dtype, str(v.device)) for k, v in sorted(inputs.items()))


def run(key, body, inputs: dict):
    """``body(inputs)`` through the graph cached for ``key`` and the inputs'
    shapes (captured on the first call)."""
    dev = next(iter(inputs.values())).device
    if dev.type != "cuda":
        raise ValueError(f"graphs.run takes CUDA tensors, not {dev}")
    full_key = (key, _signature(inputs))
    with torch.cuda.device(dev):
        entry = _cache.get(full_key)
        if entry is None:
            return _capture(full_key, body, inputs)
        _cache.move_to_end(full_key)
        with trace.span("graphs.copy_in"):
            for k, v in inputs.items():
                entry.inputs[k].copy_(v)
        with trace.span("graphs.replay"):
            entry.graph.replay()
        for f, n in entry.launches:
            f.launches += n
        with trace.span("graphs.clone_out"):
            return tree_map(torch.clone, entry.outputs)


def _capture(full_key, body, inputs: dict):
    global captures
    static = {k: v.clone(memory_format=torch.contiguous_format) for k, v in inputs.items()}
    cur = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        result = body(static)
    cur.wait_stream(side)
    for t in tree_leaves(result):
        t.record_stream(cur)

    counters = _counted()
    before = [f.launches for f in counters]
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            outputs = body(static)
    finally:
        captured = [(f, f.launches - n) for f, n in zip(counters, before)]
        for f, n in zip(counters, before):
            f.launches = n
    _cache[full_key] = _Entry(graph, static, outputs, [(f, n) for f, n in captured if n])
    captures += 1
    while len(_cache) > MAX_ENTRIES:
        _cache.popitem(last=False)
    return result
