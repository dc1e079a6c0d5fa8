"""Spans of the port's host path, recorded into ``torch.profiler``.

``span(name)`` is a context manager: while a profiler records (an
operator's ``io.replay.profile_replay``, a benchmark's traced window) it
records ``name`` as a host op; otherwise it is one shared no-op, so a span
costs one check of the profiler's state. A span lands in the profiler's
own buffer beside the ops, launches and device events it encloses and is
exported with them (``cat`` ``cpu_op`` in the Chrome trace, a row of
``key_averages()``): one clock, and a span's parent is the span that
encloses it on the same thread. It is recorded as an op, as the compiled
kernels of ``torch._inductor`` are (``_RecordFunctionFast``), and not as a
``record_function`` annotation: a reader of the trace's host ops finds it,
and while the profiler records it costs a third or less of an annotation.
There is no switch of its own.

Spans, each in the function named:

- ``slam.step``: ``models/ekf_slam.step``, one online tick;
  inside it ``slam.predict`` (the motion predict) and, per sensor pass
  with detections (``data_associate_update``), ``slam.da_stage`` (the
  correspondence and cost table), ``slam.jv`` (the table to the host, the
  assignment, the result back) and ``slam.commit`` (landmark adds and the
  sequential update).
- ``slam.fleet.stage``: ``models/ekf_slam.run_fleet`` on one device with
  the full covariance, the input staging (``_loop_inputs``).
- ``graphs.copy_in``, ``graphs.replay``, ``graphs.clone_out``:
  ``utils/graphs.run`` on a cached graph, the copies into the static
  inputs, the graph's launch, the output clones.

Nothing inside a captured graph body records a span: it would record once,
at capture, and never on a replay.
"""

from __future__ import annotations

import contextlib

import torch

# A private API, checked on torch 2.13 (CPU) and 2.11 (CUDA 12.8). Where a
# torch lacks it the spans become ``record_function`` annotations, which
# the profiler still exports (``user_annotation``) but a reader of the
# host ops does not find.
_record = getattr(torch._C._profiler, "_RecordFunctionFast", torch.profiler.record_function)

_OFF = contextlib.nullcontext()


def span(name: str):
    """``name`` recorded as a host op while a profiler records, else a no-op."""
    if torch.autograd._profiler_enabled():
        return _record(name)
    return _OFF
