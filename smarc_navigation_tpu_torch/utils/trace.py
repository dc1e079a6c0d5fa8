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
  with detections, ``slam.da_stage`` and ``slam.commit``. On CUDA state
  in the kernel mode (``_lanes_step_pass``) ``slam.da_stage`` is K1's
  call (correspondence, cost table and JV) and ``slam.commit`` the slot
  bookkeeping and K2. Elsewhere (``data_associate_update``)
  ``slam.da_stage`` is the correspondence and cost table, ``slam.jv`` the
  assignment (the table to the host and the result back) and
  ``slam.commit`` the landmark adds and the sequential update.
- ``slam.fleet.stage``: ``models/ekf_slam.run_fleet`` on one device with
  the full covariance, the input staging (``_loop_inputs``).
- ``graphs.copy_in``, ``graphs.replay``, ``graphs.clone_out``:
  ``utils/graphs.run`` on a cached graph, the copies into the static
  inputs, the graph's launch, the output clones.
- ``pf.precompute``: ``models/particle_filter.run_fast_segmented``, once
  per call: the initial bank, ``_tick_precompute``'s draws and per-tick
  rows, the update and motion-noise flags read to the host (the path's two
  syncs) and the segment plan.
- ``pf.segment_inputs``: ``models/particle_filter._run_segments`` and
  ``_run_segments_sharded``, once per run: ``_segment_inputs``, the
  per-segment rows gathered from the per-tick ones.
- ``pf.predict``: ``models/particle_filter._run_segments``, each K5 call
  (``predict_call_multi``), one per segment.
- ``pf.update``: ``models/particle_filter._update_resample_fast``, one
  GPS update; inside it ``pf.weights`` (K13's call,
  ``pf_kernels.gps_weights_call``: the log-weights and
  ``normalize_weights_det``'s order), ``pf.counts`` (K14's call behind
  ``resampling.systematic_counts``: the blocked CDF, the counts, their
  running max) and ``pf.gather`` (K7's call, ``expand_gather_call``). On
  the CPU the first two are the plain versions.
- ``pf.finalize``: ``models/particle_filter._run_segments``, once per
  run: the stack of the moment partials and ``finalize_moments``.

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
