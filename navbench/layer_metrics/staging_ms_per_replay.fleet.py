"""Host time a fleet replay spends around its graph launch, less its waits
on the device: the port's ``slam.fleet.stage`` (the inputs staged by
``_loop_inputs``), ``graphs.copy_in`` (copied into the graph's static
buffers) and ``graphs.clone_out`` (the outputs cloned) spans, less the
CUDA runtime calls inside them that wait for the replay in flight, summed
over the window and divided by the ``slam.fleet.stage`` spans, in ms per
replay. A wait is a synchronize call, or any other runtime call over
``WAIT_US``: staging's pageable copies wait for the stream in one or the
other (for up to a replay, 0.1-0.6 s), while its own calls, launches,
copies and allocations, last at most ~1.2 ms under the profiler on an
H100."""

from navbench import spans

PARTS = ("slam.fleet.stage", "graphs.copy_in", "graphs.clone_out")
WAIT_US = 5000.0


def read(trace, cell):
    _, replays = spans.span_s(trace, "slam.fleet.stage")
    if not replays or not trace.device:
        return None
    parts = sorted([s, e] for p in PARTS for _, s, e in spans.spans(trace, p))
    waits = [(s, s + d) for n, s, d in trace.host
             if n.startswith("cuda") and (n.endswith("Synchronize") or d > WAIT_US)]
    return spans.length(spans.minus(parts, waits)) / replays * 1e-3
