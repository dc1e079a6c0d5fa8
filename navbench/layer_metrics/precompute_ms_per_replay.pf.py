"""Host time of a replay's set-up on the kernel path, in ms: the port's
``pf.precompute`` spans (the initial bank, the draws and per-tick rows,
the update flags' read to the host, the segment plan) and
``pf.segment_inputs`` spans (the per-segment rows), summed, per
``pf.precompute`` (one a replay)."""

from navbench import pf_spans


def read(trace, cell):
    pre = pf_spans.spans(trace, "pf.precompute")
    if not pre or not trace.device:
        return None
    seg = pf_spans.spans(trace, "pf.segment_inputs")
    return sum(e - s for s, e in pre + seg) / len(pre) * 1e-3
