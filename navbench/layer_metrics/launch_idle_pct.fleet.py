"""The share of the traced window in which the device is idle while the
host is inside a graph launch: the port's ``graphs.replay`` spans (less
any span inside them) less every device-busy interval, over the window,
in %. It is the part of ``device_idle_pct.fleet`` that the graph's
submission holds."""

from navbench import spans


def read(trace, cell):
    rep = spans.self_intervals(trace, "graphs.replay")
    if not rep or not trace.device or trace.window_s <= 0:
        return None
    rep = [(max(s, trace.t0), min(e, trace.t1)) for s, e in rep]
    rep = [(s, e) for s, e in rep if e > s]
    return 100.0 * spans.length(spans.minus(rep, trace.busy_intervals())) * 1e-6 / trace.window_s
