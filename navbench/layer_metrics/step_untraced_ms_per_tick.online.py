"""Host time of an online tick outside the step's inner spans (the
burst check and its sync, the odometry gate, the outputs): the port's
``slam.step`` spans' self time, each one's duration less the union of the
spans inside it, over the ticks, in ms per tick."""

from navbench import spans


def read(trace, cell):
    _, ticks = spans.span_s(trace, "slam.step")
    if not ticks or not trace.device:
        return None
    return spans.length(spans.self_intervals(trace, "slam.step")) / ticks * 1e-3
