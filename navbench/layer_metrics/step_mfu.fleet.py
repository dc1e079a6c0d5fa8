"""The whole fleet tick's share of the card's peak: the least time of the
tick's counted work (the data-association and update calls,
``navbench/roofline/slam``) over the traced window's time per tick, in %.
It bounds the kernel layers' shares when a later change moves work off
them."""

from navbench.roofline import peaks, slam


def read(trace, cell):
    if not trace.device or not trace.units:
        return None
    least = sum(peaks.bound_s(*f(cell["B"], cell["L"], cell["M"])) for f in (slam.da, slam.update))
    return 100.0 * least / (trace.window_s / trace.units)
