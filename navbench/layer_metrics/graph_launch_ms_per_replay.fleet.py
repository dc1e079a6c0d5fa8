"""Host time of a fleet replay's graph launch (``CUDAGraph.replay``, the
submission of the captured tick loop): the mean of the port's
``graphs.replay`` spans (one per replay), in ms."""

from navbench import spans


def read(trace, cell):
    return spans.mean_ms(trace, "graphs.replay")
