"""Host time of one K5 call: the mean of the port's ``pf.predict`` spans
(one per segment), in ms."""

from navbench import pf_spans


def read(trace, cell):
    return pf_spans.mean_ms(trace, "pf.predict")
