"""Host time of one GPS update: the mean of the port's ``pf.update`` spans
(weights, counts, K7's call), in ms."""

from navbench import pf_spans


def read(trace, cell):
    return pf_spans.mean_ms(trace, "pf.update")
