"""Host time of one update's systematic counts: the mean of the port's
``pf.counts`` spans (``systematic_counts`` with the blocked CDF), in ms."""

from navbench import pf_spans


def read(trace, cell):
    return pf_spans.mean_ms(trace, "pf.counts")
