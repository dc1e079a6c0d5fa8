"""Kernels one GPS update launches: the host's kernel launches issued
inside the port's ``pf.update`` spans (weights, counts with the blocked
CDF, K7), per span."""

from navbench import pf_spans


def read(trace, cell):
    return pf_spans.launches_per_span(trace, "pf.update")
