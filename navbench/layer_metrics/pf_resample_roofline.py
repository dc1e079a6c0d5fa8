"""The PF resample kernel's share of its roofline (K7 with the jitter, one
call per GPS update): the least time of one call
(``navbench/roofline/pf.gather``) over the mean device time per launch of
``gather_kernel``, in %."""

from navbench.roofline import pf


def read(trace, cell):
    spent, count = trace.device_s("gather_kernel")
    if not count:
        return None
    return 100.0 * pf.bound_s(*pf.gather(cell["N"])) / (spent / count)
