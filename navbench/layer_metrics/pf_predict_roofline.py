"""The PF predict kernel's share of its roofline (K5, one call per
segment): the mean least time of the traced calls, each from its real
ticks (``navbench/roofline/pf.predict``), over the mean device time per
launch of ``predict_kernel``, in %."""

from navbench.roofline import pf


def read(trace, cell):
    spent, count = trace.device_s("predict_kernel")
    if not count or not cell["seg_ticks"]:
        return None
    least = [pf.bound_s(*pf.predict(cell["N"], cell["K"], k)) for k in cell["seg_ticks"]]
    return 100.0 * (sum(least) / len(least)) / (spent / count)
