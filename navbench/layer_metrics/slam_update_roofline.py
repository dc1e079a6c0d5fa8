"""The update layer's share of its roofline (K2's phase 1 + the downdate
K12, one call each per tick): the least time of one call by
``navbench/roofline/slam.update`` over the mean device time per launch of
its two kernels, in %."""

from navbench.roofline import peaks, slam

KERNELS = ("phase1_kernel", "downdate_kernel")


def read(trace, cell):
    per = [trace.device_s(k) for k in KERNELS]
    if not all(c for _, c in per):
        return None
    spent = sum(s / c for s, c in per)
    return 100.0 * peaks.bound_s(*slam.update(cell["B"], cell["L"], cell["M"])) / spent
