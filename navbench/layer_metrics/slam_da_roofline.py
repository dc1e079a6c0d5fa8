"""The data-association layer's share of its roofline (K1, one call per
tick): the least time of one call by ``navbench/roofline/slam.da`` over
the mean device time per launch of ``da_kernel``, in %."""

from navbench.roofline import peaks, slam

KERNELS = ("da_kernel",)


def read(trace, cell):
    spent, count = trace.device_s(KERNELS[0])
    if not count:
        return None
    return 100.0 * peaks.bound_s(*slam.da(cell["B"], cell["L"], cell["M"])) / (spent / count)
