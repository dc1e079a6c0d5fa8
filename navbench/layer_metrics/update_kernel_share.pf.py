"""The share of GPS updates that ran on the update's kernels: the launches
of K13 (``gps_weights_kernel``) and of K14 (``systematic_counts_grid_kernel``
or ``systematic_counts_flat_kernel``) on the device in the traced window,
the smaller of the two, over the port's ``pf.update`` spans, in %. A
program whose updates are plain torch reads 0."""

from navbench import pf_spans

K13 = ("gps_weights_kernel",)
K14 = ("systematic_counts_grid_kernel", "systematic_counts_flat_kernel")


def read(trace, cell):
    updates = len(pf_spans.spans(trace, "pf.update"))
    if not updates or not trace.device:
        return None
    launched = [sum(trace.device_s(k)[1] for k in names) for names in (K13, K14)]
    return 100.0 * min(launched) / updates
