"""Device time per fleet tick outside the data-association kernel and the
update's two kernels: the predict and the plain-torch bookkeeping between
them, with the replay's input staging and output copies spread over its
ticks (µs per tick)."""

PATH_KERNELS = ("da_kernel", "phase1_kernel", "downdate_kernel")


def read(trace, cell):
    total, n = trace.device_s()
    path = [trace.device_s(k) for k in PATH_KERNELS]
    if not n or not trace.units or not all(c for _, c in path):
        return None
    return (total - sum(s for s, _ in path)) / trace.units * 1e6
