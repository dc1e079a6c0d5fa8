"""Kernels one online `step` launches per tick: the traced window's
kernel events over the ticks it stepped (copies and fills not counted)."""


def read(trace, cell):
    if not trace.n_kernels or not trace.units:
        return None
    return trace.n_kernels / trace.units
