"""Kernels the fleet graph replay runs per fleet tick: the traced window's
kernel events over the ticks it replayed (copies and fills not counted)."""


def read(trace, cell):
    if not trace.n_kernels or not trace.units:
        return None
    return trace.n_kernels / trace.units
