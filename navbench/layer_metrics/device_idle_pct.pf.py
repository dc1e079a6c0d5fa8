"""The device's idle share over the traced replays of a particle-filter
cell: one minus the union of its busy intervals (kernels, copies, fills)
over the traced window, in %."""


def read(trace, cell):
    if not trace.device or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
