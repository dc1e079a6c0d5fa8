"""Device-to-host reads the online step waits on, per tick: the window's
device-to-host copies issued inside one of the port's ``slam.step`` spans,
over the spans (the burst check of each sensor and the table read of each
assignment; the pose read after each tick is issued outside them). One
stream runs its copies in the order the host issued them, so the i-th
copy on the device is the i-th ``cudaMemcpy*`` call on the host: matched
by order, not by time, the count does not depend on how the device's
clock lines up with the host's."""

from navbench import spans


def read(trace, cell):
    steps = spans.spans(trace, "slam.step")
    if not steps or not trace.device:
        return None
    calls = [s for n, s, _ in trace.host if n.startswith("cudaMemcpy")]
    copies = [n for n, _, _ in trace.device if n.startswith("Memcpy")]
    issued = [t for n, t in zip(copies, calls) if "DtoH" in n]
    return sum(any(s <= t <= e for _, s, e in steps) for t in issued) / len(steps)
