"""The particle filter's spans in a traced window (``navbench/tracing.
Trace``), for the per-layer readers of the ``pf-1M`` cells: the port
records each as a host op named ``pf.*`` (``smarc_navigation_tpu_torch/
utils/trace``). A program without them gives none, and the readers then
return ``None``."""

from __future__ import annotations

LAUNCHES = ("cudaLaunch", "cuLaunch")     # host calls that launch a kernel


def spans(trace, name: str) -> list:
    """The spans called ``name`` in the window, (start µs, end µs), by start."""
    return [(s, s + d) for n, s, d in trace.host if n == name]


def mean_ms(trace, name: str):
    """Mean duration of the spans called ``name`` in ms, or None without
    one (or without a device event in the window)."""
    sel = spans(trace, name)
    return sum(e - s for s, e in sel) / len(sel) * 1e-3 if sel and trace.device else None


def launches_per_span(trace, name: str):
    """Kernel launches the host issues inside the spans called ``name``,
    per span, or None without one."""
    sel = spans(trace, name)
    if not sel or not trace.device:
        return None
    calls = [t for n, t, _ in trace.host if n.startswith(LAUNCHES)]
    return sum(any(s <= t <= e for s, e in sel) for t in calls) / len(sel)
