"""The port's own spans in a traced window (``navbench/tracing.Trace``),
for the per-layer readers that split a tick or a replay by them.

The port records each span as a host op named ``slam.*`` or ``graphs.*``
(``smarc_navigation_tpu_torch/utils/trace``), so the spans are the
window's host events of those names; a span's children are the spans that
start and end inside it (one thread records them all). A program without
spans gives none: every function here then reads zero, and the readers
return ``None``."""

from __future__ import annotations

PREFIXES = ("slam.", "graphs.")


def spans(trace, name: str = None) -> list:
    """The port's spans in the window, (name, start µs, end µs), by start;
    only those called ``name`` if given."""
    return [(n, s, s + d) for n, s, d in trace.host
            if n.startswith(PREFIXES) and (name is None or n == name)]


def span_s(trace, name: str) -> tuple:
    """(summed seconds, count) of the spans called ``name``."""
    sel = spans(trace, name)
    return sum(e - s for _, s, e in sel) * 1e-6, len(sel)


def mean_ms(trace, name: str):
    """Mean duration of the spans called ``name`` in ms, or None without
    one (or without a device event in the window)."""
    total, n = span_s(trace, name)
    return total / n * 1e3 if n and trace.device else None


def minus(a: list, b: list) -> list:
    """Disjoint sorted intervals ``a`` less the union of the intervals ``b``
    (sorted by start; they may overlap or nest)."""
    out = []
    for s, e in a:
        for bs, be in b:
            if be <= s or bs >= e:
                continue
            if bs > s:
                out.append([s, bs])
            s = max(s, be)
            if s >= e:
                break
        if s < e:
            out.append([s, e])
    return out


def length(ivs) -> float:
    return sum(e - s for s, e in ivs)


def self_intervals(trace, name: str) -> list:
    """Where a span called ``name`` runs with none of its child spans: each
    such span's interval less the union of the spans inside it (µs)."""
    every = spans(trace)
    out = []
    for _, s, e in spans(trace, name):
        kids = sorted((cs, ce) for _, cs, ce in every if s <= cs and ce <= e
                      and (cs, ce) != (s, e))
        out += minus([[s, e]], kids)
    return out
