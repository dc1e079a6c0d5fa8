"""Everything the harness runs is found by name, under the benchmark's own
folder (``navbench/``), and ``BENCHMARK.json`` beside it says which
metrics each cell reports:

    configs/<config>.json         a configuration: the fields its driver
                                  hands the port, its source, what was
                                  cut and assumed
    workloads/<cell>.json         a cell: its configuration, traffic mix,
                                  driver, the limit of each number its
                                  driver's check reports, its why
    traffic/mixes/<traffic>.json  a traffic mix: the generator it names
                                  and that generator's parameters
    traffic/generators/<gen>.py   a traffic generator: make(mix, cfg, seed)
    drivers/<driver>.py           a way of driving the port: setup /
                                  window / release / shapes / judge /
                                  control, and NUMBERS, the names judge
                                  reports
    layer_metrics/<metric>.py     a per-layer metric: read(trace, shapes)

A later cell, configuration, mix or metric is a new file here (and its
entry in ``BENCHMARK.json``); no existing file changes.
"""

from __future__ import annotations

import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.abspath(__file__))


def _json(root: str, kind: str, name: str) -> dict:
    with open(os.path.join(root, kind, name + ".json")) as f:
        return json.load(f)


def _module(root: str, kind: str, name: str):
    path = os.path.join(root, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"navbench_{kind}_{name}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def workload(name: str, root: str = ROOT) -> dict:
    return _json(root, "workloads", name)


def config(name: str, root: str = ROOT) -> dict:
    return _json(root, "configs", name)


def mix(name: str, root: str = ROOT) -> dict:
    return _json(root, os.path.join("traffic", "mixes"), name)


def driver(name: str, root: str = ROOT):
    return _module(root, "drivers", name)


def layer_metric(name: str, root: str = ROOT):
    return _module(root, "layer_metrics", name)


def benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(os.path.dirname(root), "BENCHMARK.json")) as f:
        return json.load(f)


def cell_entry(bench: dict, cell: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"no workload {cell!r} in BENCHMARK.json")


def end_to_end(bench: dict, cell: str) -> list:
    """The end-to-end metrics the cell reports."""
    return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]


def per_layer(bench: dict, cell: str) -> list:
    """The per-layer metrics read in the cell's traced run: those that list
    it, or, without a list, those whose moved metric it reports."""
    e2e = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]
