"""BENCHMARK.json and the files it names: the allowed characters and
shapes, every name found as a file of its own, and new cells added as new
files without editing any existing one: one more SLAM cell on a mix of
its own, and a cell of another kind with its own configuration,
generator, driver, compared number and per-layer metric, run end to end."""

import hashlib
import json
import os
import re
import shutil

import pytest

from navbench import manifest
from navbench.run import Context

REPO = os.path.dirname(manifest.ROOT)
BENCH = manifest.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"] for m in BENCH["end_to_end"]}


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and len(BENCH["command"]) <= 32
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/")
               and ".." not in p for p in BENCH["paths"])
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024
    assert "setup_s" in E2E
    for m in BENCH["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def test_names_units_and_text_fields():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in BENCH[kind]]
        assert len(got) == len(set(got))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    texts = [x["why"] for x in BENCH["configs"] + BENCH["workloads"]]
    texts += [c["source"] for c in BENCH["configs"]] + [m["layer"] for m in BENCH["per_layer"]]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in manifest.end_to_end(BENCH, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.per_layer(BENCH, w["name"])


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_cells_report_what_it_moves(metric):
    assert metric["moves"] in E2E
    for cell in metric.get("workloads", []):
        assert metric["moves"] in {m["name"] for m in manifest.end_to_end(BENCH, cell)}
    assert callable(manifest.layer_metric(metric["name"]).read)


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_name_is_a_file_of_its_own(cell):
    spec = manifest.workload(cell["name"])
    assert spec["config"] == cell["config"] and spec["traffic"] == cell["traffic"]
    ctx = Context(cell["name"], 1, 1.0, "cpu")
    # a limit for numbers that the cell's driver reports, and for no other
    assert ctx.spec["limits"] and set(ctx.spec["limits"]) <= set(ctx.driver.NUMBERS)
    for f in ("setup", "window", "release", "shapes", "judge", "control"):
        assert callable(getattr(ctx.driver, f))
    conf = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    assert conf["file"] == f"navbench/configs/{cell['config']}.json"
    assert set(conf["reduced"]) <= set(ctx.config["reduced"])


def _tree_digest(root):
    h = {}
    for d, _, files in os.walk(root):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                h[os.path.relpath(p, root)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return h


def _copy(tmp_path):
    root = tmp_path / "navbench"
    shutil.copytree(manifest.ROOT, root, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    return root, _tree_digest(root)


def test_new_slam_cell_is_a_new_file(tmp_path):
    root, before = _copy(tmp_path)
    mix = dict(manifest.mix("fleet256"), missions=48)
    (root / "traffic" / "mixes" / "fleet48.json").write_text(json.dumps(mix))
    spec = dict(manifest.workload("slam-L64.fleet1024"), traffic="fleet48",
                why="a new cell: the L=64 configuration on a 48-lane mix")
    (root / "workloads" / "slam-L64.fleet48.json").write_text(json.dumps(spec))
    after = _tree_digest(root)
    assert {k: v for k, v in after.items() if k in before} == before
    ctx = Context("slam-L64.fleet48", 5, 1.0, "cpu", root=str(root))
    assert ctx.mix["missions"] == 48 and ctx.config["max_landmarks"] == 64
    assert ctx.driver.__name__.endswith("fleet_replay")


TOY_GENERATOR = """
import numpy as np


def make(mix, cfg, seed):
    return np.random.default_rng(seed % 2**64).normal(size=(mix["rows"], cfg["width"]))
"""

TOY_DRIVER = """
import time

import numpy as np
import torch

from navbench.traffic import generate

NUMBERS = ("sum_err",)


class Run:
    pass


def setup(ctx):
    run = Run()
    run.x = torch.as_tensor(generate.make(ctx.mix, ctx.config, ctx.seed, ctx.root))
    return run


def window(run, ctx, tracer):
    n, t0 = 0, time.perf_counter()
    while True:
        run.out = run.x.sum(1) * ctx.config["scale"]
        n += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    el = time.perf_counter() - t0
    return dict(values={"mission_steps_per_s": n / el, "rows_per_s": n * len(run.x) / el},
                attempted=n, failed=0, elapsed=el)


def shapes(run, ctx):
    return dict(rows=len(run.x), width=ctx.config["width"])


def release(run):
    run.x = None


def _ref(ctx):
    x = generate.make(ctx.mix, ctx.config, ctx.seed, ctx.root)
    return x.sum(1) * ctx.config["scale"]


def judge(run, ctx):
    return [{"sum_err": float(np.abs(run.out.numpy() - _ref(ctx)).max())}]


def control(ctx):
    x = generate.make(ctx.mix, ctx.config, ctx.seed, ctx.root).astype(np.float16)
    return {"sum_err": float(np.abs(x.sum(1) * ctx.config["scale"] - _ref(ctx)).max())}
"""

TOY_METRIC = """
def read(trace, shapes):
    return shapes["rows"] if trace is not None else None
"""


def test_cell_of_another_kind_is_new_files_only(tmp_path):
    from navbench import check, run

    root, before = _copy(tmp_path)
    files = {"configs/toy.json": json.dumps({"width": 8, "scale": 2.0}),
             "traffic/mixes/toy-rows.json": json.dumps({"generator": "toy_rows", "rows": 4}),
             "traffic/generators/toy_rows.py": TOY_GENERATOR,
             "drivers/toy_sum.py": TOY_DRIVER,
             "layer_metrics/toy_rows_seen.py": TOY_METRIC,
             "workloads/toy.sum.json": json.dumps(
                 {"config": "toy", "traffic": "toy-rows", "driver": "toy_sum",
                  "limits": {"sum_err": 1e-9}, "why": "a toy cell of another kind"})}
    for name, text in files.items():
        (root / name).write_text(text)
    assert {k: v for k, v in _tree_digest(root).items() if k in before} == before
    bench = dict(BENCH, workloads=BENCH["workloads"] + [
        {"name": "toy.sum", "config": "toy", "traffic": "toy-rows", "chips": 1, "why": "toy"}])
    bench["end_to_end"] = BENCH["end_to_end"] + [
        {"name": "rows_per_s", "unit": "rows/s", "better": "higher", "bound": 0.05,
         "source": "host_clock", "workloads": ["toy.sum"]}]
    bench["per_layer"] = BENCH["per_layer"] + [
        {"name": "toy_rows_seen", "unit": "rows", "better": "higher", "source": "program_counter",
         "layer": "toy", "moves": "rows_per_s", "workloads": ["toy.sum"]}]
    out, lines = run.run_cell("toy.sum", 2**31 + 3, 0.05, False, "cpu", bench=bench,
                              root=str(root))
    assert out["correct"] is True
    assert set(out["metrics"]) == {"mission_steps_per_s", "rows_per_s", "setup_s"}
    assert list(out["checks"]) == ["sum_err"] and out["checks"]["sum_err"]["value"] <= 1e-9
    assert lines[-1].startswith("check sum_err:")
    ctx = Context("toy.sum", 2**31 + 3, 0.0, "cpu", root=str(root))
    assert not check.verdict(ctx.driver.control(ctx), ctx.spec["limits"])
