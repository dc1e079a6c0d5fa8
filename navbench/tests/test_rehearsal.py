"""Each cell rehearsed end to end on the CPU at a tiny size (the port's
plain paths), in a process in which ``jax`` and ``smarc_navigation_tpu``
cannot be imported: the run's last line is the result object the benchmark prints."""

import json
import os
import subprocess
import sys

import pytest

from navbench import manifest

REPO = os.path.dirname(manifest.ROOT)
BENCH = manifest.benchmark()

SCRIPT = r"""
import importlib.abc, json, sys, time
t0 = time.perf_counter()

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "smarc_navigation_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
from navbench import run
from navbench.tests.small import sizes
cell, trace = sys.argv[1], bool(int(sys.argv[2]))
out, lines = run.run_cell(cell, 2**31 + 101, 0.5, trace, "cpu", sizes=sizes(cell), t_start=t0)
loaded = {m.split(".")[0] for m in sys.modules} & set(run.FORBIDDEN)
assert not loaded, loaded
print("\n".join(lines), file=sys.stderr)
print(json.dumps(out))
"""


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_rehearsal_prints_the_result_line(cell, trace):
    p = subprocess.run([sys.executable, "-c", SCRIPT, cell, str(trace)], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(out)[:3] == ["correct", "attempted", "failed"] and list(out)[-1] == "checks"
    assert out["correct"] is True and out["attempted"] > 0 and out["failed"] == 0
    want = {m["name"] for m in (manifest.per_layer(BENCH, cell) if trace
                                else manifest.end_to_end(BENCH, cell))}
    # no device on the CPU: a traced run reads no device metric
    assert set(out["metrics"]) == (set() if trace else want)
    for m in out["metrics"].values():
        assert isinstance(m["value"], float) and m["unit"]
    dev = out["device"]
    assert dev["platform"] == "cpu" and dev["count"] == 1 and dev["memory_peak_bytes"] == 0
    assert ("busy_s" in dev) == bool(trace)
    limits = manifest.workload(cell)["limits"]
    assert list(out["checks"]) == list(limits)
    assert p.stderr.strip().splitlines()[-1].startswith(f"check {list(limits)[-1]}:")


def test_run_refuses_without_a_card():
    p = subprocess.run([sys.executable, "-m", "navbench.run", "--workload", "slam-L64.online",
                        "--seed", "1", "--seconds", "1"], cwd=REPO, capture_output=True,
                       text=True, timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0 and p.stdout.strip() == ""
