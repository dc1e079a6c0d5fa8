"""The ``pf-1M.gps1hz`` cell rehearsed end to end on the CPU at a tiny size
(two missions of 61 ticks, 2^12 particles; the port's plain paths), in a
process in which ``jax`` and ``smarc_navigation_tpu`` cannot be imported:
the run's last line is the result object the benchmark prints, correct;
and the control (the reference's bank and weights in float16) not
correct where the program is, through ``navbench.calibrate``."""

import json
import os
import subprocess
import sys

import pytest

from navbench import calibrate, check, manifest

REPO = os.path.dirname(manifest.ROOT)
BENCH = manifest.benchmark()
CELL = "pf-1M.gps1hz"
SIZES = {"mix": {"distinct": 2}, "T": 61, "particles": 4096}

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
cell, trace, sizes = sys.argv[1], bool(int(sys.argv[2])), json.loads(sys.argv[3])
out, lines = run.run_cell(cell, 2**31 + 101, 0.5, trace, "cpu", sizes=sizes, t_start=t0)
loaded = {m.split(".")[0] for m in sys.modules} & set(run.FORBIDDEN)
assert not loaded, loaded
print("\n".join(lines), file=sys.stderr)
print(json.dumps(out))
"""


@pytest.mark.parametrize("trace", [0, 1])
def test_pf_cell_rehearsal_prints_the_result_line(trace):
    p = subprocess.run([sys.executable, "-c", SCRIPT, CELL, str(trace), json.dumps(SIZES)],
                       cwd=REPO, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(out)[:3] == ["correct", "attempted", "failed"] and list(out)[-1] == "checks"
    assert out["correct"] is True and out["attempted"] > 0 and out["failed"] == 0
    want = {m["name"] for m in manifest.end_to_end(BENCH, CELL)}
    # no device on the CPU: a traced run reads no device metric
    assert set(out["metrics"]) == (set() if trace else want) == (set() if trace else
                                                                  {"mission_steps_per_s", "setup_s"})
    assert list(out["checks"]) == list(manifest.workload(CELL)["limits"])
    assert "ties_refused 0" in p.stderr


def test_pf_control_is_not_correct_and_the_program_is():
    spec = manifest.workload(CELL)
    ctl = calibrate.control(CELL, 2**31 + 19, "cpu", SIZES)
    assert not check.verdict(ctl, spec["limits"]), ctl
    prog = calibrate.program(CELL, 2**31 + 19, 0.2, "cpu", SIZES)
    assert check.verdict(prog, spec["limits"]), prog
