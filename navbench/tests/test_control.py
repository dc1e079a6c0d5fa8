"""The control fails the check: the reference itself, computed in TF32 (the
precision below the configurations' float32 with TF32 off), put in the
program's place over each cell's traffic at a small size, comes out not
correct under the cell's limits; the port's plain float32 path at the same
size comes out correct."""

import pytest

from navbench import calibrate, check, manifest

BENCH = manifest.benchmark()
SIZES = {"fleet_replay": {"mix": {"missions": 2, "distinct": 2}, "T": 60},
         "online_step": {"mix": {"missions": 1}, "T": 150}}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_control_is_not_correct_and_the_program_is(cell):
    spec = manifest.workload(cell)
    sizes = SIZES[spec["driver"]]
    ctl = calibrate.control(cell, 2**31 + 19, "cpu", sizes)
    assert not check.verdict(ctl, spec["limits"]), ctl
    prog = calibrate.program(cell, 2**31 + 19, 0.2, "cpu", sizes)
    assert check.verdict(prog, spec["limits"]), prog
