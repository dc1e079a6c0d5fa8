"""Readings that the correctness limits of a cell are set from, in one
process on the card:

    python3 -m navbench.calibrate --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 --seconds <s> --out <file.json>

- The program, per seed: the cell's driver at the cell's own size (set-up,
  a window of ``--seconds``, the check against the float64 reference), as
  a run does it: the numbers its ``judge`` reports (the lower readings).
- The control, per control seed: the driver's ``control``, the reference
  in the precision below the configuration's put in the program's place
  over the same traffic, judged as the program is (the upper readings).

The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import time


def program(cell: str, seed: int, seconds: float, device: str, sizes=None) -> dict:
    from navbench import check
    from navbench.run import Context

    ctx = Context(cell, seed, seconds, device, sizes)
    run = ctx.driver.setup(ctx)
    ctx.driver.window(run, ctx, None)
    ctx.driver.release(run)
    return check.worst(ctx.driver.judge(run, ctx))


def control(cell: str, seed: int, device: str, sizes=None) -> dict:
    from navbench.run import Context

    ctx = Context(cell, seed, 0.0, device, sizes)
    return ctx.driver.control(ctx)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    res = dict(workload=a.workload, program={}, control={})
    for kind, seeds in (("program", a.seeds), ("control", a.control_seeds)):
        for s in (int(x) for x in seeds.split(",") if x):
            t0 = time.perf_counter()
            r = (program(a.workload, s, a.seconds, a.device) if kind == "program"
                 else control(a.workload, s, a.device))
            res[kind][str(s)] = r
            print(f"{a.workload} {kind} seed {s} ({time.perf_counter() - t0:.1f} s): "
                  + ", ".join(f"{k} {v:.3e}" for k, v in r.items()), flush=True)
            with open(a.out, "w") as f:
                json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
