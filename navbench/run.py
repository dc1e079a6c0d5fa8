"""Run one cell of the port's benchmark once:

    python3 -m navbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks for.
It builds the cell's traffic from the seed, sets the port up and warms it
(``setup_s``: from process start to the first timed call), measures for
``--seconds`` with the window's thread on one host core and one intra-op
thread, reads the peak device memory, frees the program's state,
checks what the timed path produced against the float64 reference, and
prints as its last line one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer metrics, read from a profiled sub-window at the start of
the window), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``: each number compared with its limit, also the last lines on
standard error. Without a CUDA card (or fewer than the cell asks for), or
if ``jax``, ``jaxlib``, ``flax`` or the JAX package were loaded, it exits
with a nonzero code and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "smarc_navigation_tpu")
CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".navbench_cache")


class Context:
    """What a driver reads: the cell's workload file (``spec``), the
    configuration's fields, the traffic mix, the run's seed, window length,
    device, size overrides (rehearsals at small sizes only) and the
    benchmark's folder (``root``), under which the driver finds its
    traffic generator."""

    def __init__(self, cell, seed, seconds, device, sizes=None, root=None):
        from navbench import manifest

        root = root or manifest.ROOT
        self.cell = cell
        self.spec = manifest.workload(cell, root)
        self.config = manifest.config(self.spec["config"], root)
        self.mix = manifest.mix(self.spec["traffic"], root)
        self.driver = manifest.driver(self.spec["driver"], root)
        self.seed, self.seconds, self.device = seed, seconds, device
        self.sizes = sizes or {}
        self.root = root


def run_cell(cell, seed, seconds, trace, device="cuda", sizes=None, bench=None, root=None,
             t_start=None):
    """One run of a cell -> (result dict, the checks' stderr lines)."""
    import torch

    from navbench import check, manifest, tracing

    t_start = T_START if t_start is None else t_start
    ctx = Context(cell, seed, seconds, device, sizes, root)
    bench = bench or manifest.benchmark(ctx.root)
    drv = ctx.driver
    run = drv.setup(ctx)
    setup_s = time.perf_counter() - t_start
    tracer = tracing.Tracer(device) if trace else None
    # the window's thread on one host core: the host's own scheduling
    # moved it between cores and spread the runs (PERF.md §2)
    cores = os.sched_getaffinity(0)
    os.sched_setaffinity(0, {max(cores)})
    try:
        res = drv.window(run, ctx, tracer)
    finally:
        os.sched_setaffinity(0, cores)
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    shapes = drv.shapes(run, ctx)
    tr = tracer.trace() if tracer and tracer.units else None
    drv.release(run)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    nums = check.worst(drv.judge(run, ctx))
    t_ref = time.perf_counter() - t_ref
    limits = ctx.spec["limits"]

    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name(device) if cuda else "cpu",
               count=1, memory_peak_bytes=int(peak))
    out = dict(correct=check.verdict(nums, limits), attempted=res["attempted"],
               failed=res["failed"])
    if trace:
        metrics = {}
        for m in manifest.per_layer(bench, cell):
            v = manifest.layer_metric(m["name"], ctx.root).read(tr, shapes) if tr else None
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        dev.update(busy_s=tr.busy_s if tr else 0.0, window_s=tr.window_s if tr else 0.0)
        out.update(metrics=metrics, device=dev)
        if tr:
            out["breakdown"] = dict(device_ops=tr.top_ops(), idle_gaps=tr.idle_gaps())
    else:
        vals = dict(res["values"], setup_s=setup_s)
        metrics = {m["name"]: {"value": float(vals[m["name"]]), "unit": m["unit"]}
                   for m in manifest.end_to_end(bench, cell)}
        out.update(metrics=metrics, device=dev)
    out["checks"] = check.report(nums, limits)
    parts = ", ".join(f"{k} {v!r} s" for k, v in getattr(run, "setup_parts", {}).items())
    notes = ", ".join(f"{k} {v!r}" for k, v in getattr(run, "notes", {}).items())
    lines = [f"timing: setup {setup_s!r} s ({parts}), window {res['elapsed']!r} s, "
             f"reference {t_ref!r} s; {notes}"]
    lines += [f"check {k}: {v['value']!r} (limit {v['limit']!r})" for k, v in out["checks"].items()]
    return out, lines


def _power_limit() -> str:
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return p.stdout.strip().splitlines()[0] if p.returncode == 0 and p.stdout else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    from navbench import manifest

    bench = manifest.benchmark()
    chips = manifest.cell_entry(bench, args.workload)["chips"]
    import torch

    torch.set_num_threads(1)          # one intra-op thread for the host's torch ops

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"navbench: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0",
                          bench=bench)
    loaded = sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))
    if loaded:
        print(f"navbench: forbidden modules loaded: {loaded}", file=sys.stderr)
        return 3
    print(f"card: {_power_limit()}; peaks {3.35e12:.4g} B/s, {67e12:.4g} float32 FLOP/s",
          file=sys.stderr)
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
