"""The particle filter's spans (``utils/trace``) on the kernel path: under
a CPU ``torch.profiler``, ``run_fast_segmented`` records one
``pf.precompute``, one ``pf.segment_inputs`` and one ``pf.finalize``, a ``pf.predict`` per segment
and a ``pf.update`` per GPS update with ``pf.weights``, ``pf.counts`` and
``pf.gather`` inside it; without a profiler every span is the shared
no-op, and the outputs are bit for bit those of a profiled run."""

import json

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from smarc_navigation_tpu_torch.configs import PFConfig
from smarc_navigation_tpu_torch.io import sim
from smarc_navigation_tpu_torch.models import particle_filter as P
from smarc_navigation_tpu_torch.utils import trace

N = 2048
CFG = PFConfig(particle_count=N)


def _mission():
    m = sim.simulate(sim.MissionSpec(duration_s=4.0, gps_surface_z=-100.0, gps_std=0.3,
                                     dvl_std=0.02, seed=5))
    return P.pf_timeline(m).to("cpu")


def _run(tl):
    return P.run_fast_segmented(tl, P.make_params(CFG, device="cpu"), CFG,
                                generator=torch.Generator().manual_seed(3))


def _pf_spans(prof, tmp_path) -> list:
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("cat") == "cpu_op" and e["name"].startswith("pf.")),
                  key=lambda s: s[1])


def test_segmented_path_spans(tmp_path):
    tl = _mission()
    upd = (tl.channels["gps"].fresh & (tl.channels["diving"].value[:, 0] < 0.5)).numpy()
    n_seg, n_upd = len(P._segment_plan(upd, 12)), int(upd.sum())
    assert n_upd == 4
    assert trace.span("pf.update") is trace._OFF          # no profiler: the shared no-op
    plain = _run(tl)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = _run(tl)
    sp = _pf_spans(prof, tmp_path)
    count = {n: sum(1 for s in sp if s[0] == n) for n in
             ("pf.precompute", "pf.segment_inputs", "pf.finalize", "pf.predict", "pf.update",
              "pf.weights", "pf.counts", "pf.gather")}
    assert count == {"pf.precompute": 1, "pf.segment_inputs": 1, "pf.finalize": 1,
                     "pf.predict": n_seg, "pf.update": n_upd, "pf.weights": n_upd,
                     "pf.counts": n_upd, "pf.gather": n_upd}
    for _, s, e in (x for x in sp if x[0] == "pf.update"):
        kids = [n for n, cs, ce in sp if s <= cs and ce <= e and n != "pf.update"]
        assert kids == ["pf.weights", "pf.counts", "pf.gather"]
    pre = next(x for x in sp if x[0] == "pf.precompute")
    fin = next(x for x in sp if x[0] == "pf.finalize")
    seg = next(x for x in sp if x[0] == "pf.segment_inputs")
    assert pre[2] <= seg[1] and all(seg[2] <= s <= e <= fin[1] for n, s, e in sp
                                    if n in ("pf.predict", "pf.update"))
    for a, b in ((plain[0].particles, traced[0].particles), (plain[1]["mean"], traced[1]["mean"]),
                 (plain[1]["cov"], traced[1]["cov"])):
        assert np.array_equal(a.numpy(), b.numpy())
