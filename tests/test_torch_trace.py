"""The port's spans (``utils/trace``): no-op without a profiler; under a
CPU ``torch.profiler`` (the operator's ``io.replay.profile_replay``, a bare
profiler around ``run_fleet``) one span per tick, per pass and per replay
in the exported trace, each inside its parent; and the outputs bit for bit
those of an unprofiled run."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from smarc_navigation_tpu_torch.configs import EKFSlamConfig
from smarc_navigation_tpu_torch.io import logs, replay
from smarc_navigation_tpu_torch.models import ekf_slam as slam
from smarc_navigation_tpu_torch.utils import trace

CFG = dataclasses.replace(EKFSlamConfig(), max_landmarks=16, max_obs=8, mhl_dist_mbes=1.0,
                          q_mbes_diag=(0.1,) * 3, r_diag=(1e-3,) * 6)
SAMPLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data",
                      "sample_mission.npz")
TICKS = 12      # the sample mission has detections on every other tick


@pytest.fixture(scope="module")
def mission():
    streams, _ = logs.load_log(SAMPLE)
    tl = logs.log_to_timeline(streams, CFG.system_freq, channels=("odom",),
                              events={"mbes": CFG.max_obs})
    return tl.map(lambda x: x[:TICKS]).to("cpu"), slam.make_params(CFG, device="cpu")


def _step(params):
    def step(state, tick):
        return slam.step(CFG, params, state, tick)
    return step


def _spans(events) -> list:
    """A Chrome trace's spans of the port: (name, start, end, thread)."""
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["tid"])
                   for e in events if e.get("cat") == "cpu_op"
                   and e["name"].startswith(("slam.", "graphs."))), key=lambda s: s[1])


def _exported(prof, tmp_path) -> list:
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _inside(child, parent) -> bool:
    return child[3] == parent[3] and parent[1] <= child[1] and child[2] <= parent[2]


def _equal(a, b) -> bool:
    return all(np.array_equal(x.numpy(), y.numpy()) for x, y in zip(a, b))


def test_span_without_a_profiler_is_the_shared_no_op():
    assert not torch.autograd._profiler_enabled()
    a, b = trace.span("slam.step"), trace.span("graphs.replay")
    assert a is b
    with a as got:
        assert got is None


def test_step_spans_once_per_tick_and_pass(mission, tmp_path):
    tl, params = mission
    bursts = int(np.asarray(tl.events["mbes"].mask).any(1).sum())
    assert 0 < bursts < TICKS
    s0 = slam.init_state(CFG, device="cpu")
    st0, out0 = replay.run_chunked(_step(params), s0, tl, validate=False)
    st1, out1 = replay.profile_replay(_step(params), s0, tl, str(tmp_path))

    with open(tmp_path / "replay_trace.json") as f:
        spans = _spans(json.load(f)["traceEvents"])
    by = {n: [s for s in spans if s[0] == n] for n in
          ("slam.step", "slam.predict", "slam.da_stage", "slam.jv", "slam.commit")}
    assert len(by["slam.step"]) == len(by["slam.predict"]) == TICKS
    for n in ("slam.predict", "slam.da_stage", "slam.jv", "slam.commit"):
        for s in by[n]:
            assert sum(_inside(s, p) for p in by["slam.step"]) == 1, n
    for n in ("slam.da_stage", "slam.jv", "slam.commit"):
        assert len(by[n]) == bursts, n
    # a burst tick's pass: DA stage, then JV, then commit, in one step
    for d, j, c in zip(by["slam.da_stage"], by["slam.jv"], by["slam.commit"]):
        assert d[2] <= j[1] and j[2] <= c[1]
        assert any(_inside(d, p) and _inside(c, p) for p in by["slam.step"])

    assert _equal(st0, st1)
    assert out0.keys() == out1.keys()
    assert all(np.array_equal(out0[k], out1[k]) for k in out0)


def test_run_fleet_spans_its_staging(mission, tmp_path):
    tl, params = mission
    tl = tl.map(lambda x: torch.stack([x[:4], x[:4]]))
    final0, out0 = slam.run_fleet(tl, params, CFG)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        final1, out1 = slam.run_fleet(tl, params, CFG)
    spans = _spans(_exported(prof, tmp_path))
    assert [s[0] for s in spans] == ["slam.fleet.stage"]    # no graph on the CPU
    assert _equal(final0, final1)
    assert out0.keys() == out1.keys() and _equal(out0.values(), out1.values())
