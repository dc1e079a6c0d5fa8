"""The PF cell's per-layer readers on a hand-written Chrome trace: two GPS
updates (launches inside and outside their spans), two K5 calls, one K7
call, one replay's precompute and segment inputs; each value computed by hand, ``None``
without a device event or without the port's ``pf.*`` spans (the parent
commit's port records none), and the roofline shares from
``navbench/roofline/pf.py``."""

import pytest

from navbench import manifest, tracing
from navbench.roofline import pf

SHAPES = dict(N=2**20, T=601, K=12, seg_ticks=[11, 10], S=60.0, U=60.0)
PF_METRICS = [m["name"] for m in manifest.benchmark()["per_layer"]
              if m.get("workloads") == ["pf-1M.gps1hz"]]


def _ev(cat, name, ts, dur):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, pid=1, tid=1)


WINDOW = [_ev("user_annotation", tracing.WINDOW, 1000.0, 1000.0)]
DEVICE = [_ev("kernel", "void (anonymous namespace)::predict_kernel<false, true, 0, true>(int)", 1100.0, 80.0),
          _ev("kernel", "void (anonymous namespace)::predict_kernel<false, true, 0, true>(int)", 1300.0, 70.0),
          _ev("kernel", "void (anonymous namespace)::gather_kernel<true, true>(int, int)", 1500.0, 32.0),
          _ev("kernel", "void at::native::vectorized_elementwise_kernel<4>(int)", 1600.0, 8.0)]
HOST = [_ev("cuda_runtime", "cudaLaunchKernel", 1210.0, 2.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 1220.0, 2.0),
        _ev("cuda_runtime", "cudaLaunchCooperativeKernel", 1240.0, 3.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 1410.0, 2.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 1900.0, 2.0)]      # outside every update
SPANS = [_ev("cpu_op", n, ts, dur) for n, ts, dur in (
    ("pf.precompute", 1010.0, 40.0),
    ("pf.segment_inputs", 1052.0, 6.0),
    ("pf.predict", 1060.0, 20.0),
    ("pf.update", 1200.0, 60.0),
    ("pf.weights", 1202.0, 10.0),
    ("pf.counts", 1215.0, 20.0),
    ("pf.gather", 1236.0, 10.0),
    ("pf.predict", 1280.0, 30.0),
    ("pf.update", 1400.0, 40.0),
    ("pf.counts", 1405.0, 30.0),
    ("pf.finalize", 1800.0, 50.0))]

# by hand: updates 60 and 40 µs, counts 20 and 30, predicts 20 and 30, one
# replay's precompute of 40 and segment inputs of 6; four launches inside the two updates; K5 75 µs and K7
# 32 µs a call on the device
EXPECTED = {
    "update_ms_per_gps.pf": 0.05,
    "counts_ms_per_gps.pf": 0.025,
    "predict_ms_per_segment.pf": 0.025,
    "precompute_ms_per_replay.pf": 0.046,
    "kernels_per_update.pf": 2.0,
    "device_idle_pct.pf": 100.0 * (1.0 - 190.0 / 1000.0),
    "pf_predict_roofline": 100.0 * (pf.bound_s(*pf.predict(2**20, 12, 11))
                                    + pf.bound_s(*pf.predict(2**20, 12, 10))) / 2 / 75e-6,
    "pf_resample_roofline": 100.0 * pf.bound_s(*pf.gather(2**20)) / 32e-6,
}
SPAN_READERS = ("update_ms_per_gps.pf", "counts_ms_per_gps.pf", "predict_ms_per_segment.pf",
                "precompute_ms_per_replay.pf", "kernels_per_update.pf")


def _read(name, events):
    return manifest.layer_metric(name).read(tracing.Trace(events, 2 * 601), SHAPES)


def test_every_pf_metric_has_a_hand_computed_value():
    assert sorted(PF_METRICS) == sorted(EXPECTED)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_pf_metric_reads_its_hand_computed_value(name):
    assert _read(name, WINDOW + DEVICE + HOST + SPANS) == pytest.approx(EXPECTED[name], rel=1e-9)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_pf_metric_reads_none_without_device_events(name):
    assert _read(name, WINDOW + HOST + SPANS) is None
    if name in SPAN_READERS:        # the parent's port: no pf.* spans
        assert _read(name, WINDOW + DEVICE + HOST) is None
    else:
        assert _read(name, WINDOW + DEVICE + HOST) == _read(name, WINDOW + DEVICE + HOST + SPANS)


def test_rooflines_match_the_kernel_table():
    """PERF.md's table: K5 18.8 µs per 10-tick segment, K7 16.3 µs per call, at 2^20."""
    assert pf.bound_s(*pf.predict(2**20, 12, 10)) == pytest.approx(18.8e-6, abs=0.05e-6)
    assert pf.bound_s(*pf.gather(2**20)) == pytest.approx(16.3e-6, abs=0.05e-6)
