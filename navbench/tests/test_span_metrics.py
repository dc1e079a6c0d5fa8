"""The readers of the port's spans on a hand-written Chrome trace: one fleet
replay (staging, copies, a graph launch the device idles through, clones)
and two online ticks (one with a data-association pass), each value
computed by hand; ``None`` without a device event or without the port's
spans; and the readers that read no span reading the same with the spans
in the trace as without them."""

import pytest

from navbench import manifest, tracing

SHAPES = dict(B=1024, L=64, M=8, D=198)
SPAN_METRICS = {m["name"] for m in manifest.benchmark()["per_layer"]
                if m["source"] == "program_span" or m["name"] == "host_syncs_per_tick.online"}


def _ev(cat, name, ts, dur):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, pid=1, tid=1)


WINDOW = [_ev("user_annotation", tracing.WINDOW, 1000.0, 1000.0)]
DEVICE = [_ev("kernel", "void da_kernel<false>(float*)", 1100.0, 20.0),
          _ev("kernel", "void phase1_kernel<3>(float*)", 1200.0, 100.0),
          _ev("kernel", "void downdate_kernel<2>(float*)", 1300.0, 300.0),
          _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 1700.0, 2.0),
          _ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1735.0, 2.0),
          _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 1880.0, 2.0),
          _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 1952.0, 2.0)]   # the pose read
HOST = [_ev("cuda_runtime", "cudaGraphLaunch", 1085.0, 290.0),
        _ev("cpu_op", "aten::copy_", 1061.0, 5.0),
        _ev("cuda_runtime", "cudaStreamSynchronize", 1030.0, 12.0),    # staging waits
        _ev("cuda_runtime", "cudaStreamSynchronize", 1690.0, 15.0),
        # the copies' issue on the host, in the device's order
        _ev("cuda_runtime", "cudaMemcpyAsync", 1688.0, 1.0),
        _ev("cuda_runtime", "cudaMemcpyAsync", 1733.0, 1.0),
        _ev("cuda_runtime", "cudaMemcpyAsync", 1858.0, 1.0),
        _ev("cuda_runtime", "cudaMemcpyAsync", 1951.0, 1.0)]
SPANS = [_ev("cpu_op", n, ts, dur) for n, ts, dur in (
    ("slam.fleet.stage", 1020.0, 30.0),
    ("graphs.copy_in", 1060.0, 10.0),
    ("graphs.replay", 1080.0, 300.0),
    ("graphs.clone_out", 1400.0, 20.0),
    ("slam.step", 1600.0, 200.0),
    ("slam.predict", 1610.0, 20.0),
    ("slam.da_stage", 1640.0, 50.0),
    ("slam.jv", 1690.0, 40.0),
    ("slam.commit", 1730.0, 30.0),
    ("slam.step", 1850.0, 100.0),
    ("slam.predict", 1855.0, 10.0))]

# by hand: staging 30 - 12 (its wait) + 10 + 20 µs; the replay's launch
# [1080, 1380] is idle until the first kernel at 1100 and from 1120 to 1200
# (100 µs of the 1000 µs window); the ticks' self times 200 - 140 and
# 100 - 10 µs; two of three device-to-host copies issued inside a step
EXPECTED = {
    "graph_launch_ms_per_replay.fleet": 0.3,
    "staging_ms_per_replay.fleet": 0.048,
    "launch_idle_pct.fleet": 10.0,
    "predict_ms_per_tick.online": 0.015,
    "da_stage_ms_per_pass.online": 0.05,
    "jv_ms_per_pass.online": 0.04,
    "commit_ms_per_pass.online": 0.03,
    "step_untraced_ms_per_tick.online": 0.075,
    "host_syncs_per_tick.online": 1.0,
}


def _read(name, events, units=2):
    return manifest.layer_metric(name).read(tracing.Trace(events, units), SHAPES)


def test_every_span_metric_has_a_hand_computed_value():
    assert SPAN_METRICS == set(EXPECTED)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_span_metric_reads_its_hand_computed_value(name):
    assert _read(name, WINDOW + DEVICE + HOST + SPANS) == pytest.approx(EXPECTED[name], rel=1e-9)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_span_metric_reads_none_without_device_events_or_spans(name):
    assert _read(name, WINDOW + HOST + SPANS) is None
    assert _read(name, WINDOW + DEVICE + HOST) is None


def test_host_syncs_read_alike_with_the_device_clock_behind():
    """The device's clock 5 µs behind the host's: by time the pose read's
    copy (issued after the second tick) then lies inside that tick; by
    issue order it does not."""
    moved = [dict(e, ts=e["ts"] - 5.0) if e["cat"] == "gpu_memcpy" else e for e in DEVICE]
    got = _read("host_syncs_per_tick.online", WINDOW + moved + HOST + SPANS)
    assert got == pytest.approx(EXPECTED["host_syncs_per_tick.online"], rel=1e-9)


def test_staging_leaves_out_only_the_calls_that_wait():
    """A copy that waits 6 ms for the stream is left out of staging; the
    short copies in staging and in ``graphs.copy_in`` stay in it."""
    ev = [_ev("user_annotation", tracing.WINDOW, 0.0, 20000.0),
          _ev("kernel", "void phase1_kernel<3>(float*)", 50.0, 6000.0),
          _ev("cpu_op", "slam.fleet.stage", 100.0, 7000.0),
          _ev("cuda_runtime", "cudaMemcpyAsync", 200.0, 6000.0),
          _ev("cuda_runtime", "cudaMemcpyAsync", 6300.0, 10.0),
          _ev("cpu_op", "graphs.copy_in", 7200.0, 100.0),
          _ev("cuda_runtime", "cudaMemcpyAsync", 7210.0, 20.0)]
    assert _read("staging_ms_per_replay.fleet", ev) == pytest.approx(1.1, rel=1e-9)


def test_online_split_adds_up_to_the_ticks():
    ev = WINDOW + DEVICE + HOST + SPANS
    ticks, passes = 2, 1
    total = (_read("predict_ms_per_tick.online", ev) * ticks
             + passes * sum(_read(f"{k}_ms_per_pass.online", ev) for k in ("da_stage", "jv", "commit"))
             + _read("step_untraced_ms_per_tick.online", ev) * ticks)
    assert total == pytest.approx(0.3, rel=1e-9)


@pytest.mark.parametrize("name", sorted(
    m["name"] for m in manifest.benchmark()["per_layer"] if m["name"] not in EXPECTED))
def test_other_readers_read_the_same_with_the_spans(name):
    without = _read(name, WINDOW + DEVICE + HOST)
    assert without is not None
    assert _read(name, WINDOW + DEVICE + HOST + SPANS) == without
