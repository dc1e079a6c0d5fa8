"""The port's native host runtime (``native``: the C++ JV and the event
binner, built with g++ from the package's own copy of the source) and
``ops.assignment.hungarian_host`` against the reference's.

Assignments are exact; binned timelines bitwise. These tests skip only
where no g++ is installed, as the reference's ``tests/test_native.py``
does; the ``cuda`` test skips where there is no CUDA device.
"""

import os
import shutil
import warnings

import numpy as np
import pytest
import torch

from smarc_navigation_tpu_torch import native
from smarc_navigation_tpu_torch.ops import assignment
from smarc_navigation_tpu_torch.ops import timeline as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, "data", "sample_mission.npz")

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ toolchain")


def _tied_tables(seed, n=40):
    """SLAM-shaped (L + M, M) tables with exact ties: integer costs in a
    small range, the outlier rows' constant cost, whole tied columns."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        L, M = int(rng.integers(3, 24)), int(rng.integers(1, 9))
        cost = rng.integers(0, 4, (L + M, M)).astype(np.float32)
        cost[L:] = 10000.0
        cost[L + np.arange(M), np.arange(M)] = 2.0
        if i % 3 == 0:
            cost[:, 0] = 1.0                  # a column tied on every row
        out.append(cost)
    return out


def test_builds_in_the_package():
    """The library is built from the package's own source into its build
    directory (the source is the reference's byte for byte:
    ``tests/test_torch_no_jax.py``)."""
    assert native._SRC == os.path.join(REPO, "smarc_navigation_tpu_torch", "csrc",
                                       "smarcnav_native.cc")
    assert native.available()
    pkg = os.path.join(REPO, "smarc_navigation_tpu_torch")
    assert os.path.dirname(native._LIB) == os.path.join(pkg, "build")
    with open(native._STAMP) as f:
        assert f.read().strip() == native._src_hash()


def test_build_is_stamped_by_source_hash(monkeypatch, tmp_path):
    """A library is trusted only when its stamp holds the source's sha256:
    a foreign stamp makes ``_load`` rebuild, into the given place only."""
    lib, stamp = str(tmp_path / "libsmarcnav.so"), str(tmp_path / "libsmarcnav.so.srchash")
    monkeypatch.setattr(native, "_LIB", lib)
    monkeypatch.setattr(native, "_STAMP", stamp)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    with open(stamp, "w") as f:
        f.write("deadbeef")
    assert not native._cached_lib_current(native._src_hash())
    assert native.available()
    assert open(stamp).read() == native._src_hash() and os.path.exists(lib)
    assert sorted(os.listdir(tmp_path)) == ["libsmarcnav.so", "libsmarcnav.so.srchash"]


def test_jv_matches_scipy_and_reference():
    from smarc_navigation_tpu import native as jnative

    rng = np.random.default_rng(0)
    for _ in range(20):
        R, C = int(rng.integers(5, 40)), int(rng.integers(2, 5))
        cost = rng.uniform(0, 10, (R, C))
        a = native.jv_assign(cost)
        s = assignment._scipy_solve(cost)
        assert abs(cost[a, np.arange(C)].sum() - cost[s, np.arange(C)].sum()) < 1e-9
        assert len(set(a.tolist())) == C and a.dtype == np.int32
        assert np.array_equal(a, jnative.jv_assign(cost))
    costs = rng.uniform(0, 5, (6, 12, 4))
    batch = native.jv_assign_batch(costs)
    assert np.array_equal(batch, np.stack([native.jv_assign(c) for c in costs]))
    assert np.array_equal(batch, jnative.jv_assign_batch(costs))
    with pytest.raises(ValueError, match="C<=R"):
        native.jv_assign(np.zeros((2, 3)))


def test_latest_index_matches_searchsorted():
    rng = np.random.default_rng(1)
    stamps = np.sort(rng.uniform(0, 10, 200))
    ticks = np.arange(-1.0, 11.0, 0.05)
    assert np.array_equal(native.latest_index(stamps, ticks),
                          np.searchsorted(stamps, ticks, side="right") - 1)


def test_hungarian_host_takes_native_jv_on_ties():
    """The port's host solver equals the reference's (its ``pure_callback``
    into the native JV) on tables with exact ties, and the exact torch JV
    ``hungarian``: the same algorithm and tie rule everywhere."""
    import jax.numpy as jnp

    from smarc_navigation_tpu.ops import assignment as jassignment

    n_scipy_differs = 0
    for cost in _tied_tables(0):
        got = assignment.hungarian_host(torch.from_numpy(cost))
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        want = np.asarray(jassignment.hungarian_host(jnp.asarray(cost)))
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(got.numpy(), assignment.hungarian(torch.from_numpy(cost)).numpy())
        n_scipy_differs += not np.array_equal(got.numpy(),
                                              assignment._scipy_solve(cost.astype(np.float64)))
    # the tables do exercise ties scipy breaks another way
    assert n_scipy_differs > 0


def test_hungarian_host_falls_back_to_scipy(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    for cost in _tied_tables(1, 8):
        got = assignment.hungarian_host(torch.from_numpy(cost)).numpy()
        assert np.array_equal(got, assignment._scipy_solve(cost.astype(np.float64)))


def _mbes_stream():
    from smarc_navigation_tpu_torch.io import logs

    streams, _ = logs.load_log(SAMPLE)
    s = streams["mbes"]
    ticks = T.make_ticks(0.0, 90.0, 10.0) + s["stamps"][0]
    return ticks, s["stamps"], s["values"], s["burst"]


@pytest.mark.parametrize("max_per_tick", [8, 2])   # 2 saturates: detections dropped
def test_native_binner_bitwise_the_python_loop(monkeypatch, max_per_tick):
    ticks, stamps, values, burst = _mbes_stream()
    stats_n, stats_p = {}, {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = T.make_event_channel(ticks, stamps, values, burst, max_per_tick, stats=stats_n)
        assert native.bin_events(stamps, values, burst, ticks, max_per_tick) is not None
        monkeypatch.setattr(native, "bin_events", lambda *a: None)
        want = T.make_event_channel(ticks, stamps, values, burst, max_per_tick, stats=stats_p)
    for f in ("value", "mask"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert stats_n == stats_p
    assert (stats_n["dropped"] > 0) == (max_per_tick == 2)


@pytest.mark.cuda
def test_hungarian_host_returns_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    for cost in _tied_tables(2, 6):
        c = torch.from_numpy(cost).to("cuda")
        got = assignment.hungarian_host(c)
        assert got.device == c.device and got.dtype == torch.int32
        assert np.array_equal(got.cpu().numpy(), native.jv_assign(cost))
