"""The GPS update's kernels K13 (``pf_kernels.gps_weights_call``) and K14
(behind ``resampling.systematic_counts``) against their plain versions.

On the CPU both wrappers take their plain versions, which are the order-
pinned torch code the JAX parity tests hold bit for bit, and launch
nothing; the kernel path still calls ``resampling.systematic_counts``
through the module, once per GPS update, so that an observer of that
attribute (the benchmark's check) sees every resample. The ``cuda`` tests
hold each kernel bitwise against its plain version on the card (the same
summation trees, every operation separately rounded), at the benchmark's
2^20 particles, at 2^14, at banks that do not tile by CDF_BLOCK (3000 and
10^6) and at fleets of banks, on healthy, degenerate, flat and non-finite
weights; past the sizes one block scans (more than 4096 rows or chunk
totals a bank, where the scans run across the grid); and a whole 2^20
mission against the same mission on the plain versions. They skip where
there is no card. This file imports no JAX.
"""

import math

import numpy as np
import pytest
import torch

from smarc_navigation_tpu_torch.configs import PFConfig
from smarc_navigation_tpu_torch.io import sim
from smarc_navigation_tpu_torch.models import particle_filter as P
from smarc_navigation_tpu_torch.ops import pf_kernels as K
from smarc_navigation_tpu_torch.ops import resampling as R


def _bank(n, seed, device="cpu", kind="healthy"):
    """A (6, n) bank around the origin: healthy, one particle at the fix
    and the rest far off (dominant), every particle at one point (equal), or
    healthy with inf and NaN positions (non-finite log-weights), or every
    particle NaN (every log-weight -inf)."""
    rng = np.random.default_rng(seed)
    p = rng.normal(0, 2.0, (6, n)).astype(np.float32)
    if kind == "dominant":
        p[0:3] += 400.0
        p[0:3, n // 3] = 0.0
    elif kind == "equal":
        p[0:3] = np.float32(0.7)
    elif kind == "nonfinite":
        p[0, :: 97] = np.inf
        p[1, 5:: 131] = np.nan
    elif kind == "all_nan":
        p[0] = np.nan
    return torch.from_numpy(p).to(device)


def _gps(device="cpu"):
    return torch.tensor([0.25, -0.4], dtype=torch.float32, device=device)


def _params(device="cpu", yaw=0.3):
    c, s = math.cos(yaw), math.sin(yaw)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return P.make_params(PFConfig(measurement_std=0.8), r_m2o=rot,
                         t_m2o=np.array([1.5, -2.0, 0.1]), device=device)


def _mission(duration_s):
    m = sim.simulate(sim.MissionSpec(duration_s=duration_s, gps_surface_z=-100.0, gps_std=0.3,
                                     dvl_std=0.02, seed=5))
    return P.pf_timeline(m)


# ---------------------------------------------------------------------------
# on the CPU: the plain versions, no launch, the counts through the module
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [3000, 4096])
def test_cpu_takes_the_plain_versions(n):
    parts, gps, params = _bank(n, 1), _gps(), _params()
    k13, k14 = K.gps_weights_call.launches, R.systematic_counts.launches
    w = K.gps_weights_call(parts, gps, params)
    assert torch.equal(w, K.gps_weights_call_reference(parts, gps, params))
    assert torch.equal(w, R.normalize_weights_det(K.fast_logw(parts, gps, params)))
    for u in (0.0, 1.0 - 2.0 ** -6, torch.tensor(0.3)):
        m = R.systematic_counts(w, u)
        assert torch.equal(m, R.systematic_counts_reference(w, u))
        assert m.dtype == torch.int32 and int(m[-1]) == n
    fleet = torch.stack([w, w.flip(0)])
    assert torch.equal(R.systematic_counts(fleet, torch.tensor([0.1, 0.9])),
                       R.systematic_counts_reference(fleet, torch.tensor([0.1, 0.9])))
    assert (K.gps_weights_call.launches, R.systematic_counts.launches) == (k13, k14)


def test_kernel_path_counts_every_update_through_the_module(monkeypatch):
    """``_update_resample_fast`` reaches the counts through the module
    attribute and the weights through ``pf_kernels``, once per GPS update,
    and the mission is bit for bit the one without the observers."""
    tl = _mission(4.0).to("cpu")
    upd = (tl.channels["gps"].fresh & (tl.channels["diving"].value[:, 0] < 0.5)).numpy()
    cfg = PFConfig(particle_count=2048)

    def run():
        return P.run_fast_segmented(tl, P.make_params(cfg, device="cpu"), cfg,
                                    generator=torch.Generator().manual_seed(3))

    plain = run()
    calls = {"counts": 0, "weights": 0}
    counts, weights = R.systematic_counts, K.gps_weights_call

    def seen_counts(w, u):
        calls["counts"] += 1
        return counts(w, u)

    def seen_weights(*a):
        calls["weights"] += 1
        return weights(*a)

    monkeypatch.setattr(R, "systematic_counts", seen_counts)
    monkeypatch.setattr(K, "gps_weights_call", seen_weights)
    got = run()
    assert int(upd.sum()) == 4 and calls == {"counts": 4, "weights": 4}
    assert torch.equal(got[0].particles, plain[0].particles)
    assert torch.equal(got[1]["mean"], plain[1]["mean"])


# ---------------------------------------------------------------------------
# on the card: each kernel bitwise its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _bitwise(a, b):
    """Equal bits, NaN payloads aside (the same positions NaN)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        na, nb = torch.isnan(a), torch.isnan(b)
        return torch.equal(na, nb) and torch.equal(a[~na].view(torch.int32),
                                                   b[~nb].view(torch.int32))
    return torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1 << 20, 1 << 14, 3000, 1_000_000])
@pytest.mark.parametrize("kind", ["healthy", "dominant", "equal", "nonfinite", "all_nan"])
def test_gps_weights_kernel_bitwise(cuda, n, kind):
    parts, gps, params = _bank(n, n % 89, cuda, kind), _gps(cuda), _params(cuda)
    before = K.gps_weights_call.launches
    got = K.gps_weights_call(parts, gps, params)
    torch.cuda.synchronize()
    assert K.gps_weights_call.launches == before + 1
    want = K.gps_weights_call_reference(parts, gps, params)
    assert _bitwise(got, want)
    if kind == "all_nan":
        assert bool(torch.isnan(got).all())
    else:
        assert bool(torch.isfinite(got).all())


def _weights(n, kind, device, seed=0):
    if kind == "spiky":
        rng = np.random.default_rng(seed)
        w = rng.random(n) ** 8
        w[rng.integers(0, n, 5)] = 50.0
        return torch.from_numpy((w / w.sum()).astype(np.float32)).to(device)
    return K.gps_weights_call_reference(_bank(n, seed, device, kind), _gps(device),
                                        _params(device))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1 << 20, 1 << 14, 3000, 1_000_000])
@pytest.mark.parametrize("kind", ["healthy", "dominant", "equal", "spiky", "all_nan"])
def test_systematic_counts_kernel_bitwise(cuda, n, kind):
    w = _weights(n, kind, cuda, seed=n % 31)
    for u in (0.0, 1.0 - 2.0 ** -6, 0.3, torch.tensor(0.55, device=cuda)):
        before = R.systematic_counts.launches
        got = R.systematic_counts(w, u)
        torch.cuda.synchronize()
        assert R.systematic_counts.launches == before + 1
        want = R.systematic_counts_reference(w, u)
        assert _bitwise(got, want), u
        if kind != "all_nan":
            assert int(got[-1]) == n and bool((got[1:] >= got[:-1]).all())
    g1 = torch.Generator(device=cuda).manual_seed(8)
    g2 = torch.Generator(device=cuda).manual_seed(8)
    assert _bitwise(R.systematic_counts(w, g1), R.systematic_counts_reference(w, g2))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1 << 14, 3000, 1024])
def test_systematic_counts_kernel_fleet_banks(cuda, n):
    """A (4, n) fleet: each bank its own, as the fleet PF path hands them
    (1024 particles a mission in the SLAM + PF fleet)."""
    w = torch.stack([_weights(n, k, cuda, seed=i)
                     for i, k in enumerate(("healthy", "dominant", "equal", "spiky"))])
    u = torch.tensor([0.0, 1.0 - 2.0 ** -6, 0.3, 0.77], device=cuda)
    got = R.systematic_counts(w, u)
    torch.cuda.synchronize()
    assert _bitwise(got, R.systematic_counts_reference(w, u))
    for b in range(4):
        assert _bitwise(got[b], R.systematic_counts_reference(w[b], u[b]))
    w3 = w.reshape(2, 2, n).contiguous()
    assert _bitwise(R.systematic_counts(w3, u.reshape(2, 2)),
                    R.systematic_counts_reference(w3, u.reshape(2, 2)))


@pytest.mark.cuda
def test_update_kernels_raise_on_what_they_do_not_take(cuda):
    n = 1 << 14
    parts, gps, params = _bank(n, 2, cuda), _gps(cuda), _params(cuda)
    with pytest.raises(TypeError, match="parts"):
        K.gps_weights_call(parts.double(), gps, params)
    with pytest.raises(ValueError, match="parts"):
        K.gps_weights_call(parts[:5].contiguous(), gps, params)
    with pytest.raises(ValueError, match="gps_map_xy"):
        K.gps_weights_call(parts, torch.zeros(3, device=cuda), params)
    with pytest.raises(TypeError, match="meas_var"):
        K.gps_weights_call(parts, gps, params._replace(meas_var=params.meas_var.double()))
    with pytest.raises(ValueError, match="r_m2o"):
        K.gps_weights_call(parts, gps, params._replace(r_m2o=params.r_m2o.cpu()))
    w = K.gps_weights_call(parts, gps, params)
    with pytest.raises(TypeError, match="weights"):
        R.systematic_counts(w.double(), 0.5)
    with pytest.raises(ValueError, match="uniforms"):
        R.systematic_counts(w, torch.zeros(2, device=cuda))
    # a strided view is taken as its contiguous copy
    view = torch.stack([w, w.flip(0)], 1)[:, 0]
    assert _bitwise(R.systematic_counts(view, 0.5), R.systematic_counts_reference(view, 0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4097 * 2048, 8_500_001])
def test_update_kernels_past_one_block(cuda, n):
    """Banks whose row or chunk totals pass what one block scans (4096): the
    scans and the running max across the grid, level by level; K13's fold
    of a bank that does not tile in three strided stages. Each bitwise its
    plain version."""
    parts, gps, params = _bank(n, 7, cuda), _gps(cuda), _params(cuda)
    w = K.gps_weights_call(parts, gps, params)
    assert _bitwise(w, K.gps_weights_call_reference(parts, gps, params))
    spiky = _weights(n, "spiky", cuda, seed=3)
    for weights in (w, spiky):
        for u in (0.0, 1.0 - 2.0 ** -6, 0.41):
            got = R.systematic_counts(weights, u)
            assert _bitwise(got, R.systematic_counts_reference(weights, u)), u
            assert int(got[-1]) == n and bool((got[1:] >= got[:-1]).all())


@pytest.mark.cuda
def test_mission_at_2_20_is_the_plain_path(cuda, monkeypatch):
    """``run_fast_segmented`` at the benchmark's 2^20 particles: bank, mean
    and cov bitwise the same mission with both wrappers replaced by their
    plain versions, one K13 and one K14 launch per GPS update."""
    tl = _mission(15.0).to(cuda)
    upd = (tl.channels["gps"].fresh & (tl.channels["diving"].value[:, 0] < 0.5)).cpu().numpy()
    cfg = PFConfig(particle_count=1 << 20)
    params = P.make_params(cfg, device=cuda)

    def run():
        return P.run_fast_segmented(tl, params, cfg,
                                    generator=torch.Generator(device=cuda).manual_seed(11))

    k13, k14 = K.gps_weights_call.launches, R.systematic_counts.launches
    got = run()
    torch.cuda.synchronize()
    assert int(upd.sum()) >= 10
    assert K.gps_weights_call.launches - k13 == int(upd.sum())
    assert R.systematic_counts.launches - k14 == int(upd.sum())
    # an observer of the counts that calls the kernel (as the benchmark's
    # check does) sees every update, and the mission is the same bits
    real, seen = R.systematic_counts, []
    monkeypatch.setattr(R, "systematic_counts", lambda w, u: seen.append(1) or real(w, u))
    observed = run()
    assert len(seen) == int(upd.sum()) and real.launches - k14 == 2 * int(upd.sum())
    assert _bitwise(observed[0].particles, got[0].particles)
    monkeypatch.setattr(K, "gps_weights_call", K.gps_weights_call_reference)
    monkeypatch.setattr(R, "systematic_counts", R.systematic_counts_reference)
    want = run()
    assert _bitwise(got[0].particles, want[0].particles)
    assert _bitwise(got[1]["mean"], want[1]["mean"]) and _bitwise(got[1]["cov"], want[1]["cov"])
