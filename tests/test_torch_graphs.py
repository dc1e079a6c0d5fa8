"""The cached CUDA graphs of the fleet tick loops (``utils/graphs.py``).

On the CPU (tier-1): one tick of each graphed loop (the SLAM fleet in both
covariance semantics, the localization fleet, the 15-state fleet in both
wirings of the dual replay, the closed-loop raycast fleet, the SLAM + PF
fleet in both PF schemes) runs under a
dispatch mode that records every ATen call, with the kernel entry points
replaced by shape-correct stubs (the plain versions never run under a
capture). No call may sync with the
host (``.item()``, ``bool(t)``, ``nonzero``) or build a tensor from host
data (``lift_fresh``, a copy between devices): either one fails a CUDA
graph capture on the card. The guard is itself held to flag each of those.

On the card (``cuda``): each of the five graphed entry points against its
eager loop (``graph=False``), bitwise, on a capture and on a cache hit with
new inputs and parameters; another configuration misses the cache; the
launch counts per call; a host sync in a tick body makes the capture raise.
This file imports no JAX, so the card runs it with ``--noconftest``.
"""

import dataclasses
import warnings

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from smarc_navigation_tpu_torch.configs import EKFLocConfig
from smarc_navigation_tpu_torch.io import sim
from smarc_navigation_tpu_torch.io.workloads import (
    combined_slam_cfg, slam_fleet_timelines, slam_mission_timeline)
from smarc_navigation_tpu_torch.models import ekf_15state as e15
from smarc_navigation_tpu_torch.models import ekf_localization as loc
from smarc_navigation_tpu_torch.models import ekf_slam as S
from smarc_navigation_tpu_torch.ops import ekf15_kernels as k10
from smarc_navigation_tpu_torch.ops import loc_kernels as k9
from smarc_navigation_tpu_torch.ops import slam_da_kernels as k1
from smarc_navigation_tpu_torch.ops import slam_kernels as k2
from smarc_navigation_tpu_torch.parallel import fleet
from smarc_navigation_tpu_torch.utils import graphs

# ---------------------------------------------------------------------------
# the capture guard
# ---------------------------------------------------------------------------

_SYNCS = {"aten._local_scalar_dense.default", "aten.item.default", "aten.is_nonzero.default",
          "aten.nonzero.default", "aten.equal.default", "aten.masked_select.default",
          "aten._unique2.default", "aten.unique_consecutive.default"}
_HOST_DATA = {"aten.lift_fresh.default", "aten.lift_fresh_copy.default"}


class CaptureGuard(TorchDispatchMode):
    """Records every ATen call that a CUDA graph capture refuses: a host
    sync, a tensor built from host data, a copy between devices, an index
    by a boolean mask (a hidden ``nonzero``)."""

    def __init__(self):
        super().__init__()
        self.bad = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func)
        if name in _SYNCS or name in _HOST_DATA:
            self.bad.append(name)
        elif name == "aten._to_copy.default":
            dev = kwargs.get("device")
            if dev is not None and torch.device(dev) != args[0].device:
                self.bad.append(f"{name} {args[0].device} -> {dev}")
        elif name.startswith("aten.copy_") and args[0].device != args[1].device:
            self.bad.append(f"{name} {args[1].device} -> {args[0].device}")
        elif name.startswith(("aten.index.", "aten.index_put")):
            idx = args[1] if len(args) > 1 else ()
            if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in idx):
                self.bad.append(f"{name} with a boolean mask")
        return func(*args, **kwargs)


_HOST_CASES = {
    "tensor from a tuple": lambda x: x + torch.tensor((1.0, 2.0, 3.0)),
    "list index": lambda x: x.index_fill(0, torch.tensor([0, 2]), 1.0),
    "list index assignment": lambda x: x.clone().__setitem__([0, 2], 1.0),
    "item": lambda x: x.sum().item(),
    "bool of a tensor": lambda x: bool((x > 0).any()),
    "nonzero": lambda x: x.nonzero(),
    "mask index": lambda x: x[x > 0],
    "device copy": lambda x: x.to("meta"),
}


@pytest.mark.parametrize("case", list(_HOST_CASES))
def test_capture_guard_flags_what_a_capture_refuses(case):
    x = torch.arange(3, dtype=torch.float32)
    with CaptureGuard() as g:
        _HOST_CASES[case](x)
    assert g.bad, f"{case}: not flagged"


def test_capture_guard_passes_device_side_work():
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    with CaptureGuard() as g:
        c = torch.zeros((8, 16))
        c.diagonal()[0:3].fill_(1.0)
        c[0:2, 8:11] = x
        y = torch.where(x > 1, x, torch.zeros_like(x)).sum(1)
        torch.stack([y, torch.eye(2)[0]]).contiguous()
    assert g.bad == []


# ---------------------------------------------------------------------------
# one tick of each graphed loop under the guard (kernels stubbed)
# ---------------------------------------------------------------------------

def _da_stub(pose6, n_active, active, lm_pos, Sigma, z, z_mask, q_diag, lam, outlier,
             mh_dist, new_lm_cov, sensor="mbes", r_sb=None, t_sb=None, **_):
    """K1's wrapper without its launch: the parameter block it packs on the
    device, then outputs of the kernel's shapes."""
    B, M = z.shape[0], z.shape[1]
    dim = 2 if sensor == "fls" else 3
    k1._params_vec(q_diag, lam, outlier, mh_dist, new_lm_cov, r_sb, t_sb, dim, z.device)
    i32, f32 = torch.int32, torch.float32
    return (torch.zeros((B, M), dtype=i32), torch.zeros((B, M, dim, 9), dtype=f32),
            torch.zeros((B, M, dim, 9), dtype=f32), torch.zeros((B, M, dim), dtype=f32),
            torch.zeros((B, M, 3), dtype=f32), torch.zeros((B, M), dtype=torch.bool),
            torch.zeros((B, M), dtype=torch.bool), torch.zeros((B, M), dtype=i32))


def _k2_stub(Sigma, mu, *args, band=None, **kw):
    band = args[9] if len(args) > 9 else band
    out = (torch.empty_like(Sigma), torch.empty_like(mu))
    return out + (torch.empty_like(band),) if band is not None else out


def _k4_stub(P, mu, H_sel, SinvH, nu_sel, lm_ix, do, add, new_lm_cov, cand, band, a8=None):
    return torch.empty_like(P), torch.empty_like(mu), torch.empty_like(band)


def _slam_inputs(sensors):
    cfg = dataclasses.replace(combined_slam_cfg(), max_landmarks=6, max_obs=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tl = slam_fleet_timelines(cfg, 0.3, 2)
    if "fls" in sensors:
        tl.events["fls"] = tl.events["mbes"]
    tl = tl.map(lambda x: x[:, :1]).to("cpu")
    return cfg, S._loop_inputs(tl, S.make_params(cfg, device="cpu"), cfg)


def _loc_fleet(cfg):
    """A two-mission localization timeline, and the map."""
    m = sim.simulate(sim.MissionSpec(duration_s=0.3, seed=7))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fleet.batch_timelines([loc.loc_timeline(m, cfg)] * 2), m.landmarks


def _e15_fleet(cfg):
    """A two-mission 15-state timeline (GPS included)."""
    m = sim.simulate(sim.MissionSpec(duration_s=0.3, seed=5))
    return fleet.batch_timelines([e15.ekf15_timeline(m, cfg, include_gps=True)] * 2)


LOOPS = ["slam_full-mbes", "slam_full-mbes+fls", "slam_marginal-mbes",
         "slam_marginal-mbes+fls", "loc", "ekf15-local", "ekf15-global", "raycast",
         "slam_pf-residual", "slam_pf-systematic"]


def _raycast_tick():
    """One tick of the raycast fleet's loop (two missions, rocks in view)."""
    from smarc_navigation_tpu_torch.ops.raycast import MBESSpec

    cfg = dataclasses.replace(combined_slam_cfg(), max_landmarks=6, max_obs=3)
    spec = MBESSpec(num_beams=16, floor_z=-16.0, rock_radius=1.2, swath_rad=2.4, max_range=40.0)
    gt = torch.zeros(2, 1, 6)
    lms = torch.tensor([[0.0, 1.0, -10.0], [0.0, -3.0, -12.0]]).expand(2, 2, 3)
    inp = fleet._raycast_inputs(gt, lms, torch.ones(2, 2, dtype=torch.bool), cfg,
                                S.make_params(cfg, device="cpu"), spec)
    return lambda: fleet._raycast_loop(inp, cfg, spec)


def _slam_pf_tick(scheme):
    """One tick of the SLAM + PF fleet's loop (two missions, a detection, a
    GPS fix)."""
    import numpy as np

    from smarc_navigation_tpu_torch.configs import PFConfig
    from smarc_navigation_tpu_torch.models import particle_filter as pf
    from smarc_navigation_tpu_torch.ops.timeline import build_timeline

    cfg = dataclasses.replace(combined_slam_cfg(), max_landmarks=6, max_obs=3)
    stamps = np.arange(1, 3) / cfg.system_freq
    odom13 = np.zeros((2, 13))
    odom13[:, 6] = 1.0
    raw = dict(t0=0.0, t1=2 / cfg.system_freq, freq_hz=cfg.system_freq,
               channels={"odom": (stamps, odom13), "gps": (stamps, odom13[:, :2]),
                         "diving": (stamps, np.zeros((2, 1)))},
               events={"mbes": (stamps[:1], np.ones((1, 3)), np.arange(1), cfg.max_obs)})
    tl = fleet.batch_timelines([build_timeline(**raw)] * 2).to("cpu").map(lambda x: x[:, :1])
    pp = pf.make_params(PFConfig(particle_count=16), device="cpu")
    inp, names = fleet._fleet_inputs(tl, cfg, S.make_params(cfg, device="cpu"), pp,
                                     pf.fleet_init(2, 16, pp))
    return lambda: fleet._fleet_loop(inp, cfg, names, scheme)


@pytest.mark.parametrize("loop", LOOPS)
def test_tick_body_is_capture_safe(loop, monkeypatch):
    """The prologue, one tick and the epilogue of each graphed loop, as the
    capture runs them on the card, with nothing a capture refuses."""
    if loop == "raycast":
        monkeypatch.setattr(k1, "da_lanes", _da_stub)
        monkeypatch.setattr(k2, "sequential_update_fleet", _k2_stub)
        run = _raycast_tick()
    elif loop.startswith("slam_pf"):
        monkeypatch.setattr(k1, "da_lanes", _da_stub)
        monkeypatch.setattr(k2, "sequential_update_fleet", _k2_stub)
        run = _slam_pf_tick(loop.split("-")[1])
    elif loop.startswith("slam"):
        monkeypatch.setattr(k1, "da_lanes", _da_stub)
        monkeypatch.setattr(k2, "sequential_update_fleet", _k2_stub)
        monkeypatch.setattr(k2, "sequential_update_marginal_fleet", _k4_stub)
        cfg, (inp, names) = _slam_inputs(loop.split("-")[1])
        assert len(names) == loop.count("+") + 1 and inp["valid"].shape[0] == 1
        body = S._full_loop if loop.startswith("slam_full") else S._marginal_loop
        run = (lambda: body(inp, cfg, names))
    elif loop == "loc":
        cfg = EKFLocConfig()
        tl, lms = _loc_fleet(cfg)
        tick_t, z_t, map4, par, _ = loc.stage_fleet(tl.to("cpu"), loc.make_params(
            lms, cfg, device="cpu"), cfg)
        s0 = loc.init_state(cfg, device="cpu")
        inp = dict(mu0=s0.mu.expand(2, 6).contiguous(),
                   sig0=s0.Sigma.reshape(36).expand(2, 36).contiguous(),
                   tick=tick_t[:1].contiguous(), z=z_t[:1].contiguous(), map4=map4, par=par)
        monkeypatch.setattr(k9, "_run_kernel", lambda *a: None)
        run = (lambda: k9._kernel_ticks(inp))
    else:
        cfg = (e15.Ekf15Config(frequency=50.0) if loop.endswith("local")
               else e15.global_config(50.0))
        tick_t, w = k10.stage_ticks15(_e15_fleet(cfg).to("cpu"), cfg)
        s0 = e15.init_state(cfg, device="cpu")
        inp = dict(x0=s0.x.expand(2, 15).contiguous(), P0=s0.P.expand(2, 15, 15).contiguous(),
                   tick=tick_t[:1].contiguous())
        monkeypatch.setattr(k10, "_run_kernel", lambda *a: None)
        run = (lambda: k10._kernel_ticks15(inp, w))
    with CaptureGuard() as g:
        run()
    assert g.bad == [], f"{loop}: a CUDA graph capture refuses {g.bad}"


def test_graphs_run_takes_cuda_tensors_only():
    with pytest.raises(ValueError, match="CUDA tensors"):
        graphs.run("k", lambda x: x, {"a": torch.zeros(2)})


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _same(a, b) -> bool:
    """Bitwise equality of two tensors (NaNs included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))
    return torch.equal(a, b)


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _leaves(x[k])]
    return [t for v in x for t in _leaves(v)]


def _assert_same(got, want, what):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        assert _same(a, b), f"{what}: leaf {i} differs between the graphed and the eager loop"


SLAM_CFG = dataclasses.replace(combined_slam_cfg(), max_landmarks=12, max_obs=4)
SLAM_CFG_256 = dataclasses.replace(SLAM_CFG, max_landmarks=180)   # D = 546: K2 streamed
CFG_L, CFG_G = e15.Ekf15Config(frequency=50.0), e15.global_config(50.0)
LOC_SPEC = dict(num_landmarks=16, dvl_std=0.05, mbes_std=0.05, landmark_area_m=20.0,
                mbes_range_m=30.0)


def _card_case(entry, seed):
    """(call(graph) -> result, counters, launches per call) of one entry
    point on a small fleet made from ``seed``."""
    T = 31
    if entry.startswith("slam"):
        cfg = SLAM_CFG_256 if entry == "slam_streamed" else SLAM_CFG
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            tls = [slam_mission_timeline(cfg, 3.0, seed + b)
                   for b in range(4)]
        tl = fleet.batch_timelines(tls).to("cuda")
        params = S.make_params(dataclasses.replace(cfg, r_diag=(1e-3 * (1 + seed % 3),) * 6),
                               device="cuda")
        mode = "marginal" if entry == "slam_marginal" else "auto"
        counters = ([k1.da_lanes, k2.sequential_update_marginal_fleet] if mode == "marginal"
                    else [k1.da_lanes, k2.sequential_update_fleet])
        if entry == "slam_streamed":
            counters.append(k2.symmetric_downdate)
        return (lambda graph: S.run_fleet(tl, params, cfg, update_mode=mode, graph=graph),
                counters, tl.ticks.shape[1])
    if entry == "loc":
        cfg = EKFLocConfig()
        ms = [sim.simulate(sim.MissionSpec(duration_s=0.6, seed=seed + s, **LOC_SPEC))
              for s in range(4)]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            tl = fleet.batch_timelines([loc.loc_timeline(m, cfg) for m in ms]).to("cuda")
        params = loc.make_params(ms[seed % 4].landmarks, cfg, device="cuda")
        return (lambda graph: loc.run_fleet(tl, params, cfg, graph=graph), [k9.fleet_tick],
                tl.ticks.shape[1])
    ms = [sim.simulate(sim.MissionSpec(duration_s=(T - 1) / CFG_L.frequency, seed=seed + s))
          for s in range(4)]
    tl = fleet.batch_timelines([e15.ekf15_timeline(m, CFG_L, include_gps=True)
                                for m in ms]).to("cuda")
    if entry == "ekf15":
        return (lambda graph: e15.run_fleet(tl, CFG_L, graph=graph), [k10.fleet15_tick],
                tl.ticks.shape[1])
    return (lambda graph: e15.run_dual_fleet(tl, tl, CFG_L, CFG_G, graph=graph),
            [k10.fleet15_tick], 2 * tl.ticks.shape[1])


ENTRIES = ["slam_full", "slam_streamed", "slam_marginal", "loc", "ekf15", "ekf15_dual"]


def _counted_call(fn, counters):
    before = [f.launches for f in counters]
    out = fn()
    torch.cuda.synchronize()
    return out, [f.launches - n for f, n in zip(counters, before)]


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ENTRIES)
def test_graphed_loop_is_the_eager_loop_on_card(entry):
    """A capture, then a cache hit on another timeline of the same shape
    with other parameters: each call bitwise its own eager replay, each
    counting its launches once per tick."""
    _need_cuda()
    graphs.clear()
    call, counters, n = _card_case(entry, 0)
    eager, n_eager = _counted_call(lambda: call(False), counters)
    assert n_eager == [n] * len(counters)
    first, n_first = _counted_call(lambda: call(True), counters)
    _assert_same(first, eager, f"{entry} capture")
    assert n_first == [n] * len(counters) and graphs.size() >= 1
    size = graphs.size()
    again, n_again = _counted_call(lambda: call(True), counters)
    _assert_same(again, eager, f"{entry} replay")
    assert n_again == [n] * len(counters) and graphs.size() == size

    call2, _, _ = _card_case(entry, 5)
    eager2 = call2(False)
    hit, n_hit = _counted_call(lambda: call2(True), counters)
    assert graphs.size() == size, f"{entry}: another timeline of the same shape missed the cache"
    _assert_same(hit, eager2, f"{entry} cache hit on new inputs")
    assert n_hit == [n] * len(counters)
    _assert_same(again, eager, f"{entry} first result after the second call")
    graphs.clear()


@pytest.mark.cuda
def test_other_cfg_misses_the_cache_on_card():
    _need_cuda()
    graphs.clear()
    call, _, _ = _card_case("slam_full", 0)
    call(True)
    assert graphs.size() == 1
    cfg2 = dataclasses.replace(SLAM_CFG, mhl_dist_mbes=0.5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tl = fleet.batch_timelines([slam_mission_timeline(cfg2, 3.0, b)
                                     for b in range(4)]).to("cuda")
    params = S.make_params(cfg2, device="cuda")
    got = S.run_fleet(tl, params, cfg2)
    assert graphs.size() == 2
    _assert_same(got, S.run_fleet(tl, params, cfg2, graph=False), "other cfg")
    graphs.clear()


@pytest.mark.cuda
def test_host_sync_in_a_tick_body_makes_the_capture_raise_on_card(monkeypatch):
    """No fallback: the capture's error reaches the caller, nothing is
    cached, and the count keeps only the warm-up's real launches."""
    _need_cuda()
    graphs.clear()
    call, counters, n = _card_case("loc", 0)
    real = k9._run_kernel

    def syncing(*args):
        real(*args)
        torch.zeros(1, device="cuda").item()

    monkeypatch.setattr(k9, "_run_kernel", syncing)
    before = k9.fleet_tick.launches
    with pytest.raises(RuntimeError):
        call(True)
    assert graphs.size() == 0
    assert k9.fleet_tick.launches - before == n
