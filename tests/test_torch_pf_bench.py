"""The port's particle-filter kernel path (``run_fast_segmented``, the
kernels' plain versions on the CPU) against the benchmark's float64
reference (``navbench/reference/pf_mission.py``) under the ``pf-1M.gps1hz``
cell's own limits, at 2^12 particles over the cell's first 61 ticks (six
GPS updates); the reference's restated generator against the port's; the
control (the reference with its bank and weights in float16) failing; and
each planted fault failing at least one number.

The reference breaks near ties of each resample as the program's counts
did (``tie(n)``), so the two banks hold the same particles and the cell's
numbers are absolute (``navbench/compare/pf.py``): the cell's limits hold
at this size too.
"""

import pytest
import torch

from navbench import check, manifest, port
from navbench.compare import pf as compare
from navbench.drivers import pf_replay
from navbench.reference import pf_mission
from navbench.traffic import generate

from smarc_navigation_tpu_torch.models import particle_filter as P
from smarc_navigation_tpu_torch.ops import pf_kernels, resampling

N, T = 4096, 61
CELL = "pf-1M.gps1hz"
CONFIG = manifest.config("pf-1M")
LIMITS = manifest.workload(CELL)["limits"]
SEEDS = (3, 2**31 + 19)


def _mission(seed: int) -> dict:
    mix = manifest.mix("gps1hz")
    tl = generate.generator("pf_mission").pf_mission_timeline(
        mix["duration_s"], seed, mix["mission"], mix["odom_hz"])
    return dict(ticks=tl["ticks"][:T], dt=tl["dt"], events={},
                channels={n: {k: v[:T] for k, v in c.items()} for n, c in tl["channels"].items()})


def _judged(mission: dict, seed: int) -> tuple:
    """(the program's numbers, the reference's near ties), as the cell's
    ``judge`` reads a kept replay."""
    cfg = pf_replay._pf_config(CONFIG, N)
    params = P.make_params(cfg, device="cpu")
    (fin, out), counts = pf_replay.counted(lambda: P.run(
        port.timeline(mission).to("cpu"), params, cfg,
        generator=torch.Generator().manual_seed(seed), scheme="systematic", use_pallas=True))
    ref = pf_mission.replay(mission, CONFIG, N, torch.Generator().manual_seed(seed),
                            counts=counts)
    prog = dict(mean=out["mean"].numpy(), cov=out["cov"].numpy(), bank=fin.particles.numpy(),
                resamples=len(counts))
    assert int(ref["updated"].sum()) == 6
    return compare.numbers(prog, ref), ref["ties"]


@pytest.fixture(scope="module", params=SEEDS)
def case(request):
    return request.param, _mission(request.param)


def test_program_is_correct_under_the_cells_limits(case):
    seed, m = case
    nums, ties = _judged(m, seed)
    assert set(nums) == set(LIMITS) and check.verdict(nums, LIMITS), nums
    # every ancestor that rounding moved lies within the tie, with room
    assert ties["refused"] == 0 and ties["gap"] < pf_mission.tie(N) / 4, ties


def test_restated_ancestors_are_the_ports():
    """The reference's reading of a count vector is the port's gather's
    (slot j takes the smallest i with m_cum[i] > j), and its own counts
    invert it."""
    g = torch.Generator().manual_seed(5)
    w = torch.rand(N, generator=g) ** 8
    w[100:200] = 0.0
    m_cum = resampling.systematic_counts(w / w.sum(), 0.37)
    anc = pf_mission.ancestors_of(m_cum)
    assert torch.equal(anc, resampling._expand_blocks(m_cum).long())
    assert torch.equal(pf_mission.counts_of(anc), m_cum)


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 2])
@pytest.mark.parametrize("draw", [0, 1, 2, 3])
def test_restated_generator_is_the_ports(seed, draw):
    idx = torch.cat([torch.arange(4096), torch.tensor([2**20 - 1, 2**24 + 5, 2**31 - 1])])
    got = pf_mission.uniform(seed, idx, draw)
    want = pf_kernels.uniforms(torch.tensor(seed, dtype=torch.int32), idx, draw)
    assert torch.equal(got, want.to(torch.float64))
    # Box-Muller: the port's float32 log, sqrt and cos/sin against float64
    # on the same exact uniforms: |n| < 5.8 here, each float32 step within an
    # ulp or two (~6e-8 relative), so 4e-6 absolute holds with room
    if draw % 2 == 0:
        c, s = pf_mission.normal_pair(seed, idx, draw)
        pc, ps = pf_kernels.normal_pair(torch.tensor(seed, dtype=torch.int32), idx, draw)
        assert (c - pc.double()).abs().max() < 4e-6 and (s - ps.double()).abs().max() < 4e-6


def test_control_is_not_correct(case):
    seed, m = case
    nums = compare.control(m, CONFIG, N, lambda: torch.Generator().manual_seed(seed))
    assert not check.verdict(nums, LIMITS), nums


def _drop_first_update(mp):
    real, calls = P._update_resample_fast, [0]

    def upd(parts, *a):
        calls[0] += 1
        return (parts, pf_kernels.moment_sums(parts)) if calls[0] == 1 else real(parts, *a)
    mp.setattr(P, "_update_resample_fast", upd)


def _drop_fifth_update(mp):
    real, calls = P._update_resample_fast, [0]

    def upd(parts, *a):
        calls[0] += 1
        return (parts, pf_kernels.moment_sums(parts)) if calls[0] == 5 else real(parts, *a)
    mp.setattr(P, "_update_resample_fast", upd)


def _no_jitter(mp):
    mp.setattr(P, "_jitter_sd", lambda params: torch.zeros(3))


def _uniform_replaced(mp):
    real = resampling.systematic_counts
    mp.setattr(resampling, "systematic_counts",
               lambda w, u: real(w, (torch.as_tensor(u) + 0.5) % 1.0))


def _third_update_unresampled(mp):
    real, calls = resampling.systematic_counts, [0]

    def counts(w, u):
        calls[0] += 1
        if calls[0] == 3:
            return torch.arange(1, w.shape[-1] + 1, dtype=torch.int32)
        return real(w, u)
    mp.setattr(resampling, "systematic_counts", counts)


@pytest.mark.parametrize("plant", [_drop_first_update, _no_jitter, _uniform_replaced,
                                   _third_update_unresampled, _drop_fifth_update],
                         ids=lambda f: f.__name__[1:])
def test_planted_fault_is_not_correct(case, plant, monkeypatch):
    seed, m = case
    plant(monkeypatch)
    nums, _ = _judged(m, seed)
    assert not check.verdict(nums, LIMITS), nums
