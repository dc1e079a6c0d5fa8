"""The port's PF kernel paths (``run_fast``, ``run_fast_segmented``; the
kernels' plain versions on the CPU), mirroring ``tests/test_pf_fast.py``,
and held against the JAX package's ``run_fast``.

The port's generator is keyed per tick and particle, so the segmented and
the per-tick paths give bitwise equal banks here with the noise ON (the JAX
package can show that only with the noise off). Tolerances: the kernel paths
against the dense scan and against JAX ``run_fast``, with every std zero,
mean 2e-4 and cov 1e-4 (the JAX package's own bounds, ``test_pf_fast.py``:
its kernels use a sin polynomial with 1.9e-7 error; f32 sums in another
order); ``updated`` exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from smarc_navigation_tpu_torch.configs import PFConfig
from smarc_navigation_tpu_torch.io import sim
from smarc_navigation_tpu_torch.models import particle_filter as P

N = 2048


def _timeline(duration=15.0, seed=3):
    m = sim.simulate(sim.MissionSpec(duration_s=duration, seed=seed, gps_surface_z=-100.0))
    return P.pf_timeline(m, freq_hz=10.0).to("cpu"), m


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_fast_segmented_matches_fast_exactly_with_noise():
    tl, _m = _timeline()
    cfg = PFConfig(particle_count=N, init_cov=(4.0, 4.0, 0.0, 0.0, 0.0, 0.04),
                   motion_cov=(0.01, 0.01, 0.0, 0.0, 0.0, 1e-4),
                   res_noise_cov=(0.04, 0.04, 0.0, 0.0, 0.0, 1e-4))
    params = P.make_params(cfg, device="cpu")
    f1, o1 = P.run_fast(tl, params, cfg, generator=_gen(42))
    f2, o2 = P.run_fast_segmented(tl, params, cfg, generator=_gen(42), k_max=5)
    assert torch.equal(f1.particles, f2.particles)
    assert torch.equal(o1["mean"], o2["mean"]) and torch.equal(o1["cov"], o2["cov"])
    assert torch.equal(o1["updated"], o2["updated"]) and bool(o1["updated"].any())
    assert float(f1.t_prev) == float(f2.t_prev) == float(tl.ticks[-2])   # last odometry
    # the noise really is on: another seed gives another bank
    f3, _ = P.run_fast(tl, params, cfg, generator=_gen(43))
    assert not torch.equal(f1.particles, f3.particles)
    # the public entry points route to these paths
    _, o3 = P.run(tl, params, cfg, generator=_gen(42), scheme="systematic",
                  use_pallas=True, segmented=False)
    assert torch.equal(o3["mean"], o1["mean"])
    _, o4 = P.run(tl, params, cfg, generator=_gen(42), scheme="systematic", use_pallas=True)
    assert torch.equal(o4["mean"], o1["mean"])


def test_fast_paths_match_dense_scan_deterministic():
    tl, _m = _timeline()
    cfg = PFConfig(particle_count=N, init_cov=(0.0,) * 6, motion_cov=(0.0,) * 6,
                   res_noise_cov=(0.0,) * 6)
    params = P.make_params(cfg, device="cpu")
    _, dense = P.run(tl, params, cfg, scheme="systematic", use_pallas=False)
    _, fast = P.run_fast(tl, params, cfg)
    _, seg = P.run_fast_segmented(tl, params, cfg, k_max=7)
    for out in (fast, seg):
        np.testing.assert_allclose(dense["mean"].numpy(), out["mean"].numpy(), atol=2e-4)
        np.testing.assert_allclose(dense["cov"].numpy(), out["cov"].numpy(), atol=1e-4)
        np.testing.assert_array_equal(dense["updated"].numpy(), out["updated"].numpy())


def test_gps_updates_contract_the_bank():
    tl, m = _timeline(duration=20.0)
    cfg = PFConfig(particle_count=N, init_cov=(25.0, 25.0, 0.0, 0.0, 0.0, 1e-4),
                   motion_cov=(0.0, 0.0, 0.0, 0.0, 0.0, 1e-12),
                   res_noise_cov=(0.04, 0.04, 0.0, 0.0, 0.0, 1e-6))
    params = P.make_params(cfg, device="cpu")
    gt_end = m.gt_at(np.asarray([float(tl.ticks[-1])]))[0]
    for runner in (lambda t: P.run_fast(t, params, cfg, generator=_gen(0)),
                   lambda t: P.run_fast_segmented(t, params, cfg, generator=_gen(0), k_max=6)):
        _, out = runner(tl)
        assert bool(out["updated"].any())
        mean_end = out["mean"][-1].numpy()
        assert np.linalg.norm(mean_end[0:2] - gt_end[0:2]) < 1.5
        cov_end = out["cov"][-1].numpy()
        assert cov_end[0, 0] < 2.0 and cov_end[1, 1] < 2.0       # from 25.0

    # control: diving the whole mission disables updates; the spread stays
    dive = tl.channels["diving"]
    tl_dive = dataclasses.replace(tl, channels={
        **tl.channels, "diving": dataclasses.replace(dive, value=torch.ones_like(dive.value))})
    _, out_d = P.run_fast(tl_dive, params, cfg, generator=_gen(0))
    assert not bool(out_d["updated"].any())
    cov_d = out_d["cov"][-1].numpy()
    assert cov_d[0, 0] > 10.0 and cov_d[1, 1] > 10.0


def test_update_tick_moments_are_post_resample():
    tl, _m = _timeline()
    cfg = PFConfig(particle_count=N, init_cov=(16.0, 16.0, 0.0, 0.0, 0.0, 1e-4),
                   motion_cov=(0.0,) * 6, res_noise_cov=(0.0,) * 6)
    params = P.make_params(cfg, device="cpu")
    _, o_fast = P.run_fast(tl, params, cfg, generator=_gen(5))
    _, o_seg = P.run_fast_segmented(tl, params, cfg, generator=_gen(5), k_max=9)
    ts = np.nonzero(o_fast["updated"].numpy())[0]
    assert len(ts)
    np.testing.assert_allclose(o_fast["mean"].numpy()[ts], o_seg["mean"].numpy()[ts], atol=1e-5)
    t0 = ts[0]
    assert t0 > 0
    pre = o_seg["mean"].numpy()[t0 - 1][0:2]
    post = o_seg["mean"].numpy()[t0][0:2]
    assert np.linalg.norm(post - pre) > 1e-3


def test_run_fast_matches_jax_zero_stds():
    import jax
    from jax.experimental.pallas import tpu as pltpu

    from smarc_navigation_tpu.io import sim as jsim
    from smarc_navigation_tpu.models import particle_filter as JP

    spec = dict(duration_s=15.0, seed=3, gps_surface_z=-100.0)
    jtl = JP.pf_timeline(jsim.simulate(jsim.MissionSpec(**spec)), freq_hz=10.0)
    tl = P.pf_timeline(sim.simulate(sim.MissionSpec(**spec)), freq_hz=10.0).to("cpu")
    cfg = PFConfig(particle_count=N, init_cov=(0.0,) * 6, motion_cov=(0.0,) * 6,
                   res_noise_cov=(0.0,) * 6)
    with pltpu.force_tpu_interpret_mode():
        _, jout = JP.run_fast(jtl, JP.make_params(cfg), cfg, key=jax.random.PRNGKey(7))
        jout = {k: np.asarray(v) for k, v in jout.items()}
    params = P.make_params(cfg, device="cpu")
    for runner in (P.run_fast, P.run_fast_segmented):
        _, out = runner(tl, params, cfg)
        np.testing.assert_allclose(out["mean"].numpy(), jout["mean"], atol=2e-4)
        np.testing.assert_allclose(out["cov"].numpy(), jout["cov"], atol=1e-4)
        np.testing.assert_array_equal(out["updated"].numpy(), jout["updated"])
