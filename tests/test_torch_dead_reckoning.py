"""Dead reckoning (``models/dead_reckoning.py``) and the scalar KF
(``ops/oned_kf.py``) against the JAX package's on the same missions.

The missions are ``tests/test_dead_reckoning.py``'s: 12 s at seed 9, and at
seed 10 with a DVL dropout from 4 to 7 s (the gating and the motion-model
fallback), the 30 s mission for the odometry provider; the timelines are
built by each package's own builder and held bitwise equal first.

Tolerances: the SAM chain's outputs within 1e-4 of JAX's tick loop, and the
port's tick loop against its closed form within 5e-4, the reference's own
bound for its pair (``jnp.cumsum``'s rounding is the backend's; observed
~4e-6). The odometry provider within 1e-4 (observed 4e-5 over 361 ticks
with a dropout). The scalar KF within 1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

from smarc_navigation_tpu_torch.io import sim
from smarc_navigation_tpu_torch.models import dead_reckoning as dr
from smarc_navigation_tpu_torch.ops import oned_kf

MISSIONS = {"seed9": dict(duration_s=12.0, seed=9),
            "dropout": dict(duration_s=12.0, seed=10, dvl_dropout=(4.0, 7.0))}


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from smarc_navigation_tpu.io import sim as jsim
    from smarc_navigation_tpu.models import dead_reckoning as jdr
    from smarc_navigation_tpu.ops import oned_kf as jkf

    return dict(jax=jax, jnp=jnp, sim=jsim, dr=jdr, kf=jkf)


def _flat(tl):
    d = {"ticks": np.asarray(tl.ticks)}
    for group in ("channels", "windows", "events"):
        for name, ch in getattr(tl, group).items():
            for f in dataclasses.fields(ch):
                d[f"{group}.{name}.{f.name}"] = np.asarray(getattr(ch, f.name))
    return d


def _both(jx, builder, **spec):
    """(the port's tensor timeline, the reference's) of one mission, after
    holding the two builders' arrays bitwise equal."""
    m = sim.simulate(sim.MissionSpec(**spec))
    jm = jx["sim"].simulate(jx["sim"].MissionSpec(**spec))
    tl, jtl = getattr(dr, builder)(m), getattr(jx["dr"], builder)(jm)
    a, b = _flat(tl), _flat(jtl)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    return tl.to("cpu"), jtl


@pytest.mark.parametrize("mission", list(MISSIONS))
def test_sam_dr_matches_jax(jx, mission):
    tl, jtl = _both(jx, "sam_timeline", **MISSIONS[mission])
    loop = dr.run_sam_dr(tl)
    closed = dr.run_sam_dr_vectorized(tl)
    want = np.asarray(jx["jax"].jit(jx["dr"].run_sam_dr)(jtl))
    assert loop.shape == closed.shape == want.shape == (tl.num_ticks, 9)
    np.testing.assert_allclose(loop.numpy(), want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(closed.numpy(), np.asarray(jx["dr"].run_sam_dr_vectorized(jtl)),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(closed.numpy(), loop.numpy(), rtol=0, atol=5e-4)


def test_sam_dr_fleet_is_each_mission():
    """A batched (B, T, ...) timeline through both forms: each mission's
    rows are its own replay."""
    from smarc_navigation_tpu_torch.parallel import fleet

    ms = [sim.simulate(sim.MissionSpec(duration_s=3.0, seed=s)) for s in (9, 11)]
    tls = [dr.sam_timeline(m) for m in ms]
    batched = fleet.batch_timelines(tls).to("cpu")
    closed, loop = dr.run_sam_dr_vectorized(batched), dr.run_sam_dr(batched)
    assert closed.shape == loop.shape == (2, tls[0].ticks.shape[0], 9)
    for b, tl in enumerate(tls):
        assert torch.equal(closed[b], dr.run_sam_dr_vectorized(tl.to("cpu")))
        assert torch.equal(loop[b], dr.run_sam_dr(tl.to("cpu")))


@pytest.mark.parametrize("mission", ["ideal", "dropout"])
def test_odom_provider_matches_jax(jx, mission):
    spec = (dict(duration_s=30.0) if mission == "ideal"
            else dict(duration_s=12.0, seed=10, dvl_dropout=(4.0, 7.0)))
    tl, jtl = _both(jx, "odom_timeline", **spec)
    init = np.asarray([1.0, -2.0, -0.5, 0.0, 0.0, 0.3], np.float32)
    r = np.asarray([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]], np.float32)
    got = dr.run_odom_provider(tl, init_pose=init, r_base_dvl=torch.as_tensor(r))
    want = jx["jax"].jit(lambda t: jx["dr"].run_odom_provider(
        t, init_pose=init, r_base_dvl=jx["jnp"].asarray(r)))(jtl)
    assert got.shape == (tl.num_ticks, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    # the default extrinsic and start
    np.testing.assert_allclose(dr.run_odom_provider(tl).numpy(),
                               np.asarray(jx["jax"].jit(jx["dr"].run_odom_provider)(jtl)),
                               rtol=0, atol=1e-4)


def test_oned_kf_matches_jax(jx):
    jnp, jkf = jx["jnp"], jx["kf"]
    rng = np.random.default_rng(3)
    zs = rng.normal(size=(20, 3)).astype(np.float32)
    state, path = oned_kf.smooth(torch.as_tensor(zs), 0.0, 1.0, 10.0, 20.0)
    jstate, jpath = jkf.smooth(jnp.asarray(zs), 0.0, 1.0, 10.0, 20.0)
    np.testing.assert_allclose(path.numpy(), np.asarray(jpath), rtol=0, atol=1e-6)
    np.testing.assert_allclose(state.sigma.numpy(), np.asarray(jstate.sigma), rtol=0, atol=1e-6)
    valid = np.asarray([True, False, True])
    got = oned_kf.masked_step(state, torch.as_tensor(zs[0]), 10.0, 20.0, torch.as_tensor(valid))
    want = jkf.masked_step(jstate, jnp.asarray(zs[0]), 10.0, 20.0, jnp.asarray(valid))
    np.testing.assert_allclose(got.mu.numpy(), np.asarray(want.mu), rtol=0, atol=1e-6)
    assert torch.equal(got.sigma[1], state.sigma[1])
    s0 = oned_kf.init(0.5, 2.0, device="cpu")
    assert float(s0.mu) == 0.5 and float(s0.sigma) == 2.0 and s0.mu.dtype == torch.float32
