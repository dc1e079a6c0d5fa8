"""The port's dense particle filter (``models/particle_filter.py``, the
plain-torch path) against the JAX package's, on the same inputs: particles
and noise made with numpy or drawn from the JAX keys and handed to both.

Tolerances and why: single steps agree to 1e-5 (absolute, metres and
radians): the two frameworks' f32 sin/cos/atan2 differ by an ulp. Whole
replays with every std zero (every particle on the one reference track)
agree to 2e-4 in the mean and 1e-4 in the covariance, the bounds the JAX
package's own fast-vs-dense test uses; ``updated`` is exact. Resample
ancestors fed the same uniforms are exact up to a stratum-boundary flip
(the CDF's cumsum rounds in a backend-specific order).
"""

import dataclasses

import numpy as np
import pytest
import torch

from smarc_navigation_tpu_torch.configs import PFConfig
from smarc_navigation_tpu_torch.convert import pf_params_from_numpy, pf_state_from_numpy
from smarc_navigation_tpu_torch.io import sim
from smarc_navigation_tpu_torch.models import particle_filter as P

N = 2048
ATOL = 1e-5


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from smarc_navigation_tpu.io import sim as jsim
    from smarc_navigation_tpu.models import particle_filter as JP

    return jax, jnp, JP, jsim


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _odom(seed):
    rng = np.random.default_rng(seed)
    rpy = rng.normal(0, [0.1, 0.1, 1.0])
    from smarc_navigation_tpu_torch.utils.geometry import quat_from_rpy_np

    return np.concatenate([rng.normal(0, 5, 3), quat_from_rpy_np(rpy),
                           rng.normal(0, 1, 3), rng.normal(0, 0.1, 3)]).astype(np.float32)


def _bank(seed, n=N):
    rng = np.random.default_rng(seed)
    p = rng.normal(0, 2.0, (6, n)).astype(np.float32)
    p[5] = rng.uniform(-3.1, 3.1, n)
    return p


def _jparams(jx, cfg):
    _, _, JP, _ = jx
    jp = JP.make_params(cfg)
    return jp, pf_params_from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()}, "cpu")


def test_motion_model_batch_and_single(jx):
    jax, jnp, JP, _ = jx
    parts, odom = _bank(1), _odom(2)
    noise = (np.random.default_rng(3).normal(0, 0.1, (6, N))).astype(np.float32)
    want = np.asarray(JP.motion_model_batch(jnp.asarray(parts), jnp.asarray(odom),
                                            0.1, jnp.asarray(noise)))
    got = P.motion_model_batch(_t(parts), _t(odom), 0.1, _t(noise)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    one = JP.motion_model(jnp.asarray(parts[:, 5]), jnp.asarray(odom), 0.1,
                          jnp.asarray(noise[:, 5]))
    np.testing.assert_allclose(
        P.motion_model(_t(parts[:, 5]), _t(odom), 0.1, _t(noise[:, 5])).numpy(),
        np.asarray(one), atol=ATOL)


def test_predict_with_fed_noise(jx):
    jax, jnp, JP, _ = jx
    cfg = PFConfig(particle_count=N, motion_cov=(0.04, 0.09, 0, 0, 0, 1e-3))
    jp, tp = _jparams(jx, cfg)
    parts, odom = _bank(4), _odom(5)
    key = jax.random.PRNGKey(8)
    jstate = JP.PFState(particles=jnp.asarray(parts), key=key, t_prev=jnp.float32(0))
    want = JP.predict(jstate, jnp.asarray(odom), 0.1, jp)
    _, sub = jax.random.split(key)
    n3 = np.asarray(jax.random.normal(sub, (3, N), jnp.float32))
    st = pf_state_from_numpy({"particles": parts, "t_prev": np.float32(0)}, "cpu")
    got = P.predict(st, _t(odom), 0.1, tp, n3=_t(n3))
    np.testing.assert_allclose(got.particles.numpy(), np.asarray(want.particles), atol=ATOL)


def test_gps_weights_and_estimate(jx):
    jax, jnp, JP, _ = jx
    r = np.asarray([[0.6, -0.8, 0], [0.8, 0.6, 0], [0, 0, 1]], np.float32)
    cfg = PFConfig(particle_count=N, measurement_std=1.5)
    jp = JP.make_params(cfg, r_m2o=r, t_m2o=np.asarray([1.0, -2.0, 0.5]))
    tp = P.make_params(cfg, r_m2o=r, t_m2o=np.asarray([1.0, -2.0, 0.5]), device="cpu")
    parts = _bank(6)
    parts[0, 3] = np.nan                    # a broken particle gets zero weight
    gps = np.asarray([0.7, -1.1], np.float32)
    want = np.asarray(JP._gps_weights(jnp.asarray(parts), jnp.asarray(gps), jp))
    got = P._gps_weights(_t(parts), _t(gps), tp).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)
    assert got[3] < 1e-30 and abs(got.sum() - 1.0) < 1e-5   # only the 1e-30 floor
    parts = _bank(7)
    m, c = JP.estimate(jnp.asarray(parts))
    tm, tc = P.estimate(_t(parts))
    np.testing.assert_allclose(tm.numpy(), np.asarray(m), atol=ATOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(c), rtol=1e-5, atol=ATOL)


@pytest.mark.parametrize("scheme", ["systematic", "residual", "stratified", "multinomial"])
def test_update_resample_with_fed_uniforms(jx, scheme):
    jax, jnp, JP, _ = jx
    cfg = PFConfig(particle_count=N, res_noise_cov=(0.25, 0.25, 0, 0, 0, 1e-3))
    jp, tp = _jparams(jx, cfg)
    parts = _bank(9)
    gps = np.asarray([0.5, 0.3], np.float32)
    key = jax.random.PRNGKey(21)
    jstate = JP.PFState(particles=jnp.asarray(parts), key=key, t_prev=jnp.float32(0))
    want = np.asarray(JP.update_resample(jstate, jnp.asarray(gps), jp, scheme).particles)
    _, k_res, k_noise = jax.random.split(key, 3)
    u = np.asarray(jax.random.uniform(k_res, () if scheme == "systematic" else (N,),
                                      jnp.float32))
    noise = np.asarray(jax.random.normal(k_noise, (6, N), jnp.float32))
    st = pf_state_from_numpy({"particles": parts, "t_prev": np.float32(0)}, "cpu")
    got = P.update_resample(st, _t(gps), tp, scheme, u=_t(u), noise=_t(noise)).particles.numpy()
    same = np.all(np.abs(got - want) <= 1e-5, axis=0)
    assert (~same).sum() <= N // 1000, (~same).sum()
    # the kernel path's systematic gather (K7's plain version) gives the same
    if scheme == "systematic":
        got_k = P.update_resample(st, _t(gps), tp, scheme, use_pallas=True, u=_t(u),
                                  noise=_t(noise)).particles.numpy()
        np.testing.assert_array_equal(got_k, got)


def _pf_timeline_pair(jx, duration=15.0, seed=3, surface=-100.0):
    _, _, JP, jsim = jx
    spec = dict(duration_s=duration, seed=seed, gps_surface_z=surface)
    return (P.pf_timeline(sim.simulate(sim.MissionSpec(**spec))),
            JP.pf_timeline(jsim.simulate(jsim.MissionSpec(**spec))))


def test_pf_timeline_bitwise(jx):
    tl, jtl = _pf_timeline_pair(jx, duration=30.0, seed=4, surface=-1.0)
    t_leaves, j_leaves = tl.leaves(), [np.asarray(x) for x in
                                       [jtl.ticks] + [getattr(jtl.channels[c], f)
                                                      for c in tl.channels
                                                      for f in ("value", "stamp", "valid",
                                                                "fresh", "age")]]
    assert len(t_leaves) == len(j_leaves)
    for a, b in zip(t_leaves, j_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b, equal_nan=True)
    dive = tl.channels["diving"].value[:, 0]
    assert 0 < dive.sum() < len(dive)          # the mission dives and surfaces


@pytest.mark.parametrize("scheme,use_pallas", [("systematic", False), ("residual", False),
                                               ("residual", True)])
def test_dense_run_zero_stds(jx, scheme, use_pallas):
    """Every std zero: every particle is the one reference trajectory, so
    the replay is deterministic and both packages report the same track.
    ``use_pallas=True`` with the residual scheme takes the dense loop with
    the fused predict (K6's plain version here, JAX's kernel in interpret
    mode)."""
    jax, jnp, JP, _ = jx
    from jax.experimental.pallas import tpu as pltpu

    tl, jtl = _pf_timeline_pair(jx)
    cfg = PFConfig(particle_count=N, init_cov=(0.0,) * 6, motion_cov=(0.0,) * 6,
                   res_noise_cov=(0.0,) * 6)
    jp, tp = _jparams(jx, cfg)
    with pltpu.force_tpu_interpret_mode():
        _, jout = jax.jit(lambda t: JP.run(t, jp, cfg, key=jax.random.PRNGKey(1),
                                           scheme=scheme, use_pallas=use_pallas))(jtl)
        jout = {k: np.asarray(v) for k, v in jout.items()}
    final, out = P.run(tl.to("cpu"), tp, cfg, scheme=scheme, use_pallas=use_pallas)
    assert out["mean"].shape == (tl.num_ticks, 6) and out["cov"].shape == (tl.num_ticks, 3, 3)
    np.testing.assert_allclose(out["mean"].numpy(), jout["mean"], atol=2e-4)
    np.testing.assert_allclose(out["cov"].numpy(), jout["cov"], atol=1e-4)
    np.testing.assert_array_equal(out["updated"].numpy(), jout["updated"])
    assert jout["updated"].any()


def test_step_matches_jax_on_one_tick(jx):
    jax, jnp, JP, _ = jx
    tl, jtl = _pf_timeline_pair(jx)
    cfg = PFConfig(particle_count=N, motion_cov=(0.0,) * 6, res_noise_cov=(0.0,) * 6)
    jp, tp = _jparams(jx, cfg)
    k = int(np.nonzero(np.asarray(jtl.channels["gps"].fresh))[0][2])
    parts = _bank(12)
    jstate = JP.PFState(particles=jnp.asarray(parts), key=jax.random.PRNGKey(0),
                        t_prev=jnp.float32(tl.ticks[k - 1]))
    jtick = jax.tree_util.tree_map(lambda x: x[k], jtl)
    # no update on this step: diving (the update would draw its own ancestors)
    jtick = jtick.replace(channels={**jtick.channels, "diving": jtick.channels["diving"].replace(
        value=jnp.ones((1,), jnp.float32))})
    js, jo = JP.step(cfg, jp, jstate, jtick)
    tick = tl.to("cpu").slice_tick(k)
    tick.channels["diving"] = dataclasses.replace(tick.channels["diving"], value=torch.ones(1))
    st = pf_state_from_numpy({"particles": parts, "t_prev": np.float32(tl.ticks[k - 1])}, "cpu")
    ts, to = P.step(cfg, tp, st, tick)
    np.testing.assert_allclose(ts.particles.numpy(), np.asarray(js.particles), atol=ATOL)
    np.testing.assert_allclose(to["mean"].numpy(), np.asarray(jo["mean"]), atol=ATOL)
    assert not bool(to["updated"]) and not bool(jo["updated"])


def test_sharded_paths_raise():
    """The particle-sharded kernel paths refuse a bank whose shards do not
    tile by CDF_BLOCK (the distributed resample's requirement), before any
    work; the public entry routes there."""
    from smarc_navigation_tpu_torch.parallel import mesh

    tl = P.pf_timeline(sim.simulate(sim.MissionSpec(duration_s=2.0))).to("cpu")
    cfg = PFConfig(particle_count=3 * 1024)
    tp = P.make_params(cfg, device="cpu")
    pm = mesh.make_mesh(particle=2, devices=[torch.device("cpu")] * 2)
    for fn, kw in ((P.run, dict(scheme="systematic", use_pallas=True)), (P.run_fast, {}),
                   (P.run_fast_segmented, {})):
        with pytest.raises(ValueError, match="tile by 2048"):
            fn(tl, tp, cfg, pmesh=pm, **kw)
