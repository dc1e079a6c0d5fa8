"""The 15-state (robot_localization) dual-EKF port (``models/ekf_15state``,
``models/motion_model``, K10 in ``ops/ekf15_kernels``) against the JAX
package's, on the same numpy inputs.

On the CPU the port's K10 wrapper takes its plain version; the JAX side runs
its Pallas kernel in TPU-interpret mode, as the JAX package's own tests do.
The fleet comparisons feed both packages the same timeline, built by the
JAX package. The ``cuda`` tests hold the CUDA kernel against its plain
version on the card and skip where there is none.

Tolerances: K10's plain version transcribes the TPU kernel in its operation
order, so the fleet replays agree with the JAX kernel's to 1e-4 in x and
1e-4 relative in diag P after 201 ticks (libm ulps of sin, cos and of the
Cholesky's sqrt inputs, carried through the filter); map->odom likewise to
1e-4. The dense paths agree to 1e-4 in x: both take F by forward-mode AD
and solve a 15×15 Cholesky, with framework-specific summation orders. The
port's timeline builder computes the attitude and the control acceleration
in float32 PyTorch and agrees with the JAX builder to 1e-6; the motion
model likewise. The port's fleet against its own dense path is held at the
reference's own bounds (2e-2 / 5e-2, ``tests/test_ekf15_kernels.py``).
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from smarc_navigation_tpu_torch import convert
from smarc_navigation_tpu_torch.configs import SAMConfig
from smarc_navigation_tpu_torch.io import sim
from smarc_navigation_tpu_torch.models import ekf_15state as e15
from smarc_navigation_tpu_torch.models import motion_model as mm
from smarc_navigation_tpu_torch.ops import ekf15_kernels as k10
from smarc_navigation_tpu_torch.parallel import fleet

from test_torch_ekf_localization import port_timeline

CFG_L = e15.Ekf15Config(frequency=50.0)
CFG_G = e15.global_config(frequency=50.0)


@pytest.fixture(scope="module")
def jx():
    """The JAX reference, imported here so that the ``cuda`` tests of this
    file also run where only PyTorch is installed."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from jax.experimental import pallas as pl

    from smarc_navigation_tpu.models import ekf_15state as J15
    from smarc_navigation_tpu.models import motion_model as jmm
    from smarc_navigation_tpu.ops import ekf15_kernels as jk
    from smarc_navigation_tpu.parallel import fleet as jfleet

    return SimpleNamespace(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, J15=J15, mm=jmm, k=jk,
                           fleet=jfleet)


def _jcfg(jx, cfg):
    """The JAX package's config of the same filter."""
    return (jx.J15.Ekf15Config(frequency=cfg.frequency) if cfg.sensors is e15.LOCAL_SENSORS
            else jx.J15.global_config(frequency=cfg.frequency))


@pytest.fixture(scope="module")
def missions(jx):
    """The JAX kernel tests' fleet (4 s at 50 Hz, B=2, seeds 5 and 6, with
    GPS), built by the JAX package, and its port Timelines."""
    ms = [sim.simulate(sim.MissionSpec(duration_s=4.0, seed=5 + s)) for s in range(2)]
    jtls = [jx.J15.ekf15_timeline(m, _jcfg(jx, CFG_L), include_gps=True) for m in ms]
    return SimpleNamespace(ms=ms, jtls=jtls, tls=[port_timeline(t) for t in jtls],
                           jbatched=jx.fleet.batch_timelines(jtls))


@pytest.fixture(scope="module")
def fleet_runs(jx, missions):
    """JAX ``run_dual_fleet`` (two Pallas replays, interpret mode) and the
    port's (plain K10) on the same timeline."""
    with jx.pltpu.force_tpu_interpret_mode():
        jres = jx.J15.run_dual_fleet(missions.jbatched, missions.jbatched,
                                     _jcfg(jx, CFG_L), _jcfg(jx, CFG_G))
    bt = fleet.batch_timelines(missions.tls).to("cpu")
    return SimpleNamespace(jres=jres, res=e15.run_dual_fleet(bt, bt, CFG_L, CFG_G))


# ---------------------------------------------------------------------------
# host pieces
# ---------------------------------------------------------------------------

def test_motion_model_matches_jax(jx):
    rng = np.random.default_rng(0)
    ctl = np.stack([rng.uniform(-1500, 1500, 200), rng.uniform(-0.12, 0.12, 200)], -1)
    ctl = ctl.astype(np.float32)
    got = mm.acceleration(torch.from_numpy(ctl))
    want = np.asarray(jx.mm.acceleration(jx.jnp.asarray(ctl)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        mm.dr_fallback_velocity(torch.from_numpy(ctl), 0.02).numpy(),
        np.asarray(jx.mm.dr_fallback_velocity(jx.jnp.asarray(ctl), 0.02)), rtol=1e-6, atol=1e-8)
    np.testing.assert_array_equal(mm.mass_matrix(SAMConfig()), jx.mm.mass_matrix())

    def eom(s, c):
        return torch.cat([s[3:6], mm.acceleration(c)])

    def jeom(s, c):
        return jx.jnp.concatenate([s[3:6], jx.mm.acceleration(c)])

    s0 = rng.normal(0, 1, 6).astype(np.float32)
    J = mm.state_jacobian(eom, torch.from_numpy(s0), torch.from_numpy(ctl[0]), 0.1)
    jJ = jx.mm.state_jacobian(jeom, jx.jnp.asarray(s0), jx.jnp.asarray(ctl[0]), 0.1)
    np.testing.assert_allclose(J.numpy(), np.asarray(jJ), atol=1e-7)


def test_ekf15_timeline_matches_jax(jx, missions):
    from test_torch_no_jax import _flat

    for include_gps in (False, True):
        got = _flat(e15.ekf15_timeline(missions.ms[0], CFG_L, include_gps=include_gps))
        want = _flat(jx.J15.ekf15_timeline(missions.ms[0], _jcfg(jx, CFG_L),
                                           include_gps=include_gps))
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)


def test_convert_round_trip(jx):
    js = jx.J15.init_state(_jcfg(jx, CFG_G), x0=np.arange(15) * 0.01)
    s = convert.ekf15_state_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()}, "cpu")
    want = e15.init_state(CFG_G, x0=np.arange(15) * 0.01, device="cpu")
    for k in e15.Ekf15State._fields:
        assert getattr(s, k).dtype == torch.float32
        assert torch.equal(getattr(s, k), getattr(want, k)), k


def test_wiring_rows_and_limits():
    w, names, timeouts, use_cmd = k10.wiring(CFG_L, ("depth", "dvl", "gps", "sbg", "stim", "cmd_vel"))
    assert names == ("depth", "dvl", "gps", "sbg", "stim") and use_cmd
    assert w.sensor_idx == ((2,), (6, 7), (0, 1), (5, 11), (3, 4, 9, 10))
    assert w.rows == 4 + 2 + 3 + 3 + 3 + 5 and timeouts == (0.1,) * 5
    wg, names_g, _, _ = k10.wiring(CFG_G, ("depth", "dvl", "sbg"))     # GPS-denied
    assert names_g == ("depth", "dvl", "sbg") and wg.sensor_idx[-1] == (3, 4, 5, 9, 10, 11)
    big = dataclasses.replace(w, sensor_idx=w.sensor_idx + (tuple(range(7)),),
                              sensor_noise=w.sensor_noise + ((0.1,) * 7,))
    with pytest.raises(ValueError, match="at most"):
        k10._c_wiring(big)


# ---------------------------------------------------------------------------
# K10 fleets against the JAX kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["local", "global"])
def test_run_fleet15_matches_jax(fleet_runs, which):
    (jfl, jol), (jfg, jog), _ = fleet_runs.jres
    (fl, ol), (fg, og), _ = fleet_runs.res
    (jf, jo), (f, o) = ((jfl, jol), (fl, ol)) if which == "local" else ((jfg, jog), (fg, og))
    assert o["x"].shape == (201, 2, 15) and o["x"].dtype == torch.float32
    np.testing.assert_allclose(o["x"].numpy(), np.asarray(jo["x"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(o["p_diag"].numpy(), np.asarray(jo["p_diag"]), rtol=1e-4,
                               atol=1e-9)
    np.testing.assert_allclose(f[0].numpy(), np.asarray(jf[0]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(f[1].numpy(), np.asarray(jf[1]), rtol=1e-4, atol=1e-7)
    assert torch.equal(f[1], f[1].transpose(1, 2))


def test_run_dual_fleet_map_odom_matches_jax(fleet_runs):
    jmo, mo = fleet_runs.jres[2], fleet_runs.res[2]
    assert mo.rot.shape == (201, 2, 3, 3) and mo.trans.shape == (201, 2, 3)
    np.testing.assert_allclose(mo.trans.numpy(), np.asarray(jmo.trans), rtol=0, atol=1e-4)
    np.testing.assert_allclose(mo.rot.numpy(), np.asarray(jmo.rot), rtol=0, atol=1e-4)


def test_fleet15_tick_reference_on_one_tick(fleet_runs, missions):
    """The tick wrapper on tick 100's inputs and the replay's state after
    tick 99 gives the replay's tick 100 (the loop is nothing but ticks)."""
    bt = fleet.batch_timelines(missions.tls).to("cpu")
    (_, ol), _, _ = fleet_runs.res
    w, names, timeouts, _ = k10.wiring(CFG_L, bt.channels)
    fin, out = e15.run_fleet(bt.map(lambda a: a[:, :100]), CFG_L)
    t = 100
    cmd = bt.channels["cmd_vel"]
    cols = [bt.ticks[:, t] - bt.ticks[:, t - 1], cmd.value[:, t, 0], cmd.value[:, t, 1],
            cmd.valid[:, t].float()]
    for name, ix, to in zip(names, w.sensor_idx, timeouts):
        ch = bt.channels[name]
        cols += [ch.value[:, t, i] for i in ix]
        cols.append((ch.fresh[:, t] & (ch.age[:, t] < to)).float())
    tick = torch.stack(cols, 1)
    x, P = k10.fleet15_tick(fin[0].contiguous(), fin[1].contiguous(), tick, w)
    assert torch.equal(x, ol["x"][t])
    assert torch.equal(torch.diagonal(P, dim1=1, dim2=2), ol["p_diag"][t])
    assert torch.equal(P, P.transpose(1, 2))


def _sensor_tick(w, x, rng, flags):
    """One tick row per mission for wiring ``w``: dt 0.02, a random cmd, each
    sensor's values near the state, its apply flag from ``flags`` ("on",
    "off" or "random")."""
    B = x.shape[0]
    tick = np.zeros((B, w.rows), np.float32)
    tick[:, 0] = 0.02
    tick[:, 1:3] = rng.normal(0, 0.5, (B, 2))
    tick[:, 3] = rng.integers(0, 2, B)
    row = 4
    for ix in w.sensor_idx:
        tick[:, row:row + len(ix)] = x[:, list(ix)] + rng.normal(0, 0.1, (B, len(ix)))
        tick[:, row + len(ix)] = {"on": np.ones(B), "off": np.zeros(B),
                                  "random": rng.integers(0, 2, B)}[flags]
        row += len(ix) + 1
    return torch.from_numpy(tick)


def test_fleet15_tick_flags_off_is_the_predict(jx, fleet_runs):
    """A tick whose every apply flag is off gives exactly the predict alone
    (the plain version with no sensor wired), as the CUDA kernel's skipped
    sensors rely on; the JAX kernel (interpret mode) agrees to 1e-5 of each
    output's scale (libm ulps of sin, cos and tan)."""
    (x, P), _ = fleet_runs.res[0]
    w, _, _, _ = k10.wiring(CFG_L, ("depth", "dvl", "gps", "sbg", "stim", "cmd_vel"))
    tick = _sensor_tick(w, x.numpy(), np.random.default_rng(3), "off")
    xo, Po = k10.fleet15_tick(x, P, tick, w)
    none = dataclasses.replace(w, sensor_idx=(), sensor_noise=())
    xp, Pp = k10.fleet15_tick(x, P, tick[:, :4].contiguous(), none)
    assert torch.equal(xo, xp) and torch.equal(Po, Pp)
    assert not torch.equal(Po, P)
    jnp, pl = jx.jnp, jx.pl
    B, f32 = x.shape[0], jnp.float32
    lanes = [jnp.zeros((r, 128), f32).at[:, :B].set(jnp.asarray(a.reshape(B, r).numpy().T))
             for a, r in ((torch.cat([x, tick[:, :1]], 1), 16), (P, 225), (tick, w.rows))]
    with jx.pltpu.force_tpu_interpret_mode():
        call = pl.pallas_call(
            jx.k._make_ekf15_kernel(w.sensor_idx, w.sensor_noise, w.q_diag, w.gains, w.limits,
                                    w.use_control),
            in_specs=[pl.BlockSpec(memory_space=jx.pltpu.VMEM)] * 3,
            out_specs=[pl.BlockSpec(memory_space=jx.pltpu.VMEM)] * 2,
            out_shape=[jx.jax.ShapeDtypeStruct((16, 128), f32),
                       jx.jax.ShapeDtypeStruct((225, 128), f32)])
        jxo, jpo = jx.jax.jit(call)(*lanes)
    for got, want in ((np.asarray(jxo)[:15, :B].T, xp), (np.asarray(jpo)[:, :B].T, Pp.reshape(B, 225))):
        scale = max(1.0, float(want.abs().max()))
        np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-5 * scale)


# ---------------------------------------------------------------------------
# the dense paths
# ---------------------------------------------------------------------------

def test_dense_run_and_dual_match_jax(jx, missions, fleet_runs):
    tl, jtl = missions.tls[0].to("cpu"), missions.jtls[0]
    (fl, ol), (fg, og), mo = e15.run_dual(tl, tl, CFG_L, CFG_G)
    (jfl, jol), (jfg, jog), jmo = jx.J15.run_dual(jtl, jtl, _jcfg(jx, CFG_L), _jcfg(jx, CFG_G))
    np.testing.assert_allclose(ol["x"].numpy(), np.asarray(jol["x"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(og["x"].numpy(), np.asarray(jog["x"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ol["p_diag"].numpy(), np.asarray(jol["p_diag"]), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(mo.trans.numpy(), np.asarray(jmo.trans), rtol=0, atol=1e-4)
    np.testing.assert_allclose(fl.x.numpy(), np.asarray(jfl.x), rtol=0, atol=1e-4)
    # fleet (K10's exact-subspace update) vs dense (1e12 noise), at the
    # reference's own bounds
    (_, ofl), (_, ofg), mof = fleet_runs.res
    np.testing.assert_allclose(ofl["x"][:, 0].numpy(), ol["x"].numpy(), atol=2e-2)
    np.testing.assert_allclose(ofl["p_diag"][:, 0].numpy(), ol["p_diag"].numpy(),
                               rtol=0.05, atol=2e-2)
    np.testing.assert_allclose(ofg["x"][:, 0].numpy(), og["x"].numpy(), atol=5e-2)
    np.testing.assert_allclose(mof.trans[:, 0].numpy(), mo.trans.numpy(), atol=5e-2)


def test_dense_update_gates(jx):
    """Depth-only update fixes z and respects the apply gate (as the
    reference's dense tests hold it)."""
    st = e15.init_state(CFG_L, device="cpu")
    st = st._replace(P=st.P.clone())
    st.P[2, 2] = 1.0
    z = torch.zeros(15)
    z[2] = -7.0
    mask = torch.tensor([False, False, True] + [False] * 12)
    noise = torch.full((15,), 0.001)
    s2 = e15.update(st, z, mask, noise, torch.tensor(True))
    assert abs(float(s2.x[2]) + 7.0) < 0.05 and abs(float(s2.x[0])) < 1e-5
    s3 = e15.update(st, z, mask, noise, torch.tensor(False))
    assert torch.equal(s3.x, st.x) and torch.equal(s3.P, st.P)
    jst = jx.J15.init_state(_jcfg(jx, CFG_L))
    jst = jst._replace(P=jst.P.at[2, 2].set(1.0))
    js2 = jx.J15.update(jst, jx.jnp.asarray(z.numpy()), jx.jnp.asarray(mask.numpy()),
                        jx.jnp.asarray(noise.numpy()), jx.jnp.asarray(True))
    np.testing.assert_allclose(s2.x.numpy(), np.asarray(js2.x), atol=1e-6)
    np.testing.assert_allclose(s2.P.numpy(), np.asarray(js2.P), atol=1e-6)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _card_fleet(cfg, B, T=120):
    ms = [sim.simulate(sim.MissionSpec(duration_s=(T - 1) / cfg.frequency, seed=5 + s))
          for s in range(min(B, 4))]
    tls = [e15.ekf15_timeline(m, cfg, include_gps=True) for m in ms]
    return fleet.batch_timelines((tls * B)[:B])


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["local", "global"])
def test_fleet15_kernel_matches_plain_on_card(which):
    _need_cuda()
    cfg = CFG_L if which == "local" else CFG_G
    bt = _card_fleet(cfg, 37)
    (xs, Ps), _ = e15.run_fleet(bt.to("cpu"), cfg)          # a state mid-mission
    w, names, timeouts, _ = k10.wiring(cfg, bt.channels)
    rng = np.random.default_rng(0)
    tick = np.zeros((37, w.rows), np.float32)
    tick[:, 0] = 0.02
    tick[:, 1:3] = rng.normal(0, 0.5, (37, 2))
    tick[:, 3] = rng.integers(0, 2, 37)
    row = 4
    for ix in w.sensor_idx:
        tick[:, row:row + len(ix)] = xs[:, list(ix)].numpy() + rng.normal(0, 0.1, (37, len(ix)))
        tick[:, row + len(ix)] = rng.integers(0, 2, 37)
        row += len(ix) + 1
    args = (xs.cuda(), Ps.cuda(), torch.from_numpy(tick).cuda(), w)
    n0 = k10.fleet15_tick.launches
    x, P = k10.fleet15_tick(*args)
    torch.cuda.synchronize()
    assert k10.fleet15_tick.launches == n0 + 1
    xr, Pr = k10.fleet15_tick_reference(*args)
    for g, r in ((x, xr), (P, Pr)):
        scale = max(1.0, float(r.abs().max()))
        assert float((g - r).abs().max()) <= 1e-5 * scale
    assert torch.equal(P, P.transpose(1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("flags", ["on", "off", "random"])
@pytest.mark.parametrize("B", [1, 37, 64])
@pytest.mark.parametrize("which", ["local", "global"])
def test_fleet15_kernel_block_per_mission_on_card(which, B, flags):
    """One block per mission at widths that are not a multiple of anything,
    with every sensor applied, none, or a random mix (skipped sensors)."""
    _need_cuda()
    cfg = CFG_L if which == "local" else CFG_G
    w, _, _, _ = k10.wiring(cfg, ("depth", "dvl", "gps", "sbg", "stim", "cmd_vel"))
    rng = np.random.default_rng(B)
    x = rng.normal(0, 1, (B, 15)).astype(np.float32)
    x[:, 3:6] = rng.uniform(-0.5, 0.5, (B, 3))
    A = rng.normal(0, 0.1, (B, 15, 15))
    P = (A @ np.swapaxes(A, 1, 2) + 0.01 * np.eye(15)).astype(np.float32)
    P = (P + np.swapaxes(P, 1, 2)) / 2
    args = (torch.from_numpy(x).cuda(), torch.from_numpy(P).cuda(),
            _sensor_tick(w, x, rng, flags).cuda(), w)
    n0 = k10.fleet15_tick.launches
    xk, Pk = k10.fleet15_tick(*args)
    torch.cuda.synchronize()
    assert k10.fleet15_tick.launches == n0 + 1
    xr, Pr = k10.fleet15_tick_reference(*args)
    for g, r in ((xk, xr), (Pk, Pr)):
        scale = max(1.0, float(r.abs().max()))
        assert float((g - r).abs().max()) <= 1e-5 * scale
    assert torch.equal(Pk, Pk.transpose(1, 2))


@pytest.mark.cuda
def test_run_dual_fleet_on_card_matches_cpu():
    _need_cuda()
    bt = _card_fleet(CFG_L, 8)
    n0 = k10.fleet15_tick.launches
    (_, olk), (_, ogk), mok = e15.run_dual_fleet(bt.to("cuda"), bt.to("cuda"), CFG_L, CFG_G)
    torch.cuda.synchronize()
    assert k10.fleet15_tick.launches - n0 == 2 * bt.ticks.shape[1]
    (_, olp), (_, ogp), mop = e15.run_dual_fleet(bt.to("cpu"), bt.to("cpu"), CFG_L, CFG_G)
    for k, p in ((olk["x"], olp["x"]), (ogk["x"], ogp["x"]), (mok.trans, mop.trans)):
        np.testing.assert_allclose(k.cpu().numpy(), p.numpy(), rtol=0, atol=1e-4)
