"""The port's particle-sharded PF (``pmesh=`` of ``models/particle_filter.py``)
against its unsharded self and against the JAX package's, at the shapes of
``tests/test_pf_pmesh.py`` (N = 2^14, a (2, 4) mesh).

On the CPU a mesh is ``make_mesh(..., devices=[cpu] * k)``; the shards are
column blocks of the bank driven from this process. Tolerances and why:
every sharded replay is BITWISE its unsharded run, bank and mean/cov (a
shard tiles by CDF_BLOCK, a multiple of the moments' SUM_GROUP): the weights,
the counts, the ancestors and the draws are order-pinned or keyed on the
global particle index. Against the JAX package's ``update_resample(pmesh)``
on its own uniforms and normals: columns within 1e-5, up to a
stratum-boundary ancestor flip (the two frameworks' f32 ``exp`` differ by
an ulp on some inputs, so the weights may), as ``tests/test_torch_pf.py``
holds the dense path. K5/K6's plain versions with ``idx_off``: a shard's
columns bitwise the unsharded call's. The ``cuda`` tests hold the kernels
with ``idx_off`` to their plain versions and four shards on one card to the
unsharded replay, bitwise.
"""

import numpy as np
import pytest
import torch

from smarc_navigation_tpu_torch.configs import PFConfig
from smarc_navigation_tpu_torch.convert import pf_state_from_numpy
from smarc_navigation_tpu_torch.io import sim
from smarc_navigation_tpu_torch.models import particle_filter as P
from smarc_navigation_tpu_torch.ops import pf_kernels as K
from smarc_navigation_tpu_torch.parallel import mesh
from smarc_navigation_tpu_torch.parallel import resample_dist as RD

N = 1 << 14
CPU = torch.device("cpu")
NOISY = dict(init_cov=(4.0, 4.0, 0.0, 0.0, 0.0, 0.04), motion_cov=(0.01, 0.01, 0.0, 0.0, 0.0, 1e-4),
             res_noise_cov=(0.04, 0.04, 0.0, 0.0, 0.0, 1e-4))


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from smarc_navigation_tpu.models import particle_filter as JP
    from smarc_navigation_tpu.parallel import mesh as jmesh

    return jax, jnp, JP, jmesh


def _cpu_mesh(mission=1, particle=1):
    return mesh.make_mesh(mission=mission, particle=particle,
                          devices=[CPU] * (mission * particle))


@pytest.fixture(scope="module")
def timeline():
    m = sim.simulate(sim.MissionSpec(duration_s=4.0, seed=3, gps_surface_z=-100.0))
    tl = P.pf_timeline(m, freq_hz=10.0).to("cpu")
    upd = tl.channels["gps"].fresh & (tl.channels["diving"].value[:, 0] < 0.5)
    assert int(upd.sum()) >= 2, "the mission must exercise the resample"
    return tl


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(mesh._leaves(a), mesh._leaves(b)))


def test_update_resample_pmesh_matches_jax(jx):
    """One GPS update through the public ``update_resample`` with a pmesh,
    on the JAX key's own uniform and normals: the reference's sharded update
    within 1e-5 per column (up to a boundary flip), and bitwise the port's
    unsharded update."""
    jax, jnp, JP, jmesh = jx
    cfg = PFConfig(particle_count=N, res_noise_cov=(0.25, 0.25, 0, 0, 0, 1e-3))
    parts = np.random.default_rng(9).normal(0, 2.0, (6, N)).astype(np.float32)
    gps = np.asarray([0.3, -0.2], np.float32)
    key = jax.random.PRNGKey(2)
    jstate = JP.PFState(particles=jnp.asarray(parts), key=key, t_prev=jnp.float32(0))
    want = np.asarray(JP.update_resample(jstate, jnp.asarray(gps), JP.make_params(cfg),
                                         scheme="systematic",
                                         pmesh=jmesh.make_mesh(mission=2, particle=4)).particles)
    _, k_res, k_noise = jax.random.split(key, 3)
    u = torch.tensor(np.asarray(jax.random.uniform(k_res, (), jnp.float32)))
    noise = torch.tensor(np.asarray(jax.random.normal(k_noise, (6, N), jnp.float32)))
    st = pf_state_from_numpy({"particles": parts, "t_prev": np.float32(0)}, "cpu")
    tp = P.make_params(cfg, device="cpu")
    got = P.update_resample(st, torch.tensor(gps), tp, "systematic", pmesh=_cpu_mesh(2, 4),
                            u=u, noise=noise).particles
    same = np.all(np.abs(got.numpy() - want) <= 1e-5, axis=0)
    assert (~same).sum() <= N // 1000, (~same).sum()
    ref = P.update_resample(st, torch.tensor(gps), tp, "systematic", u=u, noise=noise).particles
    assert torch.equal(got, ref)


@pytest.mark.parametrize("scheme", ["systematic", "residual"])
def test_run_dense_pmesh_bitwise(timeline, scheme):
    """The dense replay with a pmesh: noise drawn for the whole bank from the
    caller's generator, the systematic resample distributed, the others on
    the joined bank: bitwise the unsharded replay."""
    cfg = PFConfig(particle_count=N, **NOISY)
    tp = P.make_params(cfg, device="cpu")
    ref = P.run(timeline, tp, cfg, generator=_gen(7), scheme=scheme)
    got = P.run(timeline, tp, cfg, generator=_gen(7), scheme=scheme, pmesh=_cpu_mesh(2, 4))
    assert _equal(got[1], ref[1]) and torch.equal(got[0].particles, ref[0].particles)


@pytest.mark.parametrize("runner", ["run_fast_segmented", "run_fast"])
@pytest.mark.parametrize("particle_ax", [2, 4])
def test_run_fast_pmesh_bitwise(timeline, monkeypatch, runner, particle_ax):
    """The kernel paths per particle shard (K5/K6 with ``idx_off``, the
    shard update: weights, K7's window form, K8 with ``seed_off``), noise
    on: bank and mean/cov bitwise the unsharded run, each shard's update
    through the kernels' wrappers."""
    calls = {"window": 0, "jitter": 0}
    for name, key in (("expand_gather_window_call", "window"), ("jitter_moments_call", "jitter")):
        fn = getattr(K, name)

        def counted(*a, _fn=fn, _k=key, **kw):
            calls[_k] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(K, name, counted)
    cfg = PFConfig(particle_count=N, **NOISY)
    tp = P.make_params(cfg, device="cpu")
    fn = getattr(P, runner)
    f0, o0 = fn(timeline, tp, cfg, generator=_gen(4))
    RD.exact_fallbacks = 0
    f1, o1 = fn(timeline, tp, cfg, generator=_gen(4), pmesh=_cpu_mesh(particle=particle_ax))
    assert torch.equal(f1.particles, f0.particles)
    assert torch.equal(o1["mean"], o0["mean"]) and torch.equal(o1["cov"], o0["cov"])
    assert torch.equal(o1["updated"], o0["updated"])
    n_upd = int(o0["updated"].sum())
    assert calls == {"window": particle_ax * n_upd, "jitter": particle_ax * n_upd}
    assert RD.exact_fallbacks == 0
    # the public entry routes there
    _, o2 = P.run(timeline, tp, cfg, generator=_gen(4), scheme="systematic", use_pallas=True,
                  segmented=runner == "run_fast_segmented", pmesh=_cpu_mesh(particle=particle_ax))
    assert torch.equal(o2["mean"], o0["mean"])


def test_run_fast_pmesh_three_row_shards(timeline):
    """Shards of three CDF_BLOCK rows (not a power of two; the tree sums'
    row counts pad): bank and moments bitwise the unsharded run."""
    n = 3 * 2048 * 2
    cfg = PFConfig(particle_count=n, **NOISY)
    tp = P.make_params(cfg, device="cpu")
    f0, o0 = P.run_fast_segmented(timeline, tp, cfg, generator=_gen(5))
    f1, o1 = P.run_fast_segmented(timeline, tp, cfg, generator=_gen(5),
                                  pmesh=_cpu_mesh(particle=2))
    assert torch.equal(f1.particles, f0.particles)
    assert torch.equal(o1["mean"], o0["mean"]) and torch.equal(o1["cov"], o0["cov"])


@pytest.mark.parametrize("single", [False, True])
def test_predict_idx_off_shards_are_columns(single):
    """K5/K6's plain versions with ``idx_off``: each shard's columns are the
    unsharded call's, bitwise, and its moment partials the unsharded ones'."""
    rng = np.random.default_rng(1)
    n, P_ = 8192, 4
    ns = n // P_
    parts = torch.from_numpy(rng.normal(0, 1, (6, n)).astype(np.float32))
    par16 = torch.from_numpy(rng.normal(0, 0.1, (3, 16)).astype(np.float32))
    par16[:, 7:10] = 0.05
    par16[:, 11] = 1.0
    seeds = torch.tensor([11, 12, 13], dtype=torch.int32)
    if single:
        want = K.predict_call(parts, par16[0], seeds[0])
        got = [K.predict_call(parts[:, s * ns:(s + 1) * ns].contiguous(), par16[0], seeds[0],
                              idx_off=s * ns) for s in range(P_)]
    else:
        want = K.predict_call_multi(parts, par16, seeds, nticks=2)
        got = [K.predict_call_multi(parts[:, s * ns:(s + 1) * ns].contiguous(), par16, seeds,
                                    nticks=2, idx_off=s * ns) for s in range(P_)]
    assert torch.equal(torch.cat([g[0] for g in got], -1), want[0])
    assert torch.equal(torch.cat([g[1] for g in got], -1), want[1])
    # at offset 0 the call is what it was
    assert torch.equal(K.predict_call_multi(parts, par16, seeds, nticks=2, idx_off=0)[0],
                       K.predict_call_multi(parts, par16, seeds, nticks=2)[0])
    with pytest.raises(ValueError, match="offset"):
        K.predict_call(parts, par16[0], seeds[0], idx_off=-1)


def test_fleet_update_resample_pmesh_bitwise():
    """The fleet's batched update with a (mission, particle) mesh: the
    distributed fleet resample where the shards tile by CDF_BLOCK, the
    per-bank sampler where they do not; bitwise the unsharded update."""
    cfg = PFConfig(particle_count=2 * 2048, **NOISY)
    tp = P.make_params(cfg, device="cpu")
    for n in (2 * 2048, 1024):
        st = P.fleet_init(4, n, tp, seed=3)
        gps = torch.from_numpy(np.random.default_rng(n).normal(0, 1, (4, 2)).astype(np.float32))
        ref = P.fleet_update_resample(st, gps, tp)
        got = P.fleet_update_resample(st, gps, tp, pmesh=_cpu_mesh(2, 2))
        assert _equal(got, ref)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("single", [False, True])
def test_predict_kernels_idx_off(cuda, single):
    """K5/K6 with ``idx_off`` on the card: four shards concatenated are
    bitwise the whole-bank call, and each matches its plain version."""
    rng = np.random.default_rng(2)
    n, P_ = 1 << 16, 4
    ns = n // P_
    parts = torch.from_numpy(rng.normal(0, 1, (6, n)).astype(np.float32)).to(cuda)
    par16 = torch.from_numpy(rng.normal(0, 0.1, (3, 16)).astype(np.float32))
    par16[:, 7:10] = 0.05
    par16[:, 11] = 1.0
    par16, seeds = par16.to(cuda), torch.tensor([3, 4, 5], dtype=torch.int32, device=cuda)
    if single:
        call = lambda p, off: K.predict_call(p, par16[0], seeds[0], idx_off=off)  # noqa: E731
        plain = lambda p, off: K.predict_call_reference(p, par16[0], seeds[0], idx_off=off)  # noqa: E731
    else:
        call = lambda p, off: K.predict_call_multi(p, par16, seeds, idx_off=off)  # noqa: E731
        plain = lambda p, off: K.predict_call_multi_reference(p, par16, seeds, idx_off=off)  # noqa: E731
    whole = call(parts, 0)
    shards = [call(parts[:, s * ns:(s + 1) * ns].contiguous(), s * ns) for s in range(P_)]
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([s[0] for s in shards], -1), whole[0])
    assert torch.equal(torch.cat([s[1] for s in shards], -1), whole[1])
    got, want = shards[2][0], plain(parts[:, 2 * ns:3 * ns].contiguous(), 2 * ns)[0]
    assert float((got[0:5] - want[0:5]).abs().max()) <= 1e-4 * max(1.0, float(want.abs().max()))


@pytest.mark.cuda
def test_run_fast_segmented_four_shards_on_one_card(cuda, timeline):
    cfg = PFConfig(particle_count=1 << 16, **NOISY)
    tp = P.make_params(cfg, device=cuda)
    tl = timeline.to(cuda)
    f0, o0 = P.run_fast_segmented(tl, tp, cfg, generator=torch.Generator(device=cuda).manual_seed(1))
    launches = K.jitter_moments_call.launches
    f1, o1 = P.run_fast_segmented(tl, tp, cfg, generator=torch.Generator(device=cuda).manual_seed(1),
                                  pmesh=mesh.make_mesh(particle=4, devices=[cuda] * 4))
    assert K.jitter_moments_call.launches - launches == 4 * int(o0["updated"].sum())
    assert torch.equal(f1.particles, f0.particles)
    assert torch.equal(o1["mean"], o0["mean"]) and torch.equal(o1["cov"], o0["cov"])

