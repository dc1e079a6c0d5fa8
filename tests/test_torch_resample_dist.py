"""The port's multi-device layer for the particle axis: the mesh and its
collectives (``parallel/mesh.py``), the shard sums of ``ops/resampling.py``
and the distributed systematic resample (``parallel/resample_dist.py``),
against the JAX package's on the same numpy inputs, at the shapes of
``tests/test_resample_dist.py`` and ``tests/test_pf_pmesh.py``.

On the CPU the port's mesh is ``make_mesh(particle=P, devices=[cpu] * P)``
and the JAX side runs ``shard_map`` on the 8-device virtual CPU mesh of
``tests/conftest.py`` with ``use_pallas=False`` (its Pallas expansion
deadlocks inside ``shard_map`` in interpret mode). The JAX key's uniform
(``jax.random.uniform(key, ())``, the draw of its shard body) is handed to
the port as ``u``.

Tolerances and why: ancestors, banks and tree sums are bitwise (integer
counts from the same order-pinned f32 sums); the normalized weights are
bitwise the unsharded port's and within 4 ulp of the JAX shard
function's: XLA's and torch's f32 ``exp`` differ by an ulp on some inputs
(``tests/test_torch_resampling.py`` holds the unsharded pair bitwise where
they agree), and the order-pinned sum and divide after it carry that
through. K7's window form against numpy's ``searchsorted`` + clip:
exact. The ``cuda`` tests hold the window form's kernel against its plain
version on the card, exactly.
"""

import numpy as np
import pytest
import torch

from smarc_navigation_tpu_torch.ops import pf_kernels as K
from smarc_navigation_tpu_torch.ops import resampling as R
from smarc_navigation_tpu_torch.parallel import mesh
from smarc_navigation_tpu_torch.parallel import resample_dist as RD

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def jx():
    """The JAX reference, imported here so that the ``cuda`` tests of this
    file also run where only PyTorch is installed."""
    import jax
    import jax.numpy as jnp

    from smarc_navigation_tpu.ops import resampling
    from smarc_navigation_tpu.parallel import mesh as jmesh
    from smarc_navigation_tpu.parallel import resample_dist

    return jax, jnp, resampling, jmesh, resample_dist


def _bank(n, seed=0):
    return np.random.default_rng(seed).normal(size=(6, n)).astype(np.float32)


def _weights(n, kind, seed=0):
    """``tests/test_resample_dist.py``'s weights."""
    rng = np.random.default_rng(seed + 17)
    if kind == "uniform":
        w = rng.uniform(0.5, 1.5, n)
    elif kind == "skewed":
        w = rng.exponential(1.0, n) ** 2
    else:
        w = np.full(n, 1e-12)
        w[n // 3] = 1.0
    return (w / w.sum()).astype(np.float32)


def _cpu_mesh(mission=1, particle=1):
    return mesh.make_mesh(mission=mission, particle=particle,
                          devices=[CPU] * (mission * particle))


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def test_make_mesh_grid_and_shape():
    m = _cpu_mesh(mission=2, particle=4)
    assert m.shape == {mesh.MISSION_AXIS: 2, mesh.PARTICLE_AXIS: 4}
    assert len(m.devices) == 2 and all(len(r) == 4 for r in m.devices)
    assert mesh.make_mesh(particle=2, devices=[CPU] * 8).shape[mesh.MISSION_AXIS] == 4
    with pytest.raises(ValueError, match="3x2 != 8"):
        mesh.make_mesh(mission=3, particle=2, devices=[CPU] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.make_mesh()


def test_shardings_split_and_join():
    m = _cpu_mesh(mission=2, particle=4)
    x = torch.arange(4 * 6 * 32, dtype=torch.float32).reshape(4, 6, 32)
    sh = mesh.mission_particle_sharding(m, 3, particle_axis=2)
    pieces = sh.shard(x)
    assert len(pieces) == 2 and all(len(r) == 4 for r in pieces)
    assert torch.equal(pieces[1][2], x[2:4, :, 16:24])
    assert torch.equal(sh.join(pieces, CPU), x)
    ms = mesh.mission_sharding(m, 3).shard(x)
    assert torch.equal(ms[1][3], x[2:4]) and torch.equal(mesh.mission_sharding(m, 3).join(ms, CPU), x)
    ps = mesh.particle_sharding(m, 3, particle_axis=2).shard(x)
    assert torch.equal(ps[0][1], x[:, :, 8:16])
    tree = {"a": x, "b": (x[:, 0], None)}
    per = mesh.shard_missions(tree, m)
    assert torch.equal(per[1]["a"], x[2:4]) and per[1]["b"][1] is None
    joined = mesh.join_missions(per, CPU)
    assert torch.equal(joined["a"], x) and torch.equal(joined["b"][0], x[:, 0])
    assert len(mesh.replicate(tree, m)) == 8
    with pytest.raises(ValueError, match="does not split"):
        mesh.particle_sharding(m, 1).shard(torch.zeros(6))


def test_collectives():
    rng = np.random.default_rng(1)
    xs = [torch.tensor(rng.normal(size=5).astype(np.float32)) for _ in range(4)]
    assert all(torch.equal(g, torch.cat(xs)) for g in mesh.all_gather(xs))
    assert all(torch.equal(g, torch.stack(xs)) for g in mesh.all_gather(xs, tiled=False))
    want = ((xs[0] + xs[1]) + xs[2]) + xs[3]     # shard order
    assert all(torch.equal(s, want) for s in mesh.psum(xs))
    assert all(torch.equal(s, torch.stack(xs).amax(0)) for s in mesh.pmax(xs))
    left, right = mesh.from_left(xs), mesh.from_right(xs)
    assert torch.equal(left[0], torch.zeros(5)) and torch.equal(left[2], xs[1])
    assert torch.equal(right[3], torch.zeros(5)) and torch.equal(right[1], xs[2])


# ---------------------------------------------------------------------------
# the shard sums
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(17,), (1000,), (2048,), (3, 1000), (64, 2048), (1 << 17,)])
def test_prefix_sum_is_jax_cumsum(jx, shape):
    """``prefix_sum`` (the blocked CDF's scans) adds in the JAX package's
    CPU order, bit for bit; so the blocked CDF is the reference's."""
    jnp, J = jx[1], jx[2]
    x = np.random.default_rng(len(shape) + shape[-1]).exponential(1.0, shape).astype(np.float32)
    assert R.prefix_sum(torch.from_numpy(x)).numpy().tobytes() == \
        np.asarray(jnp.cumsum(jnp.asarray(x), axis=-1)).tobytes()
    w = x.reshape(-1) / x.sum()
    assert R.blocked_cdf(torch.from_numpy(w)).numpy().tobytes() == \
        np.asarray(J.blocked_cdf(jnp.asarray(w))).tobytes()


def _jax_shard(jx, fn, x, out_whole):
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    jax, jnp, _, jmesh, _ = jx
    pm = jmesh.make_mesh(mission=2, particle=4)
    if out_whole:
        return np.asarray(shard_map(lambda v: fn(v[:, 0], jmesh.PARTICLE_AXIS)[None], mesh=pm,
                                    in_specs=P(jmesh.PARTICLE_AXIS, None), out_specs=P(),
                                    check_vma=False)(jnp.asarray(x)[:, None]))[0]
    return np.asarray(shard_map(lambda v: fn(v, jmesh.PARTICLE_AXIS), mesh=pm,
                                in_specs=P(jmesh.PARTICLE_AXIS), out_specs=P(jmesh.PARTICLE_AXIS),
                                check_vma=False)(jnp.asarray(x)))


@pytest.mark.parametrize("n", [1 << 14, 4 * 3 * 2048])   # pow2 shards / non-pow2 row counts
def test_tree_sum_shard_bitwise(jx, n):
    x = np.random.default_rng(3).exponential(1.0, n).astype(np.float32)
    shards = list(torch.from_numpy(x).chunk(4))
    got = R.tree_sum_shard(shards, mesh.PARTICLE_AXIS)
    want = _jax_shard(jx, jx[2].tree_sum_shard, x, True)
    whole = R.tree_sum(torch.from_numpy(x))
    for g in got:
        assert g.numpy().tobytes() == want.tobytes() == whole.numpy().tobytes()
    # shards that do not tile by CDF_BLOCK gather the whole vector
    odd = list(torch.from_numpy(x[:4 * 1000]).chunk(4))
    assert R.tree_sum_shard(odd)[2].numpy().tobytes() == R.tree_sum(
        torch.from_numpy(x[:4000])).numpy().tobytes()


@pytest.mark.parametrize("scale", [1.0, 50.0])
def test_normalize_weights_det_shard(jx, scale):
    n = 1 << 14
    logw = (-scale * np.random.default_rng(11).exponential(1.0, n)).astype(np.float32)
    got = torch.cat(R.normalize_weights_det_shard(list(torch.from_numpy(logw).chunk(4)),
                                                  mesh.PARTICLE_AXIS)).numpy()
    whole = R.normalize_weights_det(torch.from_numpy(logw)).numpy()
    assert got.tobytes() == whole.tobytes()
    want = _jax_shard(jx, jx[2].normalize_weights_det_shard, logw, False)
    ulp = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
    assert ulp.max() <= 4


# ---------------------------------------------------------------------------
# K7's window form (plain version)
# ---------------------------------------------------------------------------

def _window_case(kind, n_in, lo, seed):
    """Monotone counts over n_in columns whose values start at ``lo`` (below
    a window) and run past it: healthy, degenerate (one column takes every
    slot) or with long zero-count runs."""
    rng = np.random.default_rng(seed)
    if kind == "healthy":
        steps = rng.poisson(1.0, n_in)
    elif kind == "degenerate":
        steps = np.zeros(n_in, np.int64)
        steps[n_in // 3] = 3 * n_in
    else:
        steps = np.zeros(n_in, np.int64)
        steps[:64] = rng.poisson(8.0, 64)
        steps[-64:] = rng.poisson(8.0, 64)
    return (lo + np.cumsum(steps)).astype(np.int32)


@pytest.mark.parametrize("kind", ["healthy", "degenerate", "zero-run"])
def test_window_form_plain_matches_searchsorted(kind):
    n_in, n_out = 3000, 1024
    m = _window_case(kind, n_in, lo=500, seed=len(kind))
    parts = _bank(n_in, seed=4)
    for off in (0, 700, int(m[-1]) - n_out // 2, int(m[-1]) + 10):   # left, interior, end, past
        got = K.expand_gather_window_call(torch.from_numpy(m), torch.from_numpy(parts), off, n_out)
        anc = np.clip(np.searchsorted(m, off + np.arange(n_out), side="right"), 0, n_in - 1)
        np.testing.assert_array_equal(got.numpy(), parts[:, anc])


def test_window_form_is_whole_bank_k7_at_offset_zero():
    n = 8192
    w = torch.from_numpy(_weights(n, "skewed", seed=2))
    m = R.systematic_counts(w, 0.41)
    parts = torch.from_numpy(_bank(n, seed=2))
    assert torch.equal(K.expand_gather_window_call(m, parts, 0, n),
                       K.expand_gather_call(m, parts))


# ---------------------------------------------------------------------------
# the distributed systematic resample
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["uniform", "skewed", "collapse"])
@pytest.mark.parametrize("particle_ax", [4, 8])
def test_dist_resample_matches_jax(jx, kind, particle_ax):
    jax, jnp, _, jmesh, jrd = jx
    n = 1 << 17
    parts, w = _bank(n), _weights(n, kind)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jrd.systematic_resample_gather_dist(
        jnp.asarray(parts), jnp.asarray(w), key, jmesh.make_mesh(particle=particle_ax),
        halo=2048))
    u = torch.tensor(np.asarray(jax.random.uniform(key, (), jnp.float32)))
    got = RD.systematic_resample_gather_dist(torch.from_numpy(parts), torch.from_numpy(w), u,
                                             _cpu_mesh(particle=particle_ax), halo=2048)
    np.testing.assert_array_equal(got.numpy(), want)
    whole = torch.from_numpy(parts)[:, R.systematic_resample(u, torch.from_numpy(w)).long()]
    assert torch.equal(got, whole)


def test_dist_resample_exact_branch_on_tiny_halo(jx):
    """A halo too small for the ancestor spread takes the exact branch
    (counted) and still gives the reference's columns."""
    jax, jnp, _, jmesh, jrd = jx
    n = 1 << 17
    parts, w = _bank(n, seed=3), _weights(n, "collapse", seed=3)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jrd.systematic_resample_gather_dist(
        jnp.asarray(parts), jnp.asarray(w), key, jmesh.make_mesh(particle=8), halo=128))
    u = torch.tensor(np.asarray(jax.random.uniform(key, (), jnp.float32)))
    RD.exact_fallbacks = 0
    got = RD.systematic_resample_gather_dist(torch.from_numpy(parts), torch.from_numpy(w), u,
                                             _cpu_mesh(particle=8), halo=128)
    assert RD.exact_fallbacks == 1
    np.testing.assert_array_equal(got.numpy(), want)
    # healthy weights take the fast branch
    RD.systematic_resample_gather_dist(torch.from_numpy(parts),
                                       torch.from_numpy(_weights(n, "uniform")), u,
                                       _cpu_mesh(particle=8), halo=128)
    assert RD.exact_fallbacks == 1


def test_batched_dist_resample_matches_jax(jx):
    """The fleet form over (mission, particle) against the reference's, per
    mission on its key's uniform (``tests/test_pf_pmesh.py:114``)."""
    jax, jnp, J, jmesh, jrd = jx
    B, n = 4, 1 << 14
    rng = np.random.default_rng(0)
    parts = rng.normal(size=(B, 6, n)).astype(np.float32)
    w = rng.exponential(1.0, (B, n)).astype(np.float32)
    w = (w / w.sum(axis=1, keepdims=True)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    want = np.asarray(jrd.systematic_resample_gather_dist_batched(
        jnp.asarray(parts), jnp.asarray(w), keys, jmesh.make_mesh(mission=2, particle=4)))
    u = torch.tensor(np.stack([np.asarray(jax.random.uniform(k, (), jnp.float32)) for k in keys]))
    got = RD.systematic_resample_gather_dist_batched(
        torch.from_numpy(parts), torch.from_numpy(w), u, _cpu_mesh(mission=2, particle=4))
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="not divisible by mission axis"):
        RD.systematic_resample_gather_dist_batched(
            torch.from_numpy(parts[:3]), torch.from_numpy(w[:3]), u[:3],
            _cpu_mesh(mission=2, particle=4))


def test_last_count_is_n_for_a_uniform_near_one():
    """n·1 - u rounds to n - 1 in f32 for u close enough to 1 (here n =
    2^17, u > 1 - 2^-8): the counts still end at n, so the last slot has an
    owner, and the distributed resample (whose last shard would otherwise
    reach into its zero right halo) is bitwise the unsharded one."""
    n, u = 1 << 17, 0.999
    w = torch.from_numpy(_weights(n, "skewed", seed=8))
    m = R.systematic_counts(w, u)
    assert int(m[-1]) == n
    parts = torch.from_numpy(_bank(n, seed=8))
    whole = parts[:, R.systematic_resample(u, w).long()]
    assert torch.equal(whole, K.expand_gather_window_call(m, parts, 0, n))
    got = RD.systematic_resample_gather_dist(parts, w, u, _cpu_mesh(particle=4))
    assert torch.equal(got, whole) and bool(got[:, -1].abs().sum() > 0)


def test_shard_body_requires_tiling():
    shards = [torch.zeros(6, 1024)] * 2
    with pytest.raises(ValueError, match="violate tiling"):
        RD.systematic_gather_shard(shards, [torch.ones(1024)] * 2, 0.5, halo=128)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["healthy", "degenerate", "zero-run"])
def test_window_kernel_matches_plain(cuda, kind):
    n_out = 1 << 16
    n_in = n_out + 2 * 4096
    m = torch.from_numpy(_window_case(kind, n_in, lo=3000, seed=9)).to(cuda)
    parts = torch.from_numpy(_bank(n_in, seed=5)).to(cuda)
    for off in (0, 3000 + 4096, max(0, int(m[-1]) - n_out), int(m[-1]) + 1):
        got = K.expand_gather_window_call(m, parts, off, n_out)
        torch.cuda.synchronize()
        assert torch.equal(got, K.expand_gather_window_call_reference(m, parts, off, n_out))
        # odd widths take the slot-at-a-time store
        got = K.expand_gather_window_call(m, parts, off, n_out - 3)
        assert torch.equal(got, K.expand_gather_window_call_reference(m, parts, off, n_out - 3))


@pytest.mark.cuda
def test_whole_bank_k7_is_the_window_form(cuda):
    n = 1 << 18
    w = torch.from_numpy(_weights(n, "skewed", seed=6)).to(cuda)
    m = R.systematic_counts(w, 0.3)
    parts = torch.from_numpy(_bank(n, seed=6)).to(cuda)
    assert torch.equal(K.expand_gather_window_call(m, parts, 0, n), K.expand_gather_call(m, parts))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["uniform", "collapse"])
def test_dist_resample_four_shards_on_one_card(cuda, kind):
    n = 1 << 18
    w = torch.from_numpy(_weights(n, kind)).to(cuda)
    parts = torch.from_numpy(_bank(n)).to(cuda)
    pm = mesh.make_mesh(particle=4, devices=[cuda] * 4)
    launches = K.expand_gather_window_call.launches
    got = RD.systematic_resample_gather_dist(parts, w, 0.25, pm)
    assert K.expand_gather_window_call.launches == launches + 4
    assert torch.equal(got, parts[:, R.systematic_resample(0.25, w).long()])
