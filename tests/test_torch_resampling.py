"""The port's resampling schemes (``ops/resampling.py``) against the JAX
package's on the same numpy inputs made from a seed.

Tolerances and why:
- ``tree_sum`` is bitwise: every addition is an elementwise f32 add in a
  pinned order.
- ``normalize_weights_det`` is bitwise where both frameworks' f32 ``exp``
  agree (XLA's and torch's differ by one ulp on ~9% of inputs), and within
  4 ulp otherwise; the sum and divide after the exp are order-pinned.
- ``systematic_counts``: the blocked CDF's scans add in the order of the
  JAX package's ``jnp.cumsum`` on the CPU (``prefix_sum``), so the counts
  are bitwise where the weights are (``tests/test_torch_resample_dist.py``);
  the checks here allow ±1 at a stratum boundary all the same.
- ancestors from the same counts (``_expand_blocks``) and the schemes fed
  the same uniforms are exact, up to those boundary flips.
"""

import numpy as np
import pytest
import torch

from smarc_navigation_tpu_torch.ops import resampling as TR


@pytest.fixture(scope="module")
def jr():
    import jax.numpy as jnp

    from smarc_navigation_tpu.ops import resampling

    return jnp, resampling


def _weights(seed, n, power=3.0):
    rng = np.random.default_rng(seed)
    w = (rng.random(n) ** power).astype(np.float32)
    return (w / w.sum()).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


@pytest.mark.parametrize("n", [1000, 2048, 6144])
def test_tree_sum_bitwise(jr, n):
    jnp, J = jr
    x = np.random.default_rng(n).normal(0, 1, n).astype(np.float32)
    assert np.asarray(J.tree_sum(jnp.asarray(x))).tobytes() == \
        TR.tree_sum(_t(x)).numpy().tobytes()


@pytest.mark.parametrize("n", [3000, 8192])
def test_normalize_weights_det(jr, n):
    jnp, J = jr
    logw = (-0.5 * np.random.default_rng(n).normal(0, 3, n) ** 2).astype(np.float32)
    logw[7] = -np.inf
    got = TR.normalize_weights_det(_t(logw)).numpy()
    want = np.asarray(J.normalize_weights_det(jnp.asarray(logw)))
    ulp = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
    assert ulp.max() <= 4
    # where the two exps agree, the pinned tail makes the result bitwise
    e_t = torch.exp(_t(logw) - _t(logw).max()).numpy()
    e_j = np.asarray(jnp.exp(jnp.asarray(logw) - jnp.max(jnp.asarray(logw))))
    same = np.where(e_t == e_j, logw, -np.inf).astype(np.float32)
    assert (e_t != e_j).any() and np.isfinite(same).sum() > n // 2
    np.testing.assert_array_equal(TR.normalize_weights_det(_t(same)).numpy(),
                                  np.asarray(J.normalize_weights_det(jnp.asarray(same))))


@pytest.mark.parametrize("n,u", [(1000, 0.37), (8192, 0.91), (8192, 0.0)])
def test_systematic_counts_and_expand(jr, n, u):
    jnp, J = jr
    w = _weights(n + 1, n)
    u = np.float32(u)
    got = TR.systematic_counts(_t(w), torch.tensor(u)).numpy()
    want = np.asarray(J.systematic_counts(jnp.asarray(w), u))
    assert got.dtype == np.int32 and got[-1] == n
    assert np.abs(got - want).max() <= 1
    assert (np.diff(got) >= 0).all()
    # ancestors from the same counts are exact
    np.testing.assert_array_equal(TR._expand_blocks(_t(want)).numpy(),
                                  np.asarray(J._expand_blocks(jnp.asarray(want))))
    np.testing.assert_array_equal(TR.systematic_resample(torch.tensor(u), _t(w)).numpy(),
                                  TR._expand_blocks(_t(got)).numpy())


def _flips(got, want):
    """Slots whose ancestors differ, allowed only next to a stratum boundary
    (neighbouring ancestors)."""
    d = np.abs(got.astype(np.int64) - want)
    return int((d > 0).sum()), int(d.max()) if d.size else 0


@pytest.mark.parametrize("scheme", ["systematic", "stratified", "multinomial", "residual"])
def test_schemes_match_on_same_uniforms(jr, scheme):
    import jax

    jnp, J = jr
    n = 4096
    w = _weights(11, n)
    key = jax.random.PRNGKey(5)
    shape = () if scheme == "systematic" else (n,)
    u = np.asarray(jax.random.uniform(key, shape, jnp.float32))
    want = np.asarray(J.SCHEMES[scheme](key, jnp.asarray(w)))
    got = TR.SCHEMES[scheme](_t(u), _t(w)).numpy()
    assert got.dtype == np.int32 and got.shape == (n,)
    assert got.min() >= 0 and got.max() < n
    n_flip, step = _flips(got, want)
    assert n_flip <= n // 1000 and step <= 1, (n_flip, step)


def test_degenerate_weights():
    n = 2048
    w = torch.zeros(n)
    w[777] = 1.0
    for scheme in TR.SCHEMES:
        u = torch.tensor(0.5) if scheme == "systematic" else torch.rand(n)
        assert (TR.SCHEMES[scheme](u, w) == 777).all(), scheme
    # zero-count runs: ancestors stay monotone and in range
    w = torch.zeros(n)
    w[:64] = 1.0
    w[-64:] = 1.0
    anc = TR.systematic_resample(torch.tensor(0.3), w / w.sum())
    assert (anc[1:] >= anc[:-1]).all() and set(anc.unique().tolist()) <= (
        set(range(64)) | set(range(n - 64, n)))


def test_generator_draws():
    """A ``torch.Generator`` stands in for the key: same generator state,
    same ancestors."""
    w = torch.from_numpy(_weights(3, 2048))
    a = TR.systematic_resample(torch.Generator().manual_seed(9), w)
    b = TR.systematic_resample(torch.Generator().manual_seed(9), w)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="shape"):
        TR.stratified_resample(torch.rand(5), w)
