"""The port's PF kernels K5-K8 (``ops/pf_kernels.py``) against the JAX
package's, on the same numpy inputs made from a seed.

On the CPU the port's wrappers take their plain PyTorch versions; the JAX
side runs its Pallas kernels in TPU-interpret mode, as the JAX package's own
tests do. Its interpret-mode PRNG is degenerate and its hardware bits cannot
be reproduced anyway, so every comparison with JAX has the noise stds at
zero; the port's generator is pinned by a numpy restatement of its hash and
held by its statistics. The ``cuda`` tests hold each CUDA kernel against its
plain version on the card and skip where there is none.

Tolerances and why: banks agree to 1e-5 absolute (the JAX kernels use a sin
polynomial with 1.9e-7 error, the port libm); moment sums to 2e-5 relative
(f32 sums in another order); resample ancestors fed the same counts are
exact. On the card, kernel against plain version: uniforms and the gathers
bitwise, floats to 1e-4 of the output's scale (the special-function unit's
log and sin/cos, ~2^-21 absolute, against torch.log/sin/cos, and sums in
block order), angles compared modulo 2π.
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

N = 4096


@pytest.fixture(scope="module")
def jx():
    """The JAX reference, imported here rather than at the top so that the
    ``cuda`` tests of this file also run where only PyTorch is installed."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from smarc_navigation_tpu.ops import pf_kernels, resampling

    return jax, jnp, pltpu, pf_kernels, resampling


def _t(x, device="cpu"):
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def _bank(seed, n=N):
    rng = np.random.default_rng(seed)
    p = rng.normal(0, 2.0, (6, n)).astype(np.float32)
    p[5] = rng.uniform(-3.1, 3.1, n)
    return p


def _mission_par16(motion_cov=(0.0,) * 6, K_=12):
    """par16 rows and seeds of the real PF mission's ticks 0..K-1."""
    tl = P.pf_timeline(sim.simulate(sim.MissionSpec(duration_s=15.0, seed=3,
                                                    gps_surface_z=-100.0))).to("cpu")
    params = P.make_params(PFConfig(motion_cov=motion_cov), device="cpu")
    pre = P._tick_precompute(tl, params, torch.Generator().manual_seed(4))
    return pre.par16[:K_].contiguous(), pre.seeds[:K_].contiguous()


def _close(got, want, rtol=0.0, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------

def _np_mix32(x):
    x = np.asarray(x, np.uint32)
    with np.errstate(over="ignore"):
        x ^= x >> np.uint32(16)
        x *= np.uint32(0x7FEB352D)
        x ^= x >> np.uint32(15)
        x *= np.uint32(0x846CA68B)
        x ^= x >> np.uint32(16)
    return x


def test_uniforms_match_the_hash_definition():
    """The torch integer ops compute the CUDA source's hash: mix32 with
    uint32 wraparound, key = mix32(seed + 0x9E3779B9·(draw+1)), bits =
    mix32(mix32(idx ^ key) + key), uniform = (bits>>8 + 0.5) / 2^24."""
    idx = np.arange(5000, dtype=np.uint32) * np.uint32(977) + np.uint32(4_000_000_000)
    for seed, draw in [(0, 0), (12345, 1), (2**31 - 2, 3)]:
        with np.errstate(over="ignore"):
            key = _np_mix32(np.uint32(seed) + np.uint32(0x9E3779B9) * np.uint32(draw + 1))
            bits = _np_mix32(_np_mix32(idx ^ key) + key)
        want = (bits >> np.uint32(8)).astype(np.float32) * np.float32(1 / 2**24) \
            + np.float32(0.5 / 2**24)
        got = K.uniforms(torch.tensor(seed, dtype=torch.int32),
                         torch.from_numpy(idx.astype(np.int64)), draw).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.min() > 0 and got.max() <= 1


def test_normals_statistics_and_keying():
    idx = torch.arange(1 << 15, dtype=torch.int64)
    nx, ny, nw = K.normals3(torch.tensor(7), idx)
    for v in (nx, ny, nw):
        assert abs(float(v.mean())) < 0.02 and abs(float(v.std()) - 1.0) < 0.02
    z = torch.stack([nx, ny, nw])
    c = torch.corrcoef(z)
    assert float((c - torch.eye(3)).abs().max()) < 0.03
    # fourth moment of a normal is 3
    assert abs(float((nx ** 4).mean()) - 3.0) < 0.15
    # neighbouring seeds and draws are uncorrelated streams
    nx2, _, _ = K.normals3(torch.tensor(8), idx)
    assert abs(float(torch.corrcoef(torch.stack([nx, nx2]))[0, 1])) < 0.03
    # a particle's draw depends on its global index only (the K8 seed_off):
    # the integer stream bitwise; the normals, whose last bits depend on how
    # torch's CPU log/cos split the call, each against Box-Muller in float64
    # on those same uniforms, within what f32 rounding allows: log and cos
    # within a few ulps, 2π·u rounded twice (|δang| <= 2ε·ang), so
    # |x - x64| <= ε·r·(16 + 2·ang) with ε = 2^-24
    for draw in range(4):
        assert torch.equal(K.uniforms(torch.tensor(7), idx[100:], draw),
                           K.uniforms(torch.tensor(7), idx, draw)[100:])
    u0, u1 = (K.uniforms(torch.tensor(7), idx, d).double() for d in (0, 1))
    r, ang = torch.sqrt(-2.0 * torch.log(u0)), 2.0 * math.pi * u1
    x64, bound = r * torch.cos(ang), 2.0 ** -24 * r * (16.0 + 2.0 * ang)
    part = K.normals3(torch.tensor(7), idx[100:])[0]
    for got, want, tol in ((nx, x64, bound), (part, x64[100:], bound[100:])):
        assert bool(((got.double() - want).abs() <= tol).all())


def _np_unmix32(x):
    """The inverse of ``_np_mix32`` (on a copy of x)."""
    x = np.array(x, np.uint32)
    with np.errstate(over="ignore"):
        x ^= x >> np.uint32(16)
        x *= np.uint32(pow(0x846CA68B, -1, 1 << 32))
        x ^= (x >> np.uint32(15)) ^ (x >> np.uint32(30))
        x *= np.uint32(pow(0x7FEB352D, -1, 1 << 32))
        x ^= x >> np.uint32(16)
    return x


def _jitter_near_one(device):
    """K8 (one particle a call) at the global indices whose x-radius draw
    (0) or yaw-radius draw (2) is one of the 32 uniforms nearest 1, found by
    inverting the hash: -> (the uniforms in float64, the x and yaw noise of
    the kernel path, and of the plain version), each (2, 32); all the
    moment sums are checked finite on the way."""
    seed = 21
    bits = (np.uint32(1 << 24) - np.arange(1, 33, dtype=np.uint32)) << np.uint32(8)
    sd = torch.ones(3, device=device)
    seed_t = torch.tensor(seed, dtype=torch.int32, device=device)
    bank = torch.zeros((6, 1), device=device)
    u, got, plain = [], [], []
    for draw, row in ((0, 0), (2, 5)):
        with np.errstate(over="ignore"):
            key = _np_mix32(np.uint32(seed) + np.uint32(0x9E3779B9) * np.uint32(draw + 1))
            idx = _np_unmix32(_np_unmix32(bits) - key) ^ key
        u.append(K.uniforms(torch.tensor(seed), torch.from_numpy(idx.astype(np.int64)),
                            draw).double())
        g, p = [], []
        for i in idx.astype(np.int64):
            off = int(i) - (1 << 32) if i >= 1 << 31 else int(i)   # the int32 seed_off
            out, sums = K.jitter_moments_call(bank, sd, seed_t, seed_off=off)
            assert bool(torch.isfinite(out).all() and torch.isfinite(sums).all()), (draw, off)
            g.append(float(out[row, 0]))
            p.append(float(K.jitter_moments_call_reference(bank, sd, seed_t, off)[0][row, 0]))
        got.append(g)
        plain.append(p)
    return torch.stack(u), torch.tensor(got, dtype=torch.float64), torch.tensor(plain,
                                                                              dtype=torch.float64)


def test_jitter_draws_near_one_are_finite():
    """The generator's largest uniforms (1 - k·2^-24, k <= 32) through the
    jitter's Box-Muller: finite, and each noise within its float64 radius
    sqrt(-2 ln u) (<= 2e-3 here) plus f32 rounding."""
    u, got, _ = _jitter_near_one("cpu")
    assert bool((u >= 1.0 - 32 * 2.0 ** -24).all())
    assert bool((got.abs() <= torch.sqrt(-2.0 * torch.log(u)) + 1e-6).all())


# ---------------------------------------------------------------------------
# K5 / K6 against the JAX kernels (zero noise)
# ---------------------------------------------------------------------------

def test_predict_multi_matches_jax(jx):
    jax, jnp, pltpu, JK, _ = jx
    par16, seeds = _mission_par16()
    parts = _bank(1)
    nt = 9
    with pltpu.force_tpu_interpret_mode():
        jout, jsums = JK.predict_call_multi(jnp.asarray(parts), jnp.asarray(par16.numpy()),
                                            jnp.asarray(seeds.numpy()), nxy=False,
                                            nyaw=False, nticks=nt)
    jout, jsums = np.asarray(jout), np.asarray(jsums).sum(-1)
    for flags in [(False, False), (True, True)]:   # zero stds: noise on adds 0
        out, sums = K.predict_call_multi(_t(parts), par16, seeds, *flags, nticks=nt)
        assert sums.shape == (12, 8, K.n_partials(N))
        _close(out.numpy(), jout)
        tot = sums.sum(-1).numpy()
        _close(tot, jsums, rtol=2e-5, atol=1e-3)
        assert (tot[nt:] == 0).all() and (jsums[nt:] == 0).all()


def test_predict_call_and_fused_moments_match_jax(jx):
    jax, jnp, pltpu, JK, _ = jx
    par16, seeds = _mission_par16()
    parts = _bank(2)
    with pltpu.force_tpu_interpret_mode():
        jout, jsums = JK.predict_call(jnp.asarray(parts), jnp.asarray(par16[3].numpy()),
                                      jnp.int32(seeds[3]))
        odom = jnp.zeros(13).at[6].set(1.0).at[7].set(0.8).at[12].set(0.05).at[2].set(-3.0)
        jf = JK.fused_predict_moments(jnp.asarray(parts), odom, 0.1, jnp.zeros(6), 1)
    out, sums = K.predict_call(_t(parts), par16[3], seeds[3])
    _close(out.numpy(), np.asarray(jout))
    _close(sums.sum(-1).numpy(), np.asarray(jsums).sum(-1), rtol=2e-5, atol=1e-3)
    tf = K.fused_predict_moments(_t(parts), _t(np.asarray(odom)), 0.1, torch.zeros(6), 1)
    _close(tf[0].numpy(), np.asarray(jf[0]))
    _close(tf[1].numpy(), np.asarray(jf[1]), atol=1e-4)
    _close(tf[2].numpy(), np.asarray(jf[2]), atol=1e-4)


def test_finalize_moments_matches_jax(jx):
    jax, jnp, pltpu, JK, _ = jx
    sums = np.random.default_rng(3).normal(1.0, 0.3, (5, 8, 128)).astype(np.float32)
    sums[:, 7] = 16.0
    z, roll, pitch = np.float32(-3.0), np.float32(0.1), np.float32(-0.05)
    jm, jc = JK.finalize_moments(jnp.asarray(sums), z, roll, pitch)
    m, c = K.finalize_moments(_t(sums), z, roll, pitch)
    _close(m.numpy(), np.asarray(jm), atol=1e-6)
    _close(c.numpy(), np.asarray(jc), atol=1e-6)
    # the kernels' (..., 8, P) partials finalize the same as lane partials
    p = _bank(5)
    m1, c1 = K.finalize_moments(K.moment_sums(_t(p)), z, roll, pitch)
    m2, c2 = JK.finalize_moments(JK.moment_sums(jnp.asarray(p)), z, roll, pitch)
    _close(m1.numpy(), np.asarray(m2), atol=1e-5)
    _close(c1.numpy(), np.asarray(c2), atol=1e-4)


# ---------------------------------------------------------------------------
# K7 / K8 against the JAX kernels
# ---------------------------------------------------------------------------

def _weights(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "skewed":
        w = rng.random(n) ** 4
    elif kind == "degenerate":
        w = np.zeros(n)
        w[777] = 1.0
    else:                    # long zero-count runs: mass only at the two ends
        w = np.zeros(n)
        w[:64] = 1.0
        w[-64:] = 1.0
    return (w / w.sum()).astype(np.float32)


@pytest.mark.parametrize("kind,n,block", [("skewed", 2048, 512), ("degenerate", 2048, 512),
                                          ("zero_runs", 4096, 512), ("skewed", 8192, 256)])
def test_systematic_resample_gather_matches_jax(jx, kind, n, block):
    jax, jnp, pltpu, JK, JR = jx
    parts = _bank(n + 3, n)
    w = _weights(kind, n, n)
    key = jax.random.PRNGKey(n + 11)
    u = np.float32(jax.random.uniform(key, (), jnp.float32))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JK.systematic_resample_gather(jnp.asarray(parts), jnp.asarray(w),
                                                        key, block=block))
    m_cum = np.asarray(JR.systematic_counts(jnp.asarray(w), u))
    # fed the same counts, K7's plain version is exact
    np.testing.assert_array_equal(K.expand_gather_call(_t(m_cum), _t(parts)).numpy(), want)
    got = K.systematic_resample_gather(_t(parts), _t(w), torch.tensor(u)).numpy()
    if np.array_equal(R.systematic_counts(_t(w), torch.tensor(u)).numpy(), m_cum):
        np.testing.assert_array_equal(got, want)
    if kind == "degenerate":
        np.testing.assert_array_equal(got, np.broadcast_to(parts[:, 777:778], parts.shape))


def test_fused_jitter_with_zero_sd_matches_jax_moments(jx):
    """jitter_sd = 0: the bank equals the plain gather exactly and the sums
    match the JAX package's ``moment_sums`` of it."""
    jax, jnp, pltpu, JK, JR = jx
    n = 8192
    parts = _bank(21, n)
    w = _weights("skewed", n, 22)
    u = torch.tensor(0.41)
    plain = K.systematic_resample_gather(_t(parts), _t(w), u)
    out, sums = K.systematic_resample_gather(_t(parts), _t(w), u, jitter_sd=torch.zeros(3),
                                             seed=torch.tensor(7, dtype=torch.int32))
    np.testing.assert_array_equal(out.numpy(), plain.numpy())
    ref = np.asarray(JK.moment_sums(jnp.asarray(out.numpy()))).sum(-1)
    _close(sums.sum(-1).numpy(), ref, rtol=2e-5, atol=2e-4)


def test_jitter_paths_agree_and_are_shard_invariant():
    """K7 with the fused jitter equals K8 applied to K7's plain gather (the
    plain versions, bitwise); K8 over a shard with seed_off reproduces the
    whole bank's stream."""
    n = 3000                                   # not a multiple of the block
    parts = _t(_bank(31, n))
    m_cum = R.systematic_counts(_t(_weights("skewed", n, 32)), torch.tensor(0.2))
    sd = torch.tensor([0.5, 0.25, 0.1])
    seed = torch.tensor(99, dtype=torch.int32)
    fused, s1 = K.expand_gather_call(m_cum, parts, sd, seed)
    two, s2 = K.jitter_moments_call(K.expand_gather_call(m_cum, parts), sd, seed)
    assert torch.equal(fused, two) and torch.equal(s1, s2)
    tail, _ = K.jitter_moments_call(two[:, 1000:].contiguous(), sd, seed, seed_off=1000)
    whole, _ = K.jitter_moments_call(two, sd, seed)
    torch.testing.assert_close(tail, whole[:, 1000:], rtol=1e-6, atol=1e-6)
    d = (fused - K.expand_gather_call(m_cum, parts)).numpy()
    assert (d[[2, 3, 4]] == 0).all()
    for row, s in ((0, 0.5), (1, 0.25), (5, 0.1)):
        assert abs(d[row].std() / s - 1.0) < 0.06


def test_wrappers_check_their_contract():
    parts = _t(_bank(1))
    par16, seeds = _mission_par16()
    n0 = (K.predict_call_multi.launches, K.expand_gather_call.launches)
    K.predict_call_multi(parts, par16, seeds, nticks=3)
    assert (K.predict_call_multi.launches, K.expand_gather_call.launches) == n0
    with pytest.raises(ValueError, match="nticks"):
        K.predict_call_multi(parts, par16, seeds, nticks=13)
    with pytest.raises(ValueError, match="contiguous"):
        K.predict_call_multi(parts[:, :-1], par16, seeds)
    with pytest.raises(ValueError, match="shape"):
        K.predict_call_multi(parts, par16[:, :8].contiguous(), seeds)
    with pytest.raises(TypeError, match="dtype"):
        K.predict_call_multi(parts, par16, seeds.long())
    with pytest.raises(ValueError, match="ticks per call"):
        K.predict_call_multi(parts, par16.repeat(6, 1), seeds.repeat(6))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        K.predict_call_multi(parts.to("meta"), par16.to("meta"), seeds.to("meta"))
    with pytest.raises(ValueError, match="seed"):
        K.jitter_moments_call(parts, torch.zeros(3), None)


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _max_err(got, want, angle=False):
    d = got.double().cpu() - want.double().cpu()
    if angle:
        d = torch.remainder(d + math.pi, 2 * math.pi) - math.pi
    scale = max(1.0, float(want.abs().max()))
    return float(d.abs().max()) / scale


def _bank_err(got, want):
    return max(_max_err(got[[0, 1, 2, 3, 4]], want[[0, 1, 2, 3, 4]]),
               _max_err(got[5], want[5], angle=True))


@pytest.mark.cuda
def test_uniforms_kernel_bitwise(cuda):
    for seed, draw, off in [(5, 0, 0), (2**31 - 2, 3, 12345)]:
        got = K.uniforms_call(seed, 100_000, draw, cuda, seed_off=off).cpu()
        assert torch.equal(got, K.uniforms_call(seed, 100_000, draw, "cpu", seed_off=off))


@pytest.mark.cuda
def test_jitter_kernel_draws_near_one(cuda):
    """The kernel path's Box-Muller at the uniforms nearest 1: |ln u| is
    there below the special-function unit's log error (2^-21.4 absolute), so
    without the clamp the radius's argument may come out negative and the
    particle NaN. Finite, and within 1e-3 of the plain version: an error of
    2·2^-21.4 in r² moves r by at most sqrt(2^-20.4) < 1e-3."""
    u, got, plain = _jitter_near_one(cuda)
    assert bool((u >= 1.0 - 32 * 2.0 ** -24).all())
    assert float((got - plain).abs().max()) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [(True, True), (False, True), (False, False)])
def test_predict_kernels_match_plain(cuda, flags):
    par16, seeds = _mission_par16(motion_cov=(0.01, 0.02, 0, 0, 0, 1e-4))
    parts = _t(_bank(3, 50_000), cuda)
    p16, sd = par16.to(cuda), seeds.to(cuda)
    n0 = K.predict_call_multi.launches
    out, sums = K.predict_call_multi(parts, p16, sd, *flags, nticks=9)
    torch.cuda.synchronize()
    assert K.predict_call_multi.launches == n0 + 1
    ro, rs = K.predict_call_multi_reference(parts, p16, sd, *flags, nticks=9)
    assert _bank_err(out, ro) < 1e-4 and _max_err(sums, rs) < 1e-4
    assert (sums[9:] == 0).all()
    # K6 is K5 at K = 1, bitwise
    o1, s1 = K.predict_call(parts, p16[0], sd[0], *flags)
    o2, s2 = K.predict_call_multi(parts, p16[:1], sd[:1], *flags)
    assert torch.equal(o1, o2) and torch.equal(s1, s2[0])
    r1, rs1 = K.predict_call_reference(parts, p16[0], sd[0], *flags)
    assert _bank_err(o1, r1) < 1e-4 and _max_err(s1, rs1) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["skewed", "degenerate", "zero_runs"])
def test_resample_kernels_match_plain(cuda, kind):
    n = 40_000
    parts = _t(_bank(5, n), cuda)
    m_cum = R.systematic_counts(_t(_weights(kind, n, 6), cuda), torch.tensor(0.3, device=cuda))
    got = K.expand_gather_call(m_cum, parts)
    torch.cuda.synchronize()
    assert torch.equal(got, K.expand_gather_call_reference(m_cum, parts))
    sd = torch.tensor([1.0, 1.0, 0.01], device=cuda)
    seed = torch.tensor(17, dtype=torch.int32, device=cuda)
    fused, s1 = K.expand_gather_call(m_cum, parts, sd, seed)
    rf, rs = K.expand_gather_call_reference(m_cum, parts, sd, seed)
    assert _bank_err(fused, rf) < 1e-4 and _max_err(s1, rs) < 1e-4
    two, s2 = K.jitter_moments_call(got, sd, seed)
    torch.cuda.synchronize()
    assert torch.equal(fused, two) and torch.equal(s1, s2)
    r8, rs8 = K.jitter_moments_call_reference(got, sd, seed)
    assert _bank_err(two, r8) < 1e-4 and _max_err(s2, rs8) < 1e-4


def _count_weights(kind, n, seed):
    """Weights whose systematic counts stress K7's merge partition: one
    particle takes every slot (degenerate, or the last particle), mass only
    at the two ends (long zero-count runs), or random."""
    if kind in ("degenerate", "zero_runs"):
        return _weights(kind, n, seed)
    w = np.zeros(n)
    if kind == "all_on_last":
        w[-1] = 1.0
    else:
        w = np.random.default_rng(seed).random(n) ** 3
    return (w / w.sum()).astype(np.float32)


# n not a multiple of 4 (no 16-byte stores) nor of 1024 (a part group), one
# a multiple of 4 only, one below a group
@pytest.mark.cuda
@pytest.mark.parametrize("n", [1023, 4098, 40_004, 1_000_003])
@pytest.mark.parametrize("kind", ["degenerate", "zero_runs", "all_on_last", "random"])
def test_resample_kernel_any_n_and_counts(cuda, n, kind):
    parts = _t(_bank(n % 97, n), cuda)
    m_cum = R.systematic_counts(_t(_count_weights(kind, n, 9), cuda),
                                torch.tensor(0.6, device=cuda))
    n0 = K.expand_gather_call.launches
    got = K.expand_gather_call(m_cum, parts)
    torch.cuda.synchronize()
    assert K.expand_gather_call.launches == n0 + 1
    assert torch.equal(got, K.expand_gather_call_reference(m_cum, parts))
    sd = torch.tensor([0.5, 0.5, 0.02], device=cuda)
    seed = torch.tensor(3, dtype=torch.int32, device=cuda)
    fused, s1 = K.expand_gather_call(m_cum, parts, sd, seed)
    rf, rs = K.expand_gather_call_reference(m_cum, parts, sd, seed)
    assert _bank_err(fused, rf) < 1e-4 and _max_err(s1, rs) < 1e-4
    two, s2 = K.jitter_moments_call(got, sd, seed)
    torch.cuda.synchronize()
    assert torch.equal(fused, two) and torch.equal(s1, s2)
    # an 8-row bank: the two extra rows are gathered too
    p8 = torch.cat([parts, parts[:2] * 3.0])
    assert torch.equal(K.expand_gather_call(m_cum, p8), K.expand_gather_call_reference(m_cum, p8))


# every nticks of a K-row call, at group counts that leave the persistent
# grid's blocks uneven (one group; a few; many, not a multiple of the grid;
# a part group at the end), on n with and without 16-byte rows
@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, 5 * 1024 + 3, 977 * 1024 + 4, (1 << 20) + 1])
def test_predict_kernels_every_nticks(cuda, n):
    par16, seeds = _mission_par16(motion_cov=(0.01, 0.02, 0, 0, 0, 1e-4), K_=6)
    parts = _t(_bank(n % 89, n), cuda)
    p16, sd = par16.to(cuda), seeds.to(cuda)
    for flags in ((False, True), (True, True)):
        for nt in range(0, 7):
            out, sums = K.predict_call_multi(parts, p16, sd, *flags, nticks=nt)
            torch.cuda.synchronize()
            ro, rs = K.predict_call_multi_reference(parts, p16, sd, *flags, nticks=nt)
            assert _bank_err(out, ro) < 1e-4 and _max_err(sums, rs) < 1e-4, (flags, nt)
            assert (sums[nt:] == 0).all()
            if nt == 0:
                assert torch.equal(out, parts)
        o1, s1 = K.predict_call(parts, p16[0], sd[0], *flags)
        o2, s2 = K.predict_call_multi(parts, p16[:1], sd[:1], *flags)
        assert torch.equal(o1, o2) and torch.equal(s1, s2[0])
        # a K-tick call is its ticks one by one through K6, bit for bit
        step, ssum = parts, []
        for t in range(6):
            step, s = K.predict_call(step, p16[t], sd[t], *flags)
            ssum.append(s)
        assert torch.equal(out, step) and torch.equal(sums, torch.stack(ssum))
