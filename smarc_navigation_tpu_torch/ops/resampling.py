"""Particle resampling schemes (PyTorch port of
``smarc_navigation_tpu/ops/resampling.py``).

The four FilterPy-style samplers of the reference
(``auv_particle_filter/scripts/resampling.py:27-194``) as cumsum +
searchsorted / scatter + running max with static shapes. Every sampler
takes normalized weights (..., N) and returns (..., N) int32 ancestor
indices: leading axes are independent banks (a mission fleet), each
resampled along its last axis as a single (N,) bank would be.

Where the JAX package takes a PRNG key, these take their uniforms instead
(``u`` a scalar for the systematic scheme, an (N,) array for the others) or
a ``torch.Generator`` to draw them from; the tests hand both packages the
same uniforms. The order-pinned sums (``tree_sum``) and the blocked CDF keep
the reference's summation trees (the CDF's scans in the order the JAX
package's ``jnp.cumsum`` adds on the CPU, ``prefix_sum``), so a weight
vector gives the reference's value bit for bit where the operations are
elementwise. ``tree_sum_shard`` and ``normalize_weights_det_shard`` are
their shard bodies over a list of contiguous shards (``parallel.mesh``).

``systematic_counts`` is K14 on CUDA tensors (``csrc/pf_update.cu``: the
blocked CDF in the same order, the counts and their running max in one
launch; none in the JAX package, which leaves the counts to XLA) and its
plain version, ``systematic_counts_reference``, on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build, _tensors
from ..parallel import mesh

# Block size of the deterministic two-level prefix sum (see the reference:
# a bank split into shards that tile by the block sees the same summation
# tree as the whole bank).
CDF_BLOCK = 2048


def _uniforms(u, shape, like: torch.Tensor) -> torch.Tensor:
    """Uniforms on ``like``'s device and dtype: the given values, or drawn
    from a ``torch.Generator`` (on the generator's device, then moved)."""
    if isinstance(u, torch.Generator):
        u = torch.rand(shape, generator=u, device=u.device, dtype=like.dtype)
    u = torch.as_tensor(u, dtype=like.dtype, device=like.device)
    if tuple(u.shape) != tuple(shape):
        raise ValueError(f"uniforms of shape {tuple(u.shape)}, expected {tuple(shape)}")
    return u


def _blocks(x: torch.Tensor) -> torch.Tensor:
    """(..., N) -> (..., N / CDF_BLOCK, CDF_BLOCK)."""
    return x.reshape(*x.shape[:-1], x.shape[-1] // CDF_BLOCK, CDF_BLOCK)


def _tiles(n: int) -> bool:
    return n % CDF_BLOCK == 0 and n > CDF_BLOCK


# Chunk width of ``prefix_sum``'s recursive scan: the order in which the
# JAX package's ``jnp.cumsum`` adds on the CPU (XLA rewrites the cumulative
# reduce-window into a base-16 recursive scan)
SCAN_BASE = 16


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis in a pinned order: in
    chunks of ``SCAN_BASE`` (zero-padded at the end) a sequential sum, the
    chunk totals scanned the same way, recursively, and each chunk's
    exclusive carry added to it. Every addition is an elementwise f32 add,
    so the result is the same bits on the CPU and the card, and the JAX
    package's ``jnp.cumsum`` on the CPU bit for bit (``torch.cumsum`` adds
    in another order on each)."""
    n = x.shape[-1]
    if n <= SCAN_BASE:
        out = x.clone()
        for k in range(1, n):
            out[..., k].add_(out[..., k - 1])
        return out
    m = -(-n // SCAN_BASE) * SCAN_BASE
    if m != n:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (m - n,))], -1)
    inner = prefix_sum(x.reshape(x.shape[:-1] + (m // SCAN_BASE, SCAN_BASE)))
    tot = prefix_sum(inner[..., -1])
    carry = torch.cat([tot.new_zeros(tot.shape[:-1] + (1,)), tot[..., :-1]], -1)
    return (inner + carry[..., None]).reshape(x.shape[:-1] + (m,))[..., :n]


def blocked_cdf(weights: torch.Tensor) -> torch.Tensor:
    """Prefix sum along the last axis with a fixed two-level tree
    (intra-block scan + scan of block sums, each a ``prefix_sum``); one
    ``prefix_sum`` for banks that do not tile by CDF_BLOCK."""
    if not _tiles(weights.shape[-1]):
        return prefix_sum(weights)
    rowcum = prefix_sum(_blocks(weights))
    tot = prefix_sum(rowcum[..., -1])
    prefix = torch.cat([tot.new_zeros(tot.shape[:-1] + (1,)), tot[..., :-1]], -1)
    return (rowcum + prefix[..., None]).reshape(weights.shape)


def _fold_half(x: torch.Tensor) -> torch.Tensor:
    """Radix-2 fold-in-half sums along the last axis, zero-padded to a
    power of two: contiguous halves only, so every addition is
    elementwise."""
    n = x.shape[-1]
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (p - n,))], -1)
    while p > 1:
        p //= 2
        x = x[..., :p] + x[..., p:]
    return x[..., 0]


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Bit-deterministic sum along the last axis in the reference's pinned
    two-level fold-in-half order (within CDF_BLOCK-wide rows, then across the
    row sums). Every addition is an elementwise IEEE f32 add, so the value
    is the reference's bit for bit on any backend."""
    if not _tiles(x.shape[-1]):
        return _fold_half(x)
    return _fold_half(_fold_half(_blocks(x)))


def tree_sum_shard(x, axis_name: str = mesh.PARTICLE_AXIS) -> list:
    """Global ``tree_sum`` of a vector split into contiguous shards along
    ``axis_name``: ``x`` is the list of per-shard tensors (..., ns) in shard
    order (a shard body's stage, ``parallel.mesh``); returns the sum on each
    shard's device. Per-row folds on each shard, an all-gather of the row
    sums, then the same fold-in-half on every shard: bitwise
    ``tree_sum(concat(x))`` where ns tiles by CDF_BLOCK (rows never cross a
    shard boundary). Other shards gather the whole vector (same value, more
    bytes), as the reference does."""
    if x[0].shape[-1] % CDF_BLOCK:
        return [tree_sum(v) for v in mesh.all_gather(x, axis=-1)]
    rows = [_fold_half(_blocks(v)) for v in x]
    return [_fold_half(v) for v in mesh.all_gather(rows, axis=-1)]


def normalize_weights_det(logw: torch.Tensor) -> torch.Tensor:
    """exp(logw − max) + 1e-30, scaled by one ``tree_sum`` (the reference's
    add-floor-then-renormalize, ``auv_pf.py:163-166``), per bank."""
    m = torch.amax(logw, -1, keepdim=True)
    w = torch.exp(logw - m) + 1e-30
    return w / tree_sum(w)[..., None]


def normalize_weights_det_shard(logw, axis_name: str = mesh.PARTICLE_AXIS) -> list:
    """Shard body of ``normalize_weights_det`` over log-weights split into
    contiguous shards (``logw`` the list of (..., ns) shards in order):
    ``pmax`` is exactly associative and the sum goes through
    ``tree_sum_shard``, so each returned weight shard is BITWISE the same
    slice of the unsharded ``normalize_weights_det``, at any shard count."""
    ms = mesh.pmax([torch.amax(v, -1, keepdim=True) for v in logw])
    ws = [torch.exp(v - m) + 1e-30 for v, m in zip(logw, ms)]
    return [w / t[..., None] for w, t in zip(ws, tree_sum_shard(ws, axis_name))]


def systematic_counts_reference(weights: torch.Tensor, u) -> torch.Tensor:
    """Plain PyTorch version of ``systematic_counts``."""
    n = weights.shape[-1]
    u = _uniforms(u, weights.shape[:-1], weights)
    cdf = blocked_cdf(weights).clone()
    cdf[..., -1].fill_(1.0)   # guard round-off (the reference does the same)
    m_cum = torch.clamp(torch.ceil(n * cdf - u[..., None]), 0, n).to(torch.int32)
    # ... and the count it guards: n·1 - u rounds to n - 1 in f32 where 1 - u
    # is under half the f32 spacing below n (u > 1 - 2^-5 at n = 2^20), which
    # would leave slot n - 1 without an owner
    m_cum[..., -1].fill_(n)
    if not _tiles(n):
        return torch.cummax(m_cum, -1).values
    rows = torch.cummax(_blocks(m_cum), -1).values
    carry = torch.cummax(rows[..., -1], -1).values
    prev = torch.cat([carry.new_full(carry.shape[:-1] + (1,), torch.iinfo(torch.int32).min),
                      carry[..., :-1]], -1)
    return torch.maximum(rows, prev[..., None]).reshape(m_cum.shape)


def systematic_counts(weights: torch.Tensor, u) -> torch.Tensor:
    """Monotone cumulative ancestor counts m_cum[i] = #outputs owned by
    ancestors 0..i (int32, ending at N): cummax(clip(ceil(N·cdf − u))) over
    ``blocked_cdf``, per bank of the leading axes (``u`` one uniform per
    bank, a scalar for one bank, or a ``torch.Generator``).

    The cummax repair is the reference's blockwise form (within CDF_BLOCK
    rows, then a carry max across rows), equal to the global running max.
    On CUDA tensors K14 computes it, bit for bit the plain version, for
    float32 weights of any shape; CPU tensors take the plain version as
    they are."""
    if weights.device.type == "cpu":
        return systematic_counts_reference(weights, u)
    dev, shape = weights.device, tuple(weights.shape)
    if dev.type != "cuda":
        raise ValueError(f"systematic_counts runs on CUDA or CPU tensors, not {dev}")
    if weights.dim() < 1 or shape[-1] < 1:
        raise ValueError(f"systematic_counts: weights of shape {shape}, expected (..., N)")
    n = shape[-1]
    weights = _tensors.check(weights.contiguous(), "weights", shape, torch.float32, dev)
    u = _uniforms(u, shape[:-1], weights).contiguous()
    banks = weights.numel() // n
    out = torch.empty(shape, dtype=torch.int32, device=dev)
    fn = _build.load("pf_update").pf_counts_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int] \
            + [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
    words = _build.scratch_words("pf_update", "pf_counts_scratch_words", banks, n)
    scratch = torch.empty(words, dtype=torch.float32, device=dev) if words else None
    P = _tensors.ptr
    rc = fn(_tensors.device_index(dev), _tensors.stream(dev), banks, n, P(weights), P(u),
            P(out), P(scratch))
    _build.check(rc, "systematic_counts")
    _K14.launches += 1
    return out


# the wrapper counts its launches on itself, not through its module name,
# which an observer of the resamples may have replaced
_K14 = systematic_counts
_K14.launches = 0


def _inverse_cdf(weights: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    cdf = torch.cumsum(weights, -1).clone()
    cdf[..., -1].fill_(1.0)
    return torch.searchsorted(cdf, positions).to(torch.int32)


def _expand_blocks(m_cum: torch.Tensor) -> torch.Tensor:
    """Ancestor indices from a monotone count vector: slot j belongs to the
    smallest i with m_cum[i] > j. Scatter each ancestor's index at its start
    slot, then a running max (the reference's sort-free form)."""
    n = m_cum.shape[-1]
    starts = torch.cat([m_cum.new_zeros(m_cum.shape[:-1] + (1,)), m_cum[..., :-1]], -1)
    counts = m_cum - starts
    ids = torch.arange(n, dtype=torch.int32, device=m_cum.device)
    vals = torch.where(counts > 0, ids, torch.full_like(ids, -1))
    # a start of n belongs to a zero-count tail ancestor: clamped, its -1
    # mark cannot change the max (the reference drops it)
    marks = torch.full(m_cum.shape, -1, dtype=torch.int32, device=m_cum.device)
    marks = marks.scatter_reduce(-1, starts.clamp(max=n - 1).long(), vals, "amax")
    return torch.cummax(marks, -1).values


def systematic_resample(u, weights: torch.Tensor) -> torch.Tensor:
    """One offset ``u`` in [0,1), N evenly spaced positions
    (``resampling.py:135-168``): cumsum + scatter + running max."""
    return _expand_blocks(systematic_counts(weights, u))


def stratified_resample(u, weights: torch.Tensor) -> torch.Tensor:
    """One uniform per stratum, ``u`` (N,) (``resampling.py:80-114``)."""
    n = weights.shape[-1]
    u = _uniforms(u, weights.shape, weights)
    positions = (u + torch.arange(n, dtype=weights.dtype, device=weights.device)) / n
    return _inverse_cdf(weights, positions)


def multinomial_resample(u, weights: torch.Tensor) -> torch.Tensor:
    """IID draws from the weight distribution, ``u`` (N,)
    (``resampling.py:171-194``; the reference's sort of its uniforms only
    permutes slot order)."""
    return _inverse_cdf(weights, _uniforms(u, weights.shape, weights))


def residual_resample(u, weights: torch.Tensor) -> torch.Tensor:
    """Deterministic ⌊N·w⌋ copies + multinomial on the residual, ``u`` (N,)
    (``resampling.py:27-76``): slots [0, k) deterministic, [k, N) from the
    residual draws."""
    n = weights.shape[-1]
    u = _uniforms(u, weights.shape, weights)
    scaled = n * weights
    copies = torch.floor(scaled)
    k = torch.sum(copies, -1, keepdim=True).to(torch.int32)

    cum = torch.cumsum(copies, -1).to(torch.int32)
    det_idx = torch.clamp(_expand_blocks(cum), 0, n - 1)

    resid = scaled - copies
    resid = resid / torch.clamp(torch.sum(resid, -1, keepdim=True), min=1e-30)
    tail_idx = _inverse_cdf(resid, u)

    ar = torch.arange(n, device=weights.device)
    shift = torch.clamp(ar - k, 0, n - 1)
    return torch.where(ar < k, det_idx, torch.gather(tail_idx, -1, shift.expand(tail_idx.shape)))


SCHEMES = {
    "systematic": systematic_resample,
    "stratified": stratified_resample,
    "multinomial": multinomial_resample,
    "residual": residual_resample,
}
