"""Distributed systematic resample of a particle bank split over a mesh's
``particle`` axis (PyTorch port of
``smarc_navigation_tpu/parallel/resample_dist.py``).

A shard is a (..., 6, ns) column block of the bank on its mesh cell's
device; ``systematic_gather_shard`` runs the reference's shard body as
stages over the list of shards, with the explicit collectives of
``parallel.mesh`` between them:

1. **Global CDF from shard-local prefix sums.** Each shard cumsums its
   CDF_BLOCK rows; the per-block sums are all-gathered and each shard
   rebuilds its slice of the global blocked CDF: the same two-level
   summation tree as ``resampling.blocked_cdf``, so the counts are bitwise
   the single-device ones.
2. **Global monotone counts**: a local running max, then the max of the
   left shards' last counts.
3. **Halo exchange**: each shard takes H counts and bank columns from each
   neighbour (``from_left`` / ``from_right``), H = ``_clamped_halo``.
4. **Fit check**: every shard's needed ancestors lie in its extended
   window (``m_ext[0] <= g0`` and the last slot's ancestor inside it). The
   decision is one host sync per resample. The reference's third clause, a
   TPU VMEM window limit (``resample_dist.py:140``), is left out: the
   port's K7 has no window, and the clause only picks the branch.
5. **Fast branch**: K7's window form (``pf_kernels.
   expand_gather_window_call``) over the extended window, with the shard's
   global output offset g0 = s·ns.
6. **Exact branch** (some shard's ancestors lie outside its window: a
   weight collapse): all-gather the counts and the bank, then K7's window
   form over them at out_off = s·ns (the reference's ``_expand_blocks`` +
   take). Both branches launch the kernel on CUDA tensors and give the same
   ancestors; ``exact_fallbacks`` counts the exact ones.

Where the reference takes a PRNG key, these take the systematic uniform
``u`` (a number, a 0-d tensor, (B,) for the fleet form, or a
``torch.Generator`` to draw it from), as ``ops.resampling`` does.
"""

from __future__ import annotations

import torch

from ..ops import pf_kernels, resampling
from . import mesh as mesh_lib
from .mesh import MISSION_AXIS, PARTICLE_AXIS

# exact-branch resamples since the count was last set to 0
exact_fallbacks = 0


def _clamped_halo(halo: int, ns: int) -> int:
    """Halo capped to the shard width (small banks) on a 128 multiple."""
    return min(halo, (ns // 128) * 128)


def _gather(m, parts, out_off, n_out):
    """K7's window form over banks (..., 6, n_in) with counts (..., n_in)
    -> (..., 6, n_out): one call per bank."""
    lead = m.shape[:-1]
    m2 = m.reshape(-1, m.shape[-1])
    p2 = parts.reshape(-1, parts.shape[-2], parts.shape[-1])
    out = [pf_kernels.expand_gather_window_call(m2[b].contiguous(), p2[b].contiguous(),
                                                out_off, n_out) for b in range(m2.shape[0])]
    return torch.stack(out).reshape(*lead, parts.shape[-2], n_out)


def systematic_gather_shard(
    parts,                 # list of (..., 6, ns) bank shards, in shard order
    weights,               # list of (..., ns) slices of GLOBALLY normalized weights
    u,                     # the systematic uniform: the same on every shard
    axis_name: str = PARTICLE_AXIS,
    halo: int = 4096,
    use_pallas: bool = False,
    block: int = 512,
) -> list:
    """The shard body of the distributed systematic resample, as stages
    over the shard list: returns each shard's (..., 6, ns) resampled
    columns, on its device; their concatenation is bitwise the bank
    gathered at ``resampling.systematic_resample``'s ancestors. Leading
    axes are independent banks (a mission shard's missions).

    Requirements, as the reference's: ns divisible by
    ``resampling.CDF_BLOCK`` and ``block``; ``halo`` a multiple of 128 with
    halo <= ns. ``use_pallas`` is the reference's switch to its Pallas
    expansion; here the kernel runs wherever the shards are CUDA tensors
    (the plain version on CPU ones), so it changes nothing."""
    global exact_fallbacks
    P_ = len(parts)
    ns = parts[0].shape[-1]
    n = ns * P_
    H = halo
    if ns % resampling.CDF_BLOCK or ns % block or H % 128 or H > ns:
        raise ValueError(f"shard size {ns} / halo {H} violate tiling")
    R = ns // resampling.CDF_BLOCK
    lead = parts[0].shape[:-2]

    # --- 1. global blocked CDF (bitwise blocked_cdf of the whole bank) --------
    rowcum = [resampling.prefix_sum(resampling._blocks(w.to(torch.float32))) for w in weights]
    bs_all = mesh_lib.all_gather([r[..., -1] for r in rowcum], axis=-1)
    cdf = []
    for s, (r, bs) in enumerate(zip(rowcum, bs_all)):
        tot = resampling.prefix_sum(bs)
        prefix = torch.cat([tot.new_zeros(lead + (1,)), tot[..., :-1]], -1)
        c = (r + prefix[..., s * R:(s + 1) * R, None]).reshape(lead + (ns,))
        if s == P_ - 1:
            c = c.clone()
            c[..., -1].fill_(1.0)  # round-off guard, as the whole bank's
        cdf.append(c)

    # --- 2. global monotone counts ---------------------------------------------
    u = resampling._uniforms(u, lead, cdf[0])       # drawn once, if from a generator
    m = [torch.clamp(torch.ceil(n * c - u.to(c.device)[..., None]), 0, n).to(torch.int32)
         for c in cdf]
    m[-1][..., -1].fill_(n)                             # the counts end at n, as the bank's
    m = [torch.cummax(x, -1).values for x in m]
    last_all = mesh_lib.all_gather([x[..., -1:] for x in m], axis=-1)      # (..., P)
    m = [torch.maximum(x, torch.amax(la[..., :s], -1, keepdim=True)) if s else x
         for s, (x, la) in enumerate(zip(m, last_all))]

    # --- 3. halo exchange ------------------------------------------------------
    m_left = mesh_lib.from_left([x[..., -H:] for x in m])
    m_right = mesh_lib.from_right([x[..., :H] for x in m])
    m_right[-1] = torch.full_like(m_right[-1], n)                         # keep monotone
    p_left = mesh_lib.from_left([p[..., -H:] for p in parts])
    p_right = mesh_lib.from_right([p[..., :H] for p in parts])
    m_ext = [torch.cat(t, -1) for t in zip(m_left, m, m_right)]           # (..., ns + 2H)
    parts_ext = [torch.cat(t, -1) for t in zip(p_left, parts, p_right)]

    # --- 4. fit check (global; one host sync) ----------------------------------
    fits = []
    for s, me in enumerate(m_ext):
        g0 = s * ns
        ts_last = torch.searchsorted(me, torch.full(lead + (1,), g0 + ns - 1, dtype=me.dtype,
                                                    device=me.device), right=True)
        fits.append(((me[..., 0] <= g0) & (ts_last[..., 0] < ns + 2 * H)).all().to(torch.int32))
    if int(mesh_lib.psum(fits)[0]) == P_:
        return [_gather(me, pe, s * ns, ns) for s, (me, pe) in enumerate(zip(m_ext, parts_ext))]

    # --- 5. exact branch: the whole counts and bank on every shard -------------
    exact_fallbacks += 1
    m_full = mesh_lib.all_gather(m, axis=-1)
    p_full = mesh_lib.all_gather(list(parts), axis=-1)
    return [_gather(mf, pf, s * ns, ns) for s, (mf, pf) in enumerate(zip(m_full, p_full))]


def systematic_resample_gather_dist(
    parts: torch.Tensor,    # (6, N) whole bank
    weights: torch.Tensor,  # (N,) globally normalized
    u,                      # the systematic uniform (or a torch.Generator)
    pmesh,
    halo: int = 4096,
    use_pallas: bool = False,
    block: int = 512,
) -> torch.Tensor:
    """Mesh-level entry: the bank's columns split over ``pmesh``'s particle
    axis (the devices of its first mission row: the reference replicates
    the bank over the mission axis, whose copies compute the same values),
    ``systematic_gather_shard`` over the shards, the resampled bank joined
    on ``parts``' device. Bitwise ``parts[:, systematic_resample(u, w)]``."""
    P_ = pmesh.shape[PARTICLE_AXIS]
    n = parts.shape[1]
    if n % P_:
        raise ValueError(f"particle count {n} not divisible by particle axis {P_}")
    ns = n // P_
    row = pmesh.row(0)
    ps = mesh_lib.particle_sharding(row, 2, 1).shard(parts)[0]
    ws = mesh_lib.particle_sharding(row, 1, 0).shard(weights)[0]
    out = systematic_gather_shard(ps, ws, u, axis_name=PARTICLE_AXIS,
                                  halo=_clamped_halo(halo, ns), use_pallas=use_pallas,
                                  block=min(block, ns))
    return mesh_lib.particle_sharding(row, 2, 1).join([out], parts.device)


def systematic_resample_gather_dist_batched(
    parts: torch.Tensor,    # (B, 6, N) fleet banks
    weights: torch.Tensor,  # (B, N) per-mission globally normalized
    u,                      # (B,) per-mission systematic uniforms
    pmesh,
    halo: int = 4096,
    use_pallas: bool = False,
    block: int = 512,
) -> torch.Tensor:
    """Fleet form: missions split over ``mission``, each mission's bank
    columns over ``particle``; each mission shard runs the shard body on
    its missions at once (every collective stays inside its mesh row).
    ``u`` holds the per-mission uniforms (the reference's per-mission
    keys). Per mission, bitwise the single-device systematic resample."""
    M = pmesh.shape[MISSION_AXIS]
    P_ = pmesh.shape[PARTICLE_AXIS]
    B, _, n = parts.shape
    if B % M:
        raise ValueError(f"fleet size {B} not divisible by mission axis {M}")
    if n % P_:
        raise ValueError(f"particle count {n} not divisible by particle axis {P_}")
    ns = n // P_
    u = resampling._uniforms(u, (B,), weights)
    p_sh = mesh_lib.mission_particle_sharding(pmesh, 3, 2).shard(parts)
    w_sh = mesh_lib.mission_particle_sharding(pmesh, 2, 1).shard(weights)
    u_sh = mesh_lib.shard_missions(u, pmesh)
    out = [systematic_gather_shard(p_sh[m], w_sh[m], u_sh[m], axis_name=PARTICLE_AXIS,
                                   halo=_clamped_halo(halo, ns), use_pallas=use_pallas,
                                   block=min(block, ns)) for m in range(M)]
    return mesh_lib.mission_particle_sharding(pmesh, 3, 2).join(out, parts.device)
