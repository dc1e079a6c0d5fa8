"""K1: the whole SLAM data-association stage for a fleet, one call per pass;
K11: the fleet's exact assignment on its own.

``da_lanes`` launches the CUDA kernel ``csrc/slam_da.cu`` (one thread block
per mission: correspondence over every landmark slot, back-projected
candidates, the (L+M)×M gated cost table, an exact one-warp
Jonker-Volgenant assignment and the per-detection selection) for CUDA
tensors, and takes its plain PyTorch version ``da_lanes_reference`` for CPU
tensors. It replaces the TPU kernel
``smarc_navigation_tpu/ops/slam_da_kernels.py::da_lanes`` and keeps its
signature (``valid`` is accepted and ignored, as there) and its outputs.
With ``pose_rows`` (the marginal fleet's (B, 8, D) Σ[0:6, :]) in place of
Σ, Spp/Spl come from the rows and Sll from the band.

``hungarian_lanes`` (K11) launches the same source's one-warp JV per
mission on a (B, R, C) cost, replacing the TPU kernel of that name; its
plain version solves each mission with ``assignment.hungarian``. Both take
any number of cost rows (L + M for ``da_lanes``): up to 1024 the CUDA JV
keeps each lane's rows in registers; past that, or where the tables do not
fit in shared memory, the kernels take their scratch form (the rows' duals
and slacks, and the tables, in a per-mission device scratch buffer that the
wrapper allocates when the launcher asks for it), which gives the same bits.

The plain version of K1 is the batched ``ekf_slam.da_stage`` on the three Σ
slabs, the per-mission ``assignment.hungarian`` and the kernel-branch
selection of ``ekf_slam.da_commit``.
"""

from __future__ import annotations

import ctypes

import torch
from torch.func import vmap

from .. import _build, _tensors
from .assignment import hungarian

# True: K1 and K11 take their scratch form at every shape (the same bits;
# only to hold the two forms against each other)
FORCE_SCRATCH = False
_ARGTYPES = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 20
_JV_ARGTYPES = ([ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
                + [ctypes.c_int, ctypes.c_void_p])


def _launch(name, argtypes, what, dev, B, head, tail=()):
    """Call launcher ``name`` as head + (FORCE_SCRATCH, scratch) + tail.
    Where it takes the scratch form it first launches nothing and returns
    minus the floats per mission it needs: allocate them, call again."""
    fn = getattr(_build.load("slam_da"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_longlong
    rc = fn(*head, int(FORCE_SCRATCH), None, *tail)
    if rc < 0:
        scratch = torch.empty(B * -rc, dtype=torch.float32, device=dev)
        rc = fn(*head, int(FORCE_SCRATCH), _tensors.ptr(scratch), *tail)
    _build.check(rc, what)


def _params_vec(q_diag, lam, outlier, mh_dist, new_lm_cov, r_sb, t_sb, dim, device):
    """The kernel's 32-float parameter block, built on the device (no sync):
    [q0,q1,q2, lam, outlier, mh_dist, nl0..2, rsb00..22 (9-17), tsb0..2]."""
    f32 = torch.float32

    def t(x, n):
        return torch.as_tensor(x, dtype=f32, device=device).reshape(n)

    q = torch.cat([t(q_diag, -1)[:dim], torch.zeros(3 - dim, dtype=f32, device=device)])
    parts = [q, t(lam, 1), t(outlier, 1), t(mh_dist, 1), t(new_lm_cov, 3)]
    if r_sb is not None:
        parts += [t(r_sb, 9), t(t_sb, 3)]
    par = torch.cat(parts)
    return torch.cat([par, torch.zeros(32 - par.numel(), dtype=f32, device=device)])


def da_lanes(
    pose6: torch.Tensor,     # (B, 6)
    n_active: torch.Tensor,  # (B,) int32
    active: torch.Tensor,    # (B, L) bool
    lm_pos: torch.Tensor,    # (B, L, 3)
    Sigma: torch.Tensor,     # (B, D, D), D = 6 + 3L; None with pose_rows
    z: torch.Tensor,         # (B, M, 3)
    z_mask: torch.Tensor,    # (B, M) bool
    q_diag: torch.Tensor,    # (dim,)
    lam, outlier, mh_dist,
    new_lm_cov: torch.Tensor,  # (3,)
    sensor: str = "mbes",
    r_sb: torch.Tensor = None,  # (3,3) fls<-base rotation (FLS only)
    t_sb: torch.Tensor = None,  # (3,)  fls<-base translation (FLS only)
    A: torch.Tensor = None,     # (B,6,6) motion Jacobian (identity-gated):
                                #   triggers the Σ-slab predict
    valid: torch.Tensor = None,  # (B,) odom-valid gate: ignored, as in the
                                #   reference (the gate is folded into r_full)
    r_full: torch.Tensor = None,  # (B,6,6) motion-noise block R̃ (validity-gated)
    band: torch.Tensor = None,  # (B, 24, L) landmark block-diag band:
                                #   band[b, a*8+d, l] = Σ[b, 6+3l+a, 6+3l+a+d]
    pose_rows: torch.Tensor = None,  # (B, 8, D) Σ[0:6, :] (rows 6:8 padding),
                                #   the marginal fleet's covariance state:
                                #   Spp/Spl from the rows, Sll from the band
):
    """Whole DA stage (MBES or FLS) for a fleet -> per-measurement tensors.

    Returns (col_to_row (B,M) i32, H_sel (B,M,dim,9), SinvH (B,M,dim,9),
    nu_sel (B,M,dim), cand (B,M,3), do (B,M) bool, add (B,M) bool,
    slot (B,M) i32).

    With ``A``/``r_full`` given, Σ is the RAW (pre-predict) covariance and
    the motion predict Σ' = A Σ Aᵀ + R̃ is applied to the slabs read
    (``ekf_slam_core.cpp:41-121``)."""
    if sensor not in ("mbes", "fls"):
        raise ValueError(f"unknown sensor {sensor!r}")
    if sensor == "fls" and (r_sb is None or t_sb is None):
        raise ValueError("the FLS form needs r_sb and t_sb")
    if (A is None) != (r_full is None):
        raise ValueError("A and r_full go together")
    if pose_rows is not None and band is None:
        raise ValueError("pose_rows requires the band carry for Sll")
    if (pose_rows is None) == (Sigma is None):
        raise ValueError("give exactly one of Sigma and pose_rows")
    dev = z.device
    B, M = z.shape[0], z.shape[1]
    L = active.shape[1]
    D = 6 + 3 * L
    dim = 2 if sensor == "fls" else 3
    f32, i32 = torch.float32, torch.int32
    # the kernel's contract, checked on every device so the CPU tests hold
    # callers to it too
    c = _tensors.check
    c(pose6, "pose6", (B, 6), f32, dev)
    c(n_active, "n_active", (B,), i32, dev)
    c(active, "active", (B, L), torch.bool, dev)
    c(lm_pos, "lm_pos", (B, L, 3), f32, dev)
    if pose_rows is not None:
        c(pose_rows, "pose_rows", (B, 8, D), f32, dev)
    else:
        c(Sigma, "Sigma", (B, D, D), f32, dev)
    c(z, "z", (B, M, 3), f32, dev)
    c(z_mask, "z_mask", (B, M), torch.bool, dev)
    if A is not None:
        c(A, "A", (B, 6, 6), f32, dev)
        c(r_full, "r_full", (B, 6, 6), f32, dev)
    if band is not None:
        c(band, "band", (B, 24, L), f32, dev)
    if dev.type == "cpu":
        return da_lanes_reference(
            pose6, n_active, active, lm_pos, Sigma, z, z_mask, q_diag, lam,
            outlier, mh_dist, new_lm_cov, sensor, r_sb, t_sb, A, r_full, band,
            pose_rows)
    if dev.type != "cuda":
        raise ValueError(f"da_lanes runs on CUDA or CPU tensors, not {dev}")
    par = _params_vec(q_diag, lam, outlier, mh_dist, new_lm_cov,
                      r_sb if sensor == "fls" else None,
                      t_sb if sensor == "fls" else None, dim, dev)

    ctr = torch.empty((B, M), dtype=i32, device=dev)
    H_sel = torch.empty((B, M, dim, 9), dtype=f32, device=dev)
    SinvH = torch.empty((B, M, dim, 9), dtype=f32, device=dev)
    nu_sel = torch.empty((B, M, dim), dtype=f32, device=dev)
    cand = torch.empty((B, M, 3), dtype=f32, device=dev)
    do = torch.empty((B, M), dtype=torch.bool, device=dev)
    add = torch.empty((B, M), dtype=torch.bool, device=dev)
    slot = torch.empty((B, M), dtype=i32, device=dev)
    P = _tensors.ptr
    _launch("slam_da_launch", _ARGTYPES, "da_lanes", dev, B,
            (_tensors.device_index(dev), _tensors.stream(dev), B, L, M, D,
             int(pose_rows is not None), int(sensor == "fls"), int(A is not None),
             int(band is not None)),
            (P(pose6), P(n_active), P(active), P(lm_pos),
             P(pose_rows if pose_rows is not None else Sigma), P(z), P(z_mask),
             P(par), P(A), P(r_full), P(band),
             P(ctr), P(H_sel), P(SinvH), P(nu_sel), P(cand), P(do), P(add), P(slot)))
    da_lanes.launches += 1
    return ctr, H_sel, SinvH, nu_sel, cand, do, add, slot


da_lanes.launches = 0


def da_tables_reference(
    pose6, n_active, active, lm_pos, Sigma, z, z_mask, q_diag, lam, outlier,
    mh_dist, new_lm_cov, sensor="mbes", r_sb=None, t_sb=None, A=None,
    r_full=None, band=None, pose_rows=None,
):
    """The plain DA stage up to the assignment (``da_lanes``' arguments) ->
    (the (B, L+M, M) cost tables, the staged per-slot and per-candidate
    tensors of ``ekf_slam.da_stage``)."""
    from ..models import ekf_slam

    B = z.shape[0]
    L = active.shape[1]
    dt, dev = z.dtype, z.device
    spec = ekf_slam.FLS if sensor == "fls" else ekf_slam.MBES
    params = ekf_slam.SlamParams(None, None, None, None, None, r_sb, t_sb)
    Q = torch.diag(torch.as_tensor(q_diag, dtype=dt, device=dev)[:spec.dim])
    lam = torch.as_tensor(lam, dtype=dt, device=dev)
    new_lm_cov = torch.as_tensor(new_lm_cov, dtype=dt, device=dev)

    if pose_rows is not None:
        Spp = pose_rows[:, 0:6, 0:6]
        Spl = pose_rows[:, 0:6, 6:].reshape(B, 6, L, 3).movedim(-2, -3)
        Sll = None
    else:
        Spp, Spl, Sll = ekf_slam._slabs(Sigma, L)
    if band is not None:
        Sll = torch.stack([band[:, min(a, c) * 8 + abs(c - a), :L]
                           for a in range(3) for c in range(3)], dim=-1
                          ).reshape(B, L, 3, 3)
    if A is not None:
        Spp = torch.einsum("bij,bjk,blk->bil", A, Spp, A) + r_full
        Spl = torch.einsum("bij,bljk->blik", A, Spl)

    def core(p6, lm, act, spp, spl, sll, zb, mb):
        return ekf_slam._da_core(p6, lm, act, spp, spl, sll, zb, mb, spec,
                                 params, Q, lam, outlier, mh_dist, new_lm_cov)

    return vmap(core)(pose6, lm_pos, active, Spp, Spl, Sll, z, z_mask)


def da_lanes_reference(
    pose6, n_active, active, lm_pos, Sigma, z, z_mask, q_diag, lam, outlier,
    mh_dist, new_lm_cov, sensor="mbes", r_sb=None, t_sb=None, A=None,
    r_full=None, band=None, pose_rows=None,
):
    """Plain PyTorch version of ``da_lanes`` (same arguments and outputs)."""
    from ..models import ekf_slam

    B, M = z.shape[0], z.shape[1]
    L = active.shape[1]
    dev = z.device
    cost, (H, S_inv, nu, cand, H_cand, S_inv_cand, nu_cand) = da_tables_reference(
        pose6, n_active, active, lm_pos, Sigma, z, z_mask, q_diag, lam, outlier,
        mh_dist, new_lm_cov, sensor, r_sb, t_sb, A, r_full, band, pose_rows)
    ctr = hungarian_lanes_reference(cost)

    is_new, r_clip, do, add, slot = ekf_slam.select_updates(ctr, z_mask, n_active, L)
    rc = r_clip.long()
    bi = torch.arange(B, device=dev)[:, None]
    mi = torch.arange(M, device=dev)[None, :]
    H_sel = torch.where(is_new[..., None, None], H_cand, H[bi, rc])
    Sinv_sel = torch.where(is_new[..., None, None], S_inv_cand, S_inv[bi, rc])
    nu_sel = torch.where(is_new[..., None], nu_cand, nu[bi, rc, mi])
    SinvH = torch.einsum("bmij,bmjk->bmik", Sinv_sel, H_sel)
    # laid out as the kernel writes them
    return tuple(x.contiguous() for x in (ctr, H_sel, SinvH, nu_sel, cand, do, add, slot))


def hungarian_lanes(cost: torch.Tensor) -> torch.Tensor:
    """Exact JV assignment for a fleet: cost (B, R, C) -> col_to_row (B, C)
    int32, C <= R. Same optimum and tie-breaking as ``assignment.hungarian``
    per mission; pad unusable entries with ``assignment._INF`` (1e30)."""
    if cost.dim() != 3:
        raise ValueError(f"cost: expected (B, R, C), got shape {tuple(cost.shape)}")
    B, R, C = cost.shape
    if C > R:
        raise ValueError("hungarian_lanes requires C <= R (pad candidate rows)")
    dev = cost.device
    _tensors.check(cost, "cost", (B, R, C), torch.float32, dev)
    if dev.type == "cpu":
        return hungarian_lanes_reference(cost)
    if dev.type != "cuda":
        raise ValueError(f"hungarian_lanes runs on CUDA or CPU tensors, not {dev}")
    out = torch.empty((B, C), dtype=torch.int32, device=dev)
    _launch("hungarian_lanes_launch", _JV_ARGTYPES, "hungarian_lanes", dev, B,
            (_tensors.device_index(dev), _tensors.stream(dev), B, R, C,
             _tensors.ptr(cost), _tensors.ptr(out)))
    hungarian_lanes.launches += 1
    return out


hungarian_lanes.launches = 0


def hungarian_lanes_reference(cost: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``hungarian_lanes``: ``assignment.hungarian``
    per mission."""
    return torch.stack([hungarian(cost[b]) for b in range(cost.shape[0])])
