"""K2 / K3 / K12: the EKF-SLAM sequential measurement update; K4: its
marginal-writeback counterpart.

``sequential_update_fleet`` (K2) and ``sequential_update`` (K3) launch the
CUDA kernels of ``csrc/slam_update.cu`` for CUDA tensors and take their
plain PyTorch versions for CPU tensors. They replace the TPU kernels of
``smarc_navigation_tpu/ops/slam_kernels.py`` of the same names and keep
their signatures; K2 drops the TPU-only options ``tiled_ep`` (a VMEM layout
of the same kernel) and ``mb`` (the VMEM mission block). K3 is K2 at B=1
with no predict, no landmark-position init and no band. Both take the
streamed schedule by default, at every state size: phase 1 (factors, μ,
band, over a grid of column tiles) and then ``symmetric_downdate`` (K12,
``csrc/slam_downdate.cu``: the downdate over tiles), which replaces the TPU
kernel's phase 2. ``streamed=False`` runs the one-kernel schedule (one block
per mission does the downdate too), kept as the yardstick: the two give the
same bits on the card.

``sequential_update_marginal_fleet`` (K4, ``csrc/slam_marginal.cu``) is the
reference's own 9×9 marginal writeback on pose rows + band.

Each wrapper has its own launch count. The plain versions of K2/K3 are the
dense in-place full-covariance sequence of ``ekf_slam.da_commit``
(``upd_dense``) in measurement order, preceded by ``_fleet_predict``'s Σ
transform when ``a8`` is given. New landmarks are activated by adding
diag(new_lm_cov) (and ``cand`` to μ) on the slot, whose rows are zero by the
padding invariant — the reference kernels' form, equal to the dense path's
set.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build, _tensors
from ..utils.geometry import wrap_angle

_ARGTYPES = {
    "slam_update": [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 19,
    "slam_downdate": [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6,
    "slam_marginal": [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 15,
}



def _lib(name="slam_update"):
    fn = getattr(_build.load(name), f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _phase1_scratch(dev, B, D, M, dim):
    """The device scratch phase 1 needs at (B, D, M, dim): None where its
    per-block working set fits in shared memory, else a float32 buffer of
    one slice per block (``csrc/slam_update.cu``)."""
    fn = _build.load("slam_update").slam_update_phase1_scratch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 5
        fn.restype = ctypes.c_longlong
    n = fn(_tensors.device_index(dev), B, D, M, dim)
    if n < 0:
        raise ValueError(f"phase 1: invalid shape B={B} D={D} M={M} dim={dim}")
    return torch.empty(n, dtype=torch.float32, device=dev) if n else None


def _check(Sigma, mu, H_sel, SinvH, nu_sel, lm_ix, do, add, new_lm_cov,
           cand, a8, band, what):
    """The kernel's contract on (B, ...) tensors, checked on every device so
    the CPU tests hold callers to it too."""
    dev = Sigma.device
    B, D = Sigma.shape[0], Sigma.shape[1]
    M, dim = nu_sel.shape[1], nu_sel.shape[2]
    L = (D - 6) // 3
    f32 = torch.float32
    c = _tensors.check
    if D != 6 + 3 * L:
        raise ValueError(f"{what}: state dim {D} is not 6 + 3L")
    if dim not in (2, 3):
        raise ValueError(f"{what}: measurement dim {dim} not in (2, 3)")
    c(Sigma, "Sigma", (B, D, D), f32, dev)
    c(mu, "mu", (B, D), f32, dev)
    c(H_sel, "H_sel", (B, M, dim, 9), f32, dev)
    c(SinvH, "SinvH", (B, M, dim, 9), f32, dev)
    c(nu_sel, "nu_sel", (B, M, dim), f32, dev)
    c(lm_ix, "lm_ix", (B, M), torch.int32, dev)
    c(do, "do", (B, M), torch.bool, dev)
    c(add, "add", (B, M), torch.bool, dev)
    c(new_lm_cov, "new_lm_cov", (3,), f32, dev)
    if cand is not None:
        c(cand, "cand", (B, M, 3), f32, dev)
    if a8 is not None:
        c(a8, "a8", (B, 8, 16), f32, dev)
    if band is not None:
        c(band, "band", (B, 24, L), f32, dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on CUDA or CPU tensors, not {dev}")


def _launch(Sigma, mu, H_sel, SinvH, nu_sel, lm_ix, do, add, new_lm_cov,
            cand, a8, band, what, streamed):
    """Launch the update kernels on checked (B, ...) CUDA tensors ->
    (Sigma, mu, band). The streamed schedule runs ``phase1`` and then K12,
    the one-kernel schedule one kernel."""
    if streamed:
        mu_out, band_out, P_rows, U, V, act = phase1(
            Sigma, mu, H_sel, SinvH, nu_sel, lm_ix, do, add, new_lm_cov, cand, a8,
            band, what)
        return symmetric_downdate(Sigma, U, V, P_rows, act), mu_out, band_out
    return _kernel(Sigma, mu, H_sel, SinvH, nu_sel, lm_ix, do, add, new_lm_cov,
                   cand, a8, band, what, True)[:3]


def phase1(Sigma, mu, H_sel, SinvH, nu_sel, lm_ix, do, add, new_lm_cov, cand,
           a8, band, what="sequential_update_fleet"):
    """Phase 1 of the streamed schedule on checked CUDA tensors -> (mu,
    band, P, U, V, act): a grid of (column tile, mission) blocks writes what
    ``symmetric_downdate`` needs besides Σ — the factors U, V (B, M·dim, D),
    the predicted pose rows P (B, 6, D; None without a8) and the activation
    diagonal act (B, D)."""
    return _kernel(Sigma, mu, H_sel, SinvH, nu_sel, lm_ix, do, add, new_lm_cov,
                   cand, a8, band, what, False)[1:]


def _kernel(Sigma, mu, H_sel, SinvH, nu_sel, lm_ix, do, add, new_lm_cov,
            cand, a8, band, what, write_sigma):
    dev = Sigma.device
    B, D = Sigma.shape[0], Sigma.shape[1]
    M, dim = nu_sel.shape[1], nu_sel.shape[2]
    L = (D - 6) // 3
    f32 = torch.float32
    Sigma_out = torch.empty_like(Sigma) if write_sigma else None
    act = None if write_sigma else torch.empty_like(mu)
    mu_out = torch.empty_like(mu)
    band_out = torch.empty((B, 24, L), dtype=f32, device=dev) if band is not None else None
    P_rows = torch.empty((B, 6, D), dtype=f32, device=dev) if a8 is not None else None
    U = torch.empty((B, M * dim, D), dtype=f32, device=dev)
    V = torch.empty((B, M * dim, D), dtype=f32, device=dev)
    scratch = None if write_sigma else _phase1_scratch(dev, B, D, M, dim)
    P = _tensors.ptr
    rc = _lib()(
        _tensors.device_index(dev), _tensors.stream(dev), B, D, M, dim, L,
        P(Sigma), P(mu), P(H_sel), P(SinvH), P(nu_sel), P(lm_ix), P(do),
        P(add), P(new_lm_cov), P(cand), P(a8), P(P_rows), P(U), P(V),
        P(Sigma_out), P(mu_out), P(band_out), P(act), P(scratch))
    _build.check(rc, what)
    return Sigma_out, mu_out, band_out, P_rows, U, V, act


def sequential_update_fleet(
    Sigma: torch.Tensor,    # (B, D, D)
    mu: torch.Tensor,       # (B, D)
    H_sel: torch.Tensor,    # (B, M, dim, 9)
    SinvH: torch.Tensor,    # (B, M, dim, 9)
    nu_sel: torch.Tensor,   # (B, M, dim)
    lm_ix: torch.Tensor,    # (B, M) int32 state offsets (6 + 3·slot)
    do: torch.Tensor,       # (B, M) bool
    add: torch.Tensor,      # (B, M) bool (implies do)
    new_lm_cov: torch.Tensor,  # (3,)
    cand: torch.Tensor = None,  # (B, M, 3) new-landmark positions
    a8: torch.Tensor = None,    # (B, 8, 16): cols 0:8 = blockdiag(A6, I2),
                                #   rows 0:6 × cols 8:14 = R̃ (validity-gated)
    band: torch.Tensor = None,  # (B, 24, L) landmark block-diag band; when
                                #   given, the new band is a third output
    streamed: bool = True,      # two-phase schedule: phase 1 writes the
                                #   U/V factors, μ and the band, then K12
                                #   (``symmetric_downdate``) writes Σ;
                                #   False: the one-kernel schedule
) -> tuple:
    """Fleet sequential update -> ``(Sigma, mu)``, or ``(Sigma, mu, band)``
    when ``band`` is given. With ``a8``, Σ is the raw covariance and the
    motion predict Σ' = Ã Σ Ãᵀ + R̃ is applied first; with ``cand``, added
    landmarks' μ rows are initialised to their candidates. On the card the
    two schedules give the same Σ, μ and band bit for bit (the same fmaf
    sequence per entry); both Σ are exactly symmetric."""
    args = (Sigma, mu, H_sel, SinvH, nu_sel, lm_ix, do, add, new_lm_cov, cand, a8, band)
    _check(*args, "sequential_update_fleet")
    if Sigma.device.type == "cpu":
        return sequential_update_fleet_reference(*args, streamed=streamed)
    Sigma_out, mu_out, band_out = _launch(
        Sigma, mu, H_sel, SinvH, nu_sel, lm_ix, do, add, new_lm_cov, cand, a8,
        band, "sequential_update_fleet", streamed)
    sequential_update_fleet.launches += 1
    if band is not None:
        return Sigma_out, mu_out, band_out
    return Sigma_out, mu_out


sequential_update_fleet.launches = 0


def sequential_update(
    Sigma: torch.Tensor,    # (D, D)
    mu: torch.Tensor,       # (D,)
    H_sel: torch.Tensor,    # (M, dim, 9) batch-stage Jacobians (selected row)
    SinvH: torch.Tensor,    # (M, dim, 9) S⁻¹H per update
    nu_sel: torch.Tensor,   # (M, dim)
    lm_ix: torch.Tensor,    # (M,) int32 state offsets (6 + 3·slot)
    do: torch.Tensor,       # (M,) bool
    add: torch.Tensor,      # (M,) bool (implies do)
    new_lm_cov: torch.Tensor,  # (3,)
) -> tuple:
    """All M sequential updates of one mission -> (Sigma, mu), on K2's
    streamed schedule: phase 1 + K12."""
    batched = (Sigma[None], mu[None], H_sel[None], SinvH[None], nu_sel[None],
               lm_ix[None], do[None], add[None], new_lm_cov, None, None, None)
    _check(*batched, "sequential_update")
    if Sigma.device.type == "cpu":
        return sequential_update_reference(
            Sigma, mu, H_sel, SinvH, nu_sel, lm_ix, do, add, new_lm_cov, streamed=True)
    Sigma_out, mu_out, _ = _launch(*batched, "sequential_update", True)
    sequential_update.launches += 1
    return Sigma_out[0], mu_out[0]


sequential_update.launches = 0


def sequential_update_fleet_reference(
    Sigma, mu, H_sel, SinvH, nu_sel, lm_ix, do, add, new_lm_cov,
    cand=None, a8=None, band=None, streamed=False,
):
    """Plain PyTorch version of ``sequential_update_fleet``. With
    ``streamed`` the same sequence gives μ and the factors U_j = K_jᵀ,
    V_j = H_j rows_j, and Σ comes from ``symmetric_downdate_reference`` of
    the raw Σ, the predicted pose rows and the activation diagonal."""
    B, D = Sigma.shape[0], Sigma.shape[1]
    M, dim = nu_sel.shape[1], nu_sel.shape[2]
    L = (D - 6) // 3
    dev = Sigma.device
    Sigma_raw, P_rows = Sigma, None
    U = Sigma.new_zeros((B, M * dim, D)) if streamed else None
    V = Sigma.new_zeros((B, M * dim, D)) if streamed else None
    act = Sigma.new_zeros((B, D))
    if a8 is not None:   # _fleet_predict's Σ transform (R̃ already gated)
        A, R = a8[:, 0:6, 0:6], a8[:, 0:6, 8:14]
        S11 = torch.einsum("bij,bjk,blk->bil", A, Sigma[:, 0:6, 0:6], A) + R
        S1L = torch.einsum("bij,bjk->bik", A, Sigma[:, 0:6, 6:])
        Sigma = Sigma.clone()
        Sigma[:, 0:6, 0:6] = S11
        Sigma[:, 0:6, 6:] = S1L
        Sigma[:, 6:, 0:6] = S1L.transpose(1, 2)
        P_rows = Sigma[:, 0:6, :].clone()
    lm = lm_ix.long()
    ar3 = torch.arange(3, device=dev)
    pose_ix = torch.arange(6, device=dev).expand(B, 6)
    for j in range(M):
        idx3 = lm[:, j, None] + ar3                                     # (B,3)
        # activation: += diag(new_lm_cov) on the slot (its index set goes
        # out of range, and is cut off, where there is no add)
        tgt = torch.where(add[:, j, None], idx3, D + ar3)
        on = add[:, j, None].to(Sigma.dtype)
        inc = torch.zeros((B, D + 3), dtype=Sigma.dtype, device=dev).scatter(
            1, tgt, new_lm_cov[None, :] * on)[:, :D]
        Sigma = Sigma.clone()
        Sigma.diagonal(dim1=1, dim2=2).add_(inc)
        act = act + inc
        if cand is not None:
            mu = mu + torch.zeros((B, D + 3), dtype=mu.dtype, device=dev).scatter(
                1, tgt, cand[:, j] * on)[:, :D]
        idx9 = torch.cat([pose_ix, idx3.clamp(max=D - 1)], dim=1)       # (B,9)
        rows = torch.gather(Sigma, 1, idx9[:, :, None].expand(B, 9, D))  # (B,9,D)
        Kt = SinvH[:, j] @ rows                                          # (B,dim,D)
        mu_new = mu + torch.einsum("bd,bdc->bc", nu_sel[:, j], Kt)
        mu_new = torch.cat([mu_new[:, 0:3], wrap_angle(mu_new[:, 3:6]), mu_new[:, 6:]], 1)
        Vt = H_sel[:, j] @ rows
        S_new = Sigma - Kt.transpose(1, 2) @ Vt
        S_new = 0.5 * (S_new + S_new.transpose(1, 2))
        dj = do[:, j]
        mu = torch.where(dj[:, None], mu_new, mu)
        Sigma = torch.where(dj[:, None, None], S_new, Sigma)
        if streamed:
            U[:, j * dim:(j + 1) * dim] = torch.where(dj[:, None, None], Kt, 0.0)
            V[:, j * dim:(j + 1) * dim] = torch.where(dj[:, None, None], Vt, 0.0)
    if streamed:
        Sigma = symmetric_downdate_reference(Sigma_raw, U, V, P_rows, act)
    if band is not None:
        from ..models.ekf_slam import initial_band

        return Sigma, mu, initial_band(Sigma, L)
    return Sigma, mu


def sequential_update_reference(Sigma, mu, H_sel, SinvH, nu_sel, lm_ix, do,
                                add, new_lm_cov, streamed=False):
    """Plain PyTorch version of ``sequential_update``."""
    S, m = sequential_update_fleet_reference(
        Sigma[None], mu[None], H_sel[None], SinvH[None], nu_sel[None],
        lm_ix[None], do[None], add[None], new_lm_cov, streamed=streamed)
    return S[0], m[0]


def _check_downdate(Sigma, U, V, P, act):
    dev = Sigma.device
    B, D = Sigma.shape[0], Sigma.shape[-1]
    K = U.shape[1]
    c = _tensors.check
    f32 = torch.float32
    c(Sigma, "Sigma", (B, D, D), f32, dev)
    c(U, "U", (B, K, D), f32, dev)
    c(V, "V", (B, K, D), f32, dev)
    if P is not None:
        c(P, "P", (B, 6, D), f32, dev)
    if act is not None:
        c(act, "act", (B, D), f32, dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"symmetric_downdate runs on CUDA or CPU tensors, not {dev}")


def symmetric_downdate(
    Sigma: torch.Tensor,     # (B, D, D) raw covariance
    U: torch.Tensor,         # (B, K, D) factor rows (zero rows are skipped updates)
    V: torch.Tensor,         # (B, K, D)
    P: torch.Tensor = None,  # (B, 6, D) predicted pose rows: Σ'[i, c] = P[i, c]
                             #   for i < 6 and P[c, i] for c < 6
    act: torch.Tensor = None,  # (B, D) diagonal added to Σ' (landmark activations)
) -> torch.Tensor:
    """K12: Σ_out = ½(s + sᵀ), s = Σ' + diag(act) − UᵀV — with Σ' = Σ and no
    act, Σ − ½(UᵀV + VᵀU); exactly symmetric."""
    _check_downdate(Sigma, U, V, P, act)
    if Sigma.device.type == "cpu":
        return symmetric_downdate_reference(Sigma, U, V, P, act)
    dev = Sigma.device
    B, D, K = Sigma.shape[0], Sigma.shape[1], U.shape[1]
    out = torch.empty_like(Sigma)
    ptr = _tensors.ptr
    rc = _lib("slam_downdate")(
        _tensors.device_index(dev), _tensors.stream(dev), B, D, K,
        ptr(Sigma), ptr(U), ptr(V), ptr(P), ptr(act), ptr(out))
    _build.check(rc, "symmetric_downdate")
    symmetric_downdate.launches += 1
    return out


symmetric_downdate.launches = 0


def symmetric_downdate_reference(Sigma, U, V, P=None, act=None):
    """Plain PyTorch version of ``symmetric_downdate``."""
    S = Sigma
    if P is not None:
        S = S.clone()
        S[:, 0:6, :] = P
        S[:, 6:, 0:6] = P[:, :, 6:].transpose(1, 2)
    if act is not None:
        S = S + torch.diag_embed(act)
    s = S - U.transpose(1, 2) @ V
    return 0.5 * (s + s.transpose(1, 2))


# ---------------------------------------------------------------------------
# K4: marginal writeback (the reference's own covariance semantics)
# ---------------------------------------------------------------------------

def sequential_update_marginal_fleet(
    P: torch.Tensor,        # (B, 8, D) pose rows Σ[0:6, :] (rows 6:8 padding)
    mu: torch.Tensor,       # (B, D)
    H_sel: torch.Tensor,    # (B, M, dim, 9)
    SinvH: torch.Tensor,    # (B, M, dim, 9)
    nu_sel: torch.Tensor,   # (B, M, dim)
    lm_ix: torch.Tensor,    # (B, M) int32 state offsets (6 + 3·slot)
    do: torch.Tensor,       # (B, M) bool
    add: torch.Tensor,      # (B, M) bool (implies do)
    new_lm_cov: torch.Tensor,  # (3,)
    cand: torch.Tensor,     # (B, M, 3) new-landmark positions
    band: torch.Tensor,     # (B, 24, L) landmark block-diag band
    a8: torch.Tensor = None,   # (B, 8, 16) motion Jacobian + R̃ block
) -> tuple:
    """Fleet sequential update under the reference's marginal semantics
    (``ekf_slam_core.cpp:351-371``) -> ``(P', mu', band')``: each update
    writes back only the 9×9 (pose, matched landmark) marginal; nothing
    (D, D)-shaped exists. Rows 6:8 of P are padding and copied through."""
    dev = P.device
    B, D = P.shape[0], P.shape[2]
    M, dim = nu_sel.shape[1], nu_sel.shape[2]
    L = band.shape[2]
    f32 = torch.float32
    c = _tensors.check
    if D != 6 + 3 * L:
        raise ValueError(f"sequential_update_marginal_fleet: D={D} is not 6 + 3L (L={L})")
    if dim not in (2, 3):
        raise ValueError(f"sequential_update_marginal_fleet: measurement dim {dim} not in (2, 3)")
    c(P, "P", (B, 8, D), f32, dev)
    c(mu, "mu", (B, D), f32, dev)
    c(H_sel, "H_sel", (B, M, dim, 9), f32, dev)
    c(SinvH, "SinvH", (B, M, dim, 9), f32, dev)
    c(nu_sel, "nu_sel", (B, M, dim), f32, dev)
    c(lm_ix, "lm_ix", (B, M), torch.int32, dev)
    c(do, "do", (B, M), torch.bool, dev)
    c(add, "add", (B, M), torch.bool, dev)
    c(new_lm_cov, "new_lm_cov", (3,), f32, dev)
    c(cand, "cand", (B, M, 3), f32, dev)
    c(band, "band", (B, 24, L), f32, dev)
    if a8 is not None:
        c(a8, "a8", (B, 8, 16), f32, dev)
    args = (P, mu, H_sel, SinvH, nu_sel, lm_ix, do, add, new_lm_cov, cand, band, a8)
    if dev.type == "cpu":
        return sequential_update_marginal_fleet_reference(*args)
    if dev.type != "cuda":
        raise ValueError(f"sequential_update_marginal_fleet runs on CUDA or CPU tensors, not {dev}")
    P_out, mu_out, band_out = torch.empty_like(P), torch.empty_like(mu), torch.empty_like(band)
    ptr = _tensors.ptr
    rc = _lib("slam_marginal")(
        _tensors.device_index(dev), _tensors.stream(dev), B, D, M, dim, L,
        *(ptr(x) for x in args), ptr(P_out), ptr(mu_out), ptr(band_out))
    _build.check(rc, "sequential_update_marginal_fleet")
    sequential_update_marginal_fleet.launches += 1
    return P_out, mu_out, band_out


sequential_update_marginal_fleet.launches = 0


def sequential_update_marginal_fleet_reference(
    P, mu, H_sel, SinvH, nu_sel, lm_ix, do, add, new_lm_cov, cand, band, a8=None,
):
    """Plain PyTorch version of ``sequential_update_marginal_fleet``."""
    B, D = P.shape[0], P.shape[2]
    M = nu_sel.shape[1]
    L = band.shape[2]
    dev = P.device
    bi = torch.arange(B, device=dev)
    P, mu, band = P.clone(), mu.clone(), band.clone()
    if a8 is not None:   # pose rows of Σ' = Ã Σ Ãᵀ + R̃
        A, R = a8[:, 0:6, 0:6], a8[:, 0:6, 8:14]
        rows = P[:, 0:6]
        blk = torch.einsum("bil,bcl->bic", torch.einsum("bik,bkl->bil", A, rows[:, :, 0:6]), A) + R
        P[:, 0:6, 6:] = torch.einsum("bik,bkc->bic", A, rows[:, :, 6:])
        P[:, 0:6, 0:6] = blk
    ar3 = torch.arange(3, device=dev)
    pose_ix = torch.arange(6, device=dev).expand(B, 6)
    nl = torch.diag(new_lm_cov).expand(B, 3, 3)
    # band row a*8+d of a slot <- Σ9'[6+a, 6+min(a+d, 2)]; the 3×3 block from
    # the band's upper triangle
    w_rows = [(6 + r // 8, 6 + min(r // 8 + r % 8, 2)) for r in range(24)]
    b_ix = [min(a, c) * 8 + abs(a - c) for a in range(3) for c in range(3)]
    for j in range(M):
        lm = lm_ix[:, j].long()
        slot = ((lm - 6) // 3).clamp(0, L - 1)        # in range where do is False too
        sel = torch.cat([pose_ix, (lm[:, None] + ar3).clamp(max=D - 1)], 1)   # (B,9)
        top = torch.gather(P[:, 0:6], 2, sel[:, None, :].expand(B, 6, 9))     # (B,6,9)
        bcol = band[bi, :, slot]                                              # (B,24)
        b3 = bcol[:, b_ix].reshape(B, 3, 3)
        lmblk = torch.where(add[:, j, None, None], nl, b3)
        s9 = torch.cat([top, torch.cat([top[:, :, 6:9].transpose(1, 2), lmblk], 2)], 1)
        Kt = SinvH[:, j] @ s9                                                 # (B,dim,9)
        Vt = H_sel[:, j] @ s9
        s9n = s9 - Kt.transpose(1, 2) @ Vt
        dmu = torch.einsum("bd,bdc->bc", nu_sel[:, j], Kt)
        dmu = dmu + torch.cat([torch.zeros_like(dmu[:, 0:6]),
                               torch.where(add[:, j, None], cand[:, j], 0.0)], 1)
        mu_new = mu.scatter(1, sel, torch.gather(mu, 1, sel) + dmu)
        mu_new = torch.cat([mu_new[:, 0:3], wrap_angle(mu_new[:, 3:6]), mu_new[:, 6:]], 1)
        P_new = P.clone()
        P_new[:, 0:6] = P[:, 0:6].scatter(2, sel[:, None, :].expand(B, 6, 9), s9n[:, 0:6])
        vals = torch.stack([s9n[:, a, c] for a, c in w_rows], 1)             # (B,24)
        band_new = band.clone()
        band_new[bi, :, slot] = vals
        dj = do[:, j]
        mu = torch.where(dj[:, None], mu_new, mu)
        P = torch.where(dj[:, None, None], P_new, P)
        band = torch.where(dj[:, None, None], band_new, band)
    return P, mu, band
