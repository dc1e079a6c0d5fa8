"""Small-matrix linear algebra for the filters (port of the reference's
``utils/linalg.py``): Cholesky-factored solves of the SPD innovation
matrices, closed-form 2×2 / 3×3 inverses."""

from __future__ import annotations

import math

import torch


def symmetrize(a: torch.Tensor) -> torch.Tensor:
    """0.5 (A + Aᵀ) over the trailing two dims."""
    return 0.5 * (a + torch.swapaxes(a, -1, -2))


def spd_solve(S: torch.Tensor, b: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Solve S x = b for SPD S (..., n, n) against b (..., n) or (..., n, k):
    a Cholesky solve of ``symmetrize(S)`` (plus ``jitter`` on the diagonal)."""
    if jitter:
        S = S + jitter * torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)
    chol = torch.linalg.cholesky(symmetrize(S))
    if b.dim() == S.dim() - 1:
        return torch.cholesky_solve(b[..., None], chol)[..., 0]
    return torch.cholesky_solve(b, chol)


def spd_inverse(S: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Explicit SPD inverse via Cholesky (where the reference stores S⁻¹,
    ``correspondence_obj.cpp:80-97``)."""
    eye = torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)
    return spd_solve(S, eye.expand(S.shape), jitter)


def mahalanobis(nu: torch.Tensor, S: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """νᵀ S⁻¹ ν for ν (..., n), SPD S (..., n, n) -> (...,)."""
    return torch.sum(nu * spd_solve(S, nu, jitter), dim=-1)


def gaussian_likelihood(nu: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """ψ = det(π S)^{-1/2} exp(-d_M/2), with the reference's normalization
    ``2 * M_PI_2 * S`` = π·S (``correspondence_obj.cpp:80-97``)."""
    chol = torch.linalg.cholesky(symmetrize(S))
    d_m = mahalanobis(nu, S)
    n = S.shape[-1]
    log_det = n * math.log(math.pi) + 2.0 * torch.sum(
        torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
    return torch.exp(-0.5 * (d_m + log_det))


def quadratic_form(H: torch.Tensor, Sigma: torch.Tensor) -> torch.Tensor:
    """H Σ Hᵀ over trailing dims; H (..., m, n), Σ (..., n, n) -> (..., m, m)."""
    return torch.einsum("...ij,...jk,...lk->...il", H, Sigma, H)


def inv_det_small3(S: torch.Tensor):
    """Closed-form (inverse, det) of batched 3×3 SPD matrices: one cofactor
    pass feeds both, with the reference's expressions."""
    a, b, c = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    d, e, f = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    g, h, i = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    Dc = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    Hc = -(a * f - c * d)
    I = a * e - b * d
    det = a * A + b * B + c * C
    inv = torch.stack(
        [torch.stack([A, Dc, G], -1), torch.stack([B, E, Hc], -1),
         torch.stack([C, F, I], -1)], -2) / det[..., None, None]
    return inv, det


def inv_small(S: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of batched 2×2 / 3×3 SPD matrices (..., n, n),
    the same cofactor expressions as the reference."""
    n = S.shape[-1]
    if n == 2:
        a, b = S[..., 0, 0], S[..., 0, 1]
        c, d = S[..., 1, 0], S[..., 1, 1]
        det = a * d - b * c
        inv = torch.stack(
            [torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2)
        return inv / det[..., None, None]
    if n == 3:
        a, b, c = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
        d, e, f = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
        g, h, i = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
        A = e * i - f * h
        B = -(d * i - f * g)
        C = d * h - e * g
        D = -(b * i - c * h)
        E = a * i - c * g
        F = -(a * h - b * g)
        G = b * f - c * e
        Hc = -(a * f - c * d)
        I = a * e - b * d
        det = a * A + b * B + c * C
        inv = torch.stack(
            [torch.stack([A, D, G], -1), torch.stack([B, E, Hc], -1),
             torch.stack([C, F, I], -1)], -2)
        return inv / det[..., None, None]
    return spd_inverse(S)


def chi2_quantile(p: float, dof: int) -> float:
    """χ² quantile, computed on the host (the reference's boost quantile)."""
    from scipy.stats import chi2

    return float(chi2.ppf(p, dof))
