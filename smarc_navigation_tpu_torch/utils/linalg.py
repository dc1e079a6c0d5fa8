"""Small-matrix linear algebra for the filters (port of the reference's
``utils/linalg.py`` subset the port needs)."""

from __future__ import annotations

import torch


def symmetrize(a: torch.Tensor) -> torch.Tensor:
    """0.5 (A + Aᵀ) over the trailing two dims."""
    return 0.5 * (a + torch.swapaxes(a, -1, -2))


def spd_solve(S: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve S x = b for SPD S (..., n, n) against b (..., n) or (..., n, k):
    a Cholesky solve of ``symmetrize(S)``."""
    chol = torch.linalg.cholesky(symmetrize(S))
    if b.dim() == S.dim() - 1:
        return torch.cholesky_solve(b[..., None], chol)[..., 0]
    return torch.cholesky_solve(b, chol)


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
    raise ValueError(f"inv_small handles 2x2 and 3x3 only, got {n}x{n}")


def chi2_quantile(p: float, dof: int) -> float:
    """χ² quantile, computed on the host (the reference's boost quantile)."""
    from scipy.stats import chi2

    return float(chi2.ppf(p, dof))
