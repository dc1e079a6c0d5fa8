"""Bernstein/Bézier extrapolation over a stamped sensor window (port of
``smarc_navigation_tpu/ops/bezier.py``).

The reference covers DVL dropouts by extrapolating the last W readings with
Bernstein-polynomial weights (``odom_provider.cpp:126-165``,
``ekf_localization.cpp:328-358``): with window stamps s_0..s_n (oldest..
newest) and query time t, the parameter is x = (t - s_n)/(s_n - s_0) and the
reading taken with coefficient C(n,l)·(1-x)^{n-l}·x^l is the (n-l)-th newest.
A degenerate window (|span| < 1e-9) takes the latest reading.
"""

from __future__ import annotations

import math

import torch


def bernstein_weights(stamps: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Per-window-slot weights, oldest..newest order.

    stamps: (..., W) ascending; t: (...,) query time -> (..., W) weights.
    """
    W = stamps.shape[-1]
    n = W - 1
    span = stamps[..., -1] - stamps[..., 0]
    degenerate = torch.abs(span) < 1e-9
    safe_span = torch.where(degenerate, torch.ones_like(span), span)
    x = (t - stamps[..., -1]) / safe_span
    ls = torch.arange(W, dtype=stamps.dtype, device=stamps.device)
    binom = torch.tensor([math.comb(n, l) for l in range(W)], dtype=stamps.dtype,
                         device=stamps.device)
    # coefficient for index l weights reading (n-l) [0-indexed from newest]
    coef = binom * (1.0 - x[..., None]) ** (n - ls) * x[..., None] ** ls
    # value index (n-l) from newest == l from oldest
    weights = torch.flip(coef, dims=(-1,))
    latest = torch.zeros(W, dtype=stamps.dtype, device=stamps.device)
    latest[-1] = 1.0
    return torch.where(degenerate[..., None], latest, weights)


def bezier_interpolate(
    values: torch.Tensor,   # (..., W, D) oldest..newest
    stamps: torch.Tensor,   # (..., W)
    t: torch.Tensor,        # (...,)
) -> torch.Tensor:
    """Extrapolated reading at time t: Σ_l w_l · v_l  -> (..., D)."""
    w = bernstein_weights(stamps, t)
    return torch.einsum("...w,...wd->...d", w, values)
