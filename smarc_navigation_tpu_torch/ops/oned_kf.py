"""Scalar constant-state Kalman smoother (PyTorch port of
``smarc_navigation_tpu/ops/oned_kf.py``).

The reference's OneDKF (``auv_ekf_localization/src/noise_oneD_kf.cpp:17-37``),
which de-noises the DVL velocity axes of the LoLo odometry provider
(``auv_odom_provider/src/odom_provider.cpp:94-96,311-313``). Per step:

    σ̂ = σ + r;  k = σ̂ / (σ̂ + q);  μ += k (z - μ);  σ = (1-k) σ̂

All operations are elementwise, so one call smooths one axis or a whole
(fleet × axes) tensor of them.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class OneDKFState(NamedTuple):
    mu: torch.Tensor
    sigma: torch.Tensor


def init(mu0=0.0, sigma0=1.0, like: torch.Tensor | None = None,
         device="cuda") -> OneDKFState:
    """A state shaped like ``like`` (on its device), or a scalar state on
    ``device``."""
    if like is not None:
        return OneDKFState(torch.full_like(like, mu0), torch.full_like(like, sigma0))
    return OneDKFState(torch.tensor(mu0, dtype=torch.float32, device=device),
                       torch.tensor(sigma0, dtype=torch.float32, device=device))


def step(state: OneDKFState, z: torch.Tensor, r: float, q: float) -> OneDKFState:
    sigma_hat = state.sigma + r
    k = sigma_hat / (sigma_hat + q)
    mu = state.mu + k * (z - state.mu)
    sigma = (1.0 - k) * sigma_hat
    return OneDKFState(mu=mu, sigma=sigma)


def masked_step(
    state: OneDKFState, z: torch.Tensor, r: float, q: float, valid: torch.Tensor
) -> OneDKFState:
    """Update only where ``valid`` (dropout handling); elsewhere hold state."""
    nxt = step(state, z, r, q)
    return OneDKFState(mu=torch.where(valid, nxt.mu, state.mu),
                       sigma=torch.where(valid, nxt.sigma, state.sigma))


def smooth(
    zs: torch.Tensor, mu0=0.0, sigma0=1.0, r=10.0, q=20.0
) -> Tuple[OneDKFState, torch.Tensor]:
    """Filter a whole sequence: zs (T, ...) -> (final state, filtered (T, ...))."""
    s = init(mu0, sigma0, like=zs[0])
    out = []
    for z in zs:
        s = step(s, z, r, q)
        out.append(s.mu)
    return s, torch.stack(out)
