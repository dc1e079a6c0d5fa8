"""SAM thrust-dynamics motion model (PyTorch port of
``smarc_navigation_tpu/models/motion_model.py``).

Body-plane acceleration from thruster rpm and horizontal thrust-vector angle
(``sam_dead_reckoning/scripts/sam_mm.py:10-120``),

    nudot = M⁻¹ · τ(rpm, dr),   τ = (K_T·rpm·cos(dr), -K_T·rpm·sin(dr), 0)

with the rigid-body mass matrix M built from (m, I_zz, x_g, y_g); its
inverse is a constant folded on the host. ``state_jacobian`` is the
reference's ``jacF`` (``sam_mm.py:128-145``) by forward-mode AD.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd

from ..configs import SAMConfig


def mass_matrix(cfg: SAMConfig = SAMConfig()) -> np.ndarray:
    m, xg, yg = cfg.mass, cfg.x_g, cfg.y_g
    return np.array(
        [
            [m, 0.0, -m * yg],
            [0.0, m, m * xg],
            [-m * yg, m * xg, cfg.izz],
        ]
    )


def thrust_tau(control: torch.Tensor, cfg: SAMConfig = SAMConfig()) -> torch.Tensor:
    """control (..., 2) = (rpm, dr) -> body-plane generalized force (..., 3)."""
    rpm = control[..., 0] * cfg.rpm_scale
    dr = control[..., 1] * cfg.d_scale
    f_t = cfg.kt * rpm
    return torch.stack([f_t * torch.cos(dr), -f_t * torch.sin(dr), torch.zeros_like(f_t)], dim=-1)


def acceleration(control: torch.Tensor, cfg: SAMConfig = SAMConfig()) -> torch.Tensor:
    """control (..., 2) -> (u̇, v̇, ṙ) body accelerations (..., 3)
    (``SAM.motion(control)``, ``sam_mm.py:117-120``)."""
    inv_m = torch.as_tensor(np.linalg.inv(mass_matrix(cfg)), dtype=torch.float32,
                            device=control.device)
    return torch.einsum("ij,...j->...i", inv_m, thrust_tau(control, cfg))


def dr_fallback_velocity(control: torch.Tensor, dr_period: float,
                         cfg: SAMConfig = SAMConfig()) -> torch.Tensor:
    """Motion-model fallback linear velocity used when DVL drops out
    (``dr_node.py:191-201``): planar accelerations with y flipped and the
    angular term zeroed, times the DR period."""
    acc = acceleration(control, cfg)
    acc = torch.stack([acc[..., 0], -acc[..., 1], torch.zeros_like(acc[..., 0])], dim=-1)
    return acc * dr_period


def state_jacobian(eom_fn, state: torch.Tensor, control: torch.Tensor, dt: float) -> torch.Tensor:
    """I + dt · ∂f/∂x, exact where the reference used central differences."""
    J = jacfwd(lambda s: eom_fn(s, control))(state)
    return torch.eye(state.shape[-1], dtype=state.dtype, device=state.device) + dt * J
