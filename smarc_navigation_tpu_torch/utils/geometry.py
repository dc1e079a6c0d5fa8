"""SO(3) / quaternion / rigid-transform primitives on torch tensors.

Port of ``smarc_navigation_tpu/utils/geometry.py`` (the slice's subset).
Conventions are the reference's (ROS tf): quaternions (x, y, z, w); Euler
angles fixed-axis XYZ roll/pitch/yaw, ``R = Rz(yaw) @ Ry(pitch) @ Rx(roll)``;
``wrap_angle`` maps to [-pi, pi) with a floored modulo.

All functions broadcast over leading batch dims.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

_TWO_PI = 2.0 * math.pi


def wrap_angle(a: torch.Tensor) -> torch.Tensor:
    """Wrap angle(s) to [-pi, pi). Elementwise (floored modulo, as jnp.mod)."""
    return torch.remainder(a + math.pi, _TWO_PI) - math.pi


def rotmat_from_rpy(rpy: torch.Tensor) -> torch.Tensor:
    """(..., 3) rpy -> (..., 3, 3) rotation, R = Rz(yaw) Ry(pitch) Rx(roll)."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    row0 = torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], dim=-1)
    row1 = torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], dim=-1)
    row2 = torch.stack([-sp, cp * sr, cp * cr], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def rpy_from_rotmat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 3) roll/pitch/yaw (tf getRPY solution 1)."""
    sp = torch.clamp(-R[..., 2, 0], -1.0, 1.0)
    pitch = torch.arcsin(sp)
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([roll, pitch, yaw], dim=-1)


def quat_from_rpy_np(rpy):
    """(..., 3) rpy -> (..., 4) xyzw quaternion, numpy (host-side timeline
    preprocessing; bit-for-bit the reference's ``quat_from_rpy_np``)."""
    rpy = np.asarray(rpy)
    hr, hp, hy = rpy[..., 0] * 0.5, rpy[..., 1] * 0.5, rpy[..., 2] * 0.5
    cr, sr = np.cos(hr), np.sin(hr)
    cp, sp = np.cos(hp), np.sin(hp)
    cy, sy = np.cos(hy), np.sin(hy)
    return np.stack([
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
        cr * cp * cy + sr * sp * sy,
    ], axis=-1)


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + eps)


def rotmat_from_quat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) xyzw -> (..., 3, 3). Normalizes internally."""
    q = quat_normalize(q)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    row0 = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1)
    row1 = torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1)
    row2 = torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def rpy_from_quat(q: torch.Tensor) -> torch.Tensor:
    """xyzw quaternion -> roll/pitch/yaw (tf euler_from_quaternion)."""
    return rpy_from_rotmat(rotmat_from_quat(q))


class Transform(NamedTuple):
    """Rigid transform: x_parent = rot @ x_child + trans."""

    rot: torch.Tensor    # (..., 3, 3)
    trans: torch.Tensor  # (..., 3)

    def apply(self, v: torch.Tensor) -> torch.Tensor:
        return torch.einsum("...ij,...j->...i", self.rot, v) + self.trans

    def compose(self, other: "Transform") -> "Transform":
        """self ∘ other: compose(other).apply(x) == self.apply(other.apply(x))."""
        return Transform(
            rot=torch.einsum("...ij,...jk->...ik", self.rot, other.rot),
            trans=self.apply(other.trans),
        )

    def inverse(self) -> "Transform":
        rot_t = torch.swapaxes(self.rot, -1, -2)
        return Transform(rot=rot_t,
                         trans=-torch.einsum("...ij,...j->...i", rot_t, self.trans))

    @staticmethod
    def identity(dtype=torch.float32, device="cuda") -> "Transform":
        return Transform(rot=torch.eye(3, dtype=dtype, device=device),
                         trans=torch.zeros(3, dtype=dtype, device=device))

    @staticmethod
    def from_pose(mu: torch.Tensor) -> "Transform":
        """6-DOF pose (x,y,z,roll,pitch,yaw) -> map<-base transform."""
        return Transform(rot=rotmat_from_rpy(mu[..., 3:6]), trans=mu[..., 0:3])
