"""SO(3) / quaternion / rigid-transform primitives on torch tensors.

Port of ``smarc_navigation_tpu/utils/geometry.py``.
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
# odometry values this wide or wider carry the nav_msgs layout [pos3,
# quat4 (xyzw), linvel3, angvel3]; narrower ones are a [pos3, rpy3] track
ODOM_QUAT_WIDTH = 13


def wrap_angle(a: torch.Tensor) -> torch.Tensor:
    """Wrap angle(s) to [-pi, pi). Elementwise (floored modulo, as jnp.mod)."""
    return torch.remainder(a + math.pi, _TWO_PI) - math.pi


def wrap_rpy(mu: torch.Tensor) -> torch.Tensor:
    """Wrap components 3:6 of a 6-DOF pose vector (..., 6)."""
    return torch.cat([mu[..., 0:3], wrap_angle(mu[..., 3:6]), mu[..., 6:]], dim=-1)


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


def quat_from_rpy(rpy: torch.Tensor) -> torch.Tensor:
    """(..., 3) rpy -> (..., 4) xyzw quaternion (tf createQuaternionFromRPY)."""
    hr, hp, hy = rpy[..., 0] * 0.5, rpy[..., 1] * 0.5, rpy[..., 2] * 0.5
    cr, sr = torch.cos(hr), torch.sin(hr)
    cp, sp = torch.cos(hp), torch.sin(hp)
    cy, sy = torch.cos(hy), torch.sin(hy)
    x = sr * cp * cy - cr * sp * sy
    y = cr * sp * cy + sr * cp * sy
    z = cr * cp * sy - sr * sp * cy
    w = cr * cp * cy + sr * sp * sy
    return torch.stack([x, y, z, w], dim=-1)


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


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 ⊗ q2 in xyzw (tf quaternion_multiply order)."""
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype, device=q.device)


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


def quat_from_rotmat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> xyzw quaternion (Shepperd's method): the four
    candidate formulations, the best-conditioned one picked per element
    with ``torch.where``, as the reference does."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def root(x):
        return torch.sqrt(torch.clamp(x, min=1e-12)) * 2.0

    s = root(tr + 1.0)
    qw = torch.stack([(m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s, 0.25 * s], -1)
    s = root(1.0 + m00 - m11 - m22)
    qx = torch.stack([0.25 * s, (m01 + m10) / s, (m02 + m20) / s, (m21 - m12) / s], -1)
    s = root(1.0 + m11 - m00 - m22)
    qy = torch.stack([(m01 + m10) / s, 0.25 * s, (m12 + m21) / s, (m02 - m20) / s], -1)
    s = root(1.0 + m22 - m00 - m11)
    qz = torch.stack([(m02 + m20) / s, (m12 + m21) / s, 0.25 * s, (m10 - m01) / s], -1)
    use_w = tr > 0.0
    use_x = (~use_w) & (m00 >= m11) & (m00 >= m22)
    use_y = (~use_w) & (~use_x) & (m11 >= m22)
    q = torch.where(use_w[..., None], qw,
                    torch.where(use_x[..., None], qx,
                                torch.where(use_y[..., None], qy, qz)))
    return quat_normalize(q)


def rpy_from_quat(q: torch.Tensor) -> torch.Tensor:
    """xyzw quaternion -> roll/pitch/yaw (tf euler_from_quaternion)."""
    return rpy_from_rotmat(rotmat_from_quat(q))


def odom_pose(value: torch.Tensor) -> torch.Tensor:
    """Raw odometry (..., W) -> [pos3, rpy3] (..., 6): a 6-wide pose track as
    it is, a nav_msgs value (W >= ODOM_QUAT_WIDTH) with its quaternion
    converted by ``rpy_from_quat``."""
    if value.shape[-1] >= ODOM_QUAT_WIDTH:
        return torch.cat([value[..., 0:3], rpy_from_quat(value[..., 3:7])], dim=-1)
    return value[..., 0:6]


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v (..., 3) by quaternion(s) q (..., 4)."""
    return torch.einsum("...ij,...j->...i", rotmat_from_quat(q), v)


class Transform(NamedTuple):
    """Rigid transform: x_parent = rot @ x_child + trans."""

    rot: torch.Tensor    # (..., 3, 3)
    trans: torch.Tensor  # (..., 3)

    def apply(self, v: torch.Tensor) -> torch.Tensor:
        return torch.einsum("...ij,...j->...i", self.rot, v) + self.trans

    def rotate(self, v: torch.Tensor) -> torch.Tensor:
        """Apply only the rotation (tf's getBasis() * v)."""
        return torch.einsum("...ij,...j->...i", self.rot, v)

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
    def from_rpy_trans(rpy: torch.Tensor, trans: torch.Tensor) -> "Transform":
        return Transform(rot=rotmat_from_rpy(rpy),
                         trans=torch.as_tensor(trans, dtype=rpy.dtype, device=rpy.device))

    @staticmethod
    def from_quat_trans(q: torch.Tensor, trans: torch.Tensor) -> "Transform":
        return Transform(rot=rotmat_from_quat(q),
                         trans=torch.as_tensor(trans, dtype=q.dtype, device=q.device))

    @staticmethod
    def from_pose(mu: torch.Tensor) -> "Transform":
        """6-DOF pose (x,y,z,roll,pitch,yaw) -> map<-base transform."""
        return Transform(rot=rotmat_from_rpy(mu[..., 3:6]), trans=mu[..., 0:3])


class FrameGraph:
    """Static rigid-frame registry (the tf tree lookups the reference blocks
    on at node init, ``ekf_localization.cpp:138-161``): frames are registered
    once; ``get(a, b)`` returns the constant Transform taking b-frame vectors
    into a-frame, composed along the tree. Identities and compositions take
    the dtype and device of the registered edges."""

    def __init__(self):
        self._edges = {}   # (parent, child) -> Transform
        self._parent = {}  # child -> parent

    def add(self, parent: str, child: str, tf: Transform) -> None:
        if child in self._parent and self._parent[child] != parent:
            raise ValueError(f"frame {child!r} already has parent {self._parent[child]!r}")
        self._edges[(parent, child)] = tf
        self._parent[child] = parent

    def _path_to_root(self, frame: str):
        path = [frame]
        while path[-1] in self._parent:
            path.append(self._parent[path[-1]])
        return path

    def _identity(self) -> Transform:
        like = next(iter(self._edges.values()), None)
        if like is None:
            raise KeyError("no frames registered")
        return Transform.identity(like.rot.dtype, like.rot.device)

    def get(self, target: str, source: str) -> Transform:
        """Transform taking source-frame vectors into target frame."""
        up_t = self._path_to_root(target)
        up_s = self._path_to_root(source)
        up_t_set = set(up_t)
        common = next((f for f in up_s if f in up_t_set), None)
        if common is None:
            raise KeyError(f"no path between frames {target!r} and {source!r}")

        def chain_to(frame, stop):
            tf = self._identity()
            f = frame
            while f != stop:
                p = self._parent[f]
                tf = self._edges[(p, f)].compose(tf)
                f = p
            return tf

        return chain_to(target, common).inverse().compose(chain_to(source, common))
