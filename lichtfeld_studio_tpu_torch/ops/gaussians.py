"""Quaternion / covariance math for 3D Gaussians (counterpart of
lichtfeld_studio_tpu/ops/gaussians.py): rotation from the unnormalised wxyz
quaternion via division by |q|^2, variance exp(2 * log_scale),
cov3d = R diag(var) R^T, all as float32 elementwise sums."""

from __future__ import annotations

import torch


def quat_to_rotmat(quat: torch.Tensor, eps: float = 1e-24) -> torch.Tensor:
    """[..., 4] wxyz (unnormalised) -> [..., 3, 3] rotation matrix.
    Degenerate |q| ~ 0 inputs give garbage that the caller masks."""
    w, x, y, z = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    n = torch.clamp(w * w + x * x + y * y + z * z, min=eps)
    s = 2.0 / n
    xx, yy, zz = s * x * x, s * y * y, s * z * z
    xy, xz, yz = s * x * y, s * x * z, s * y * z
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    r = torch.stack(
        [
            1.0 - (yy + zz), xy - wz, wy + xz,
            wz + xy, 1.0 - (xx + zz), yz - wx,
            xz - wy, wx + yz, 1.0 - (xx + yy),
        ],
        dim=-1,
    )
    return r.reshape(quat.shape[:-1] + (3, 3))


def quat_scale_to_cov3d(quat: torch.Tensor, log_scale: torch.Tensor) -> torch.Tensor:
    """(quat [...,4], log_scale [...,3]) -> cov3d [...,3,3] = R diag(e^{2s}) R^T,
    as explicit products and sums (no TF32 matmul)."""
    rot = quat_to_rotmat(quat)
    var = torch.exp(2.0 * log_scale)
    m = rot * var[..., None, :]  # R @ diag(var)
    # cov_ij = sum_k m_ik * rot_jk, exactly symmetric by construction
    return (m[..., :, None, :] * rot[..., None, :, :]).sum(-1)
