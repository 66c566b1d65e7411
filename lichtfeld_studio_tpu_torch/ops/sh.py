"""Spherical-harmonics colour evaluation, degrees 0-3 (counterpart of
lichtfeld_studio_tpu/ops/sh.py): `0.5 + C0 * sh0` DC term, view direction
normalize(mean - cam_position), all bases evaluated and masked by the
active degree."""

from __future__ import annotations

import torch

_C1 = 0.48860251190291987
_C2 = (1.0925484305920792, -1.0925484305920792, 0.94617469575755997,
       -0.31539156525251999, 0.54627421529603959)
_C3 = (0.59004358992664352, 2.8906114426405538, 0.45704579946446572,
       0.3731763325901154, 1.4453057213202769)
_C4 = (2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
       -0.6690465435572892, 0.10578554691520431, 0.47308734787878004,
       0.6258357354491761)

SH_C0 = 0.28209479177387814


def eval_sh_bases(dirs: torch.Tensor) -> torch.Tensor:
    """[..., 3] unit directions -> [..., 24] bases for l=1..4 (no DC term),
    in the JAX package's coefficient order."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    b = [
        # l = 1
        -_C1 * y,
        _C1 * z,
        -_C1 * x,
        # l = 2
        _C2[0] * xy,
        _C2[1] * yz,
        _C2[2] * zz + _C2[3],
        -_C2[0] * xz,
        _C2[4] * (xx - yy),
        # l = 3
        _C3[0] * y * (-3.0 * xx + yy),
        _C3[1] * xy * z,
        _C3[2] * y * (1.0 - 5.0 * zz),
        _C3[3] * z * (5.0 * zz - 3.0),
        _C3[2] * x * (1.0 - 5.0 * zz),
        _C3[4] * z * (xx - yy),
        _C3[0] * x * (-xx + 3.0 * yy),
        # l = 4
        _C4[0] * xy * (xx - yy),
        _C4[1] * yz * (3.0 * xx - yy),
        _C4[2] * xy * (7.0 * zz - 1.0),
        _C4[3] * yz * (7.0 * zz - 3.0),
        _C4[4] * (zz * (35.0 * zz - 30.0) + 3.0),
        _C4[3] * xz * (7.0 * zz - 3.0),
        _C4[5] * (xx - yy) * (7.0 * zz - 1.0),
        _C4[1] * xz * (xx - 3.0 * yy),
        _C4[6] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy)),
    ]
    return torch.stack(b, dim=-1)


def sh_to_color(
    sh0: torch.Tensor,  # [N, 1, 3]
    shN: torch.Tensor,  # [N, K-1, 3] with K-1 <= 15
    means: torch.Tensor,  # [N, 3]
    cam_position: torch.Tensor,  # [3]
    active_sh_degree: torch.Tensor | int,
) -> torch.Tensor:
    """View-dependent RGB per gaussian, [N, 3], unclamped (the blend clamps
    to >= 0 when it reads the colour)."""
    color = 0.5 + SH_C0 * sh0[:, 0, :]
    n_rest = shN.shape[1]
    if n_rest == 0:
        return color
    d = means - cam_position[None, :]
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)
    bases = eval_sh_bases(d)[:, :n_rest]  # [N, n_rest]
    active_bases = (active_sh_degree + 1) ** 2
    idx = torch.arange(1, n_rest + 1, dtype=torch.int32, device=means.device)
    mask = (idx < active_bases).to(bases.dtype)  # [n_rest]
    return color + ((bases * mask[None, :])[:, :, None] * shN).sum(1)
