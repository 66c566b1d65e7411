"""Training losses (counterpart of lichtfeld_studio_tpu/ops/losses.py;
reference trainer.cpp compute_* methods :103-170). They are summed into one
scalar and differentiated once, as in the JAX package."""

from __future__ import annotations

import torch

from lichtfeld_studio_tpu_torch.core.splat_data import SplatData
from lichtfeld_studio_tpu_torch.ops.ssim import ssim


def photometric_loss(rendered: torch.Tensor, gt: torch.Tensor, lambda_dssim: float) -> torch.Tensor:
    """(1-λ)·L1 + λ·(1 − SSIM_valid)  (trainer.cpp:123-127)."""
    l1 = (rendered - gt).abs().mean()
    return (1.0 - lambda_dssim) * l1 + lambda_dssim * (1.0 - ssim(rendered, gt))


def scale_reg_loss(splats: SplatData, scale_reg: float) -> torch.Tensor:
    """scale_reg * mean(exp(scaling)) over the live prefix (trainer.cpp:139-143)."""
    if scale_reg <= 0:
        return torch.zeros((), device=splats.means.device)
    mask = splats.active_mask()
    total = torch.where(mask[:, None], splats.get_scaling(), 0.0).sum()
    return scale_reg * total / torch.clamp(splats.n_active * 3, min=1)


def opacity_reg_loss(splats: SplatData, opacity_reg: float) -> torch.Tensor:
    """opacity_reg * mean(sigmoid(opacity)) over the live prefix (trainer.cpp:155-159)."""
    if opacity_reg <= 0:
        return torch.zeros((), device=splats.means.device)
    mask = splats.active_mask()
    total = torch.where(mask[:, None], splats.get_opacity(), 0.0).sum()
    return opacity_reg * total / torch.clamp(splats.n_active, min=1)
