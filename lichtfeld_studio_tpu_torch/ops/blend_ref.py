"""Reference (oracle) alpha blending in plain float32 torch (counterpart of
lichtfeld_studio_tpu/ops/blend_ref.py).

The semantics of blend_cu (fastgs kernels_forward.cuh:356-461) as masked
prefix products:

  * alpha_i = min(opacity * exp(-sigma/2), 0.999), zeroed when sigma/2 < 0
    or alpha < 1/255;
  * the running transmittance P_i = prod_{j<=i} (1 - alpha_j) is monotone,
    so the done flag (stop before applying once P_i < threshold) is the mask
    counted_i = (P_i >= threshold);
  * the final transmittance is the product over counted terms.

This is the ground truth for the blend kernel and the core of its plain
version (kernels/blend.py)."""

from __future__ import annotations

import torch

from lichtfeld_studio_tpu_torch.ops.projection import (
    MAX_FRAGMENT_ALPHA,
    MIN_ALPHA_THRESHOLD,
    TRANSMITTANCE_THRESHOLD,
)


def compute_alphas(
    mean2d: torch.Tensor,  # [..., K, 2]
    conic: torch.Tensor,  # [..., K, 3] (a, b, c)
    opacity: torch.Tensor,  # [..., K]
    px: torch.Tensor,  # [..., P] pixel-centre x
    py: torch.Tensor,  # [..., P] pixel-centre y
) -> torch.Tensor:
    """Per (instance, pixel) alpha with the skip masks applied: [..., K, P]."""
    dx = mean2d[..., :, None, 0] - px[..., None, :]
    dy = mean2d[..., :, None, 1] - py[..., None, :]
    a = conic[..., :, None, 0]
    b = conic[..., :, None, 1]
    c = conic[..., :, None, 2]
    sigma_over_2 = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
    gaussian = torch.exp(-torch.clamp(sigma_over_2, min=0.0))
    alpha = torch.clamp(opacity[..., :, None] * gaussian, max=MAX_FRAGMENT_ALPHA)
    keep = (sigma_over_2 >= 0.0) & (alpha >= MIN_ALPHA_THRESHOLD)
    return torch.where(keep, alpha, 0.0)


def blend_weights(
    alphas: torch.Tensor,  # [..., K, P] masked alphas in front-to-back order
    threshold: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Front-to-back blending weights w = T_before * alpha and the counted
    mask, both [..., K, P].

    `threshold` > 0 adds an early stop on top of the reference done flag:
    a pixel stops once its transmittance AFTER a counted contribution is
    below `threshold` (1/512 for inference renders). What the stop leaves
    out is at most that transmittance. The done flag itself stays at the
    reference's 1e-4: cutting the crossing contribution at 1/512 instead
    would drop a lone 0.999-alpha gaussian (T = 0.001) from an empty pixel.
    Training passes 0: the done flag is the only rule."""
    cum = torch.cumprod(1.0 - alphas, dim=-2)  # P_i
    t_before = torch.cat([torch.ones_like(cum[..., :1, :]), cum[..., :-1, :]], dim=-2)
    counted = cum >= TRANSMITTANCE_THRESHOLD
    if threshold > 0.0:
        counted &= t_before >= threshold
    return torch.where(counted, t_before * alphas, 0.0), counted


def blend_along_axis(
    alphas: torch.Tensor,  # [..., K, P] masked alphas in front-to-back order
    colors: torch.Tensor,  # [..., K, C] (unclamped; clamped to >= 0 here)
    threshold: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Composite along the K axis (see blend_weights for `threshold`).
    Returns (color [..., P, C], transmittance [..., P])."""
    w, counted = blend_weights(alphas, threshold)
    col = torch.clamp(colors, min=0.0)  # fetch-time clamp (kernels_forward.cuh:419)
    color_out = torch.einsum("...kp,...kc->...pc", w, col)
    t_final = torch.where(counted, 1.0 - alphas, 1.0).prod(dim=-2)
    return color_out, t_final
