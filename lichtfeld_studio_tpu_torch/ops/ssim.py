"""SSIM and PSNR (counterpart of lichtfeld_studio_tpu/ops/ssim.py).

Separable 11-tap Gaussian windows (sigma 1.5), "valid" padding, C1 = 0.01^2,
C2 = 0.03^2 (reference ssim.cu:16-27, metrics.hpp:49-50). The blur is
written as 11 + 11 shifted float32 adds in the JAX package's order, not as
a convolution: a float32 convolution on the card may run through cuDNN in
TF32 (about three decimal digits), and the variance terms
blur(x^2) - mu^2 cancel; the shifted adds are also the reference's
numerics. Differentiable by autograd."""

from __future__ import annotations

import torch

_WINDOW_SIZE = 11
_SIGMA = 1.5
C1 = 0.01**2
C2 = 0.03**2


def _gaussian_window(device) -> torch.Tensor:
    x = torch.arange(_WINDOW_SIZE, dtype=torch.float32, device=device) - (_WINDOW_SIZE // 2)
    g = torch.exp(-(x**2) / (2.0 * _SIGMA**2))
    return g / g.sum()


def _blur_valid(img: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Separable 11x11 Gaussian blur, valid padding. img: [H, W, C] ->
    [H-10, W-10, C]."""
    h, w = img.shape[0], img.shape[1]
    ho, wo = h - (_WINDOW_SIZE - 1), w - (_WINDOW_SIZE - 1)
    x = g[0] * img[0:ho]
    for k in range(1, _WINDOW_SIZE):
        x = x + g[k] * img[k : ho + k]
    out = g[0] * x[:, 0:wo]
    for k in range(1, _WINDOW_SIZE):
        out = out + g[k] * x[:, k : wo + k]
    return out


def ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean SSIM over valid pixels. Inputs [H, W, C] in [0, 1]."""
    g = _gaussian_window(img1.device)
    mu1 = _blur_valid(img1, g)
    mu2 = _blur_valid(img2, g)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = _blur_valid(img1 * img1, g) - mu1_sq
    sigma2_sq = _blur_valid(img2 * img2, g) - mu2_sq
    sigma12 = _blur_valid(img1 * img2, g) - mu1_mu2
    ssim_map = ((2.0 * mu1_mu2 + C1) * (2.0 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)
    )
    return ssim_map.mean()


def psnr(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Reference metrics.cpp PSNR: 10 log10(range^2 / mse)."""
    mse = ((pred - target) ** 2).mean()
    return 10.0 * torch.log10(data_range**2 / torch.clamp(mse, min=1e-12))
