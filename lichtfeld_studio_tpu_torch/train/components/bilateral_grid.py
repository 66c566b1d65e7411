"""Bilateral-grid appearance modelling (counterpart of
lichtfeld_studio_tpu/train/components/bilateral_grid.py; reference
src/training/components/bilateral_grid.cpp and the slice / TV kernels,
bilateral_grid_forward.cu:13-110, bilateral_grid_tv.cu:12-80).

Per-image [12, L, H, W] grids of 3x4 affine colour transforms, identity at
the start; `slice_grid` trilinearly samples the grid at (x / w, y / h,
luminance) and applies the affine to the rendered RGB. Plain PyTorch,
differentiated by autograd: the JAX package has no kernel here either. The
luminance weights and the affine are explicit float32 sums (no TF32). The
backward of the 8-corner gather is index_add_, which accumulates with
atomics on a GPU.

Training: its own Adam (lr 2e-3) with a 1000-step warmup-exponential
schedule starting at 1% (reference trainer.cpp:78-91,
scheduler.hpp:29-59).
"""

from __future__ import annotations

import numpy as np
import torch

_C2G = (0.299, 0.587, 0.114)  # bilateral_grid_forward.cu:11


def identity_grids(num_images: int, grid_w: int = 16, grid_h: int = 16, grid_l: int = 8,
                   device=None) -> torch.Tensor:
    """[N, 12, L, H, W] grids set to the identity affine
    (bilateral_grid.cpp:84-93)."""
    eye = torch.eye(4, dtype=torch.float32, device=device)[:3].reshape(-1)  # row-major 3x4
    return eye[None, :, None, None, None].repeat(num_images, 1, grid_l, grid_h, grid_w)


def slice_grid(grid: torch.Tensor, rgb: torch.Tensor) -> torch.Tensor:
    """Apply one image's grid: grid [12, L, H, W], rgb [h, w, 3] in [0, 1]
    -> [h, w, 3] (slice_forward_kernel semantics, uniform coordinates)."""
    h, w, _ = rgb.shape
    l, gh, gw = grid.shape[1], grid.shape[2], grid.shape[3]
    dev = rgb.device
    rgb_c = torch.clamp(rgb, 0.0, 1.0)
    ys, xs = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                            indexing="ij")
    x = xs.to(torch.float32) / max(w - 1, 1) * (gw - 1)
    y = ys.to(torch.float32) / max(h - 1, 1) * (gh - 1)
    z = (rgb_c[..., 0] * _C2G[0] + rgb_c[..., 1] * _C2G[1] + rgb_c[..., 2] * _C2G[2]) * (l - 1)
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, gw - 1)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, gh - 1)
    z0 = torch.clamp(torch.floor(z).to(torch.int64), 0, l - 1)
    x1 = torch.clamp(x0 + 1, max=gw - 1)
    y1 = torch.clamp(y0 + 1, max=gh - 1)
    z1 = torch.clamp(z0 + 1, max=l - 1)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    fz = (z - z0)[..., None]

    # the grid as a table of cells [L * H * W, 12]: each corner is one
    # index_select, whose backward is one index_add_ (the backward of
    # advanced indexing sorts its indices first: PERF.md, PR 8)
    table = grid.permute(1, 2, 3, 0).reshape(l * gh * gw, 12)

    def lerp_x(zi, yi):
        row = (zi * gh + yi) * gw

        def corner(xi):
            return table.index_select(0, (row + xi).reshape(-1)).view(h, w, 12)

        return corner(x0) * (1 - fx) + corner(x1) * fx

    c0 = lerp_x(z0, y0) * (1 - fy) + lerp_x(z0, y1) * fy
    c1 = lerp_x(z1, y0) * (1 - fy) + lerp_x(z1, y1) * fy
    affine = (c0 * (1 - fz) + c1 * fz).reshape(h, w, 3, 4)
    return (affine[..., :3] * rgb[..., None, :]).sum(-1) + affine[..., 3]


def apply_bilateral_grid(grids: torch.Tensor, rgb: torch.Tensor, image_idx: int) -> torch.Tensor:
    """grids [N, 12, L, H, W], rgb [h, w, 3], image_idx a camera uid."""
    return slice_grid(grids[image_idx], rgb)


def tv_loss(grids: torch.Tensor) -> torch.Tensor:
    """Total variation over (L, H, W), each direction normalised, averaged
    over channels and images (bilateral_grid_tv.cu:12-80)."""
    n, c, l, h, w = grids.shape

    def sq(x):
        return (x * x).sum()

    dx = sq(grids[..., :, :, 1:] - grids[..., :, :, :-1]) / (l * h * max(w - 1, 1))
    dy = sq(grids[..., :, 1:, :] - grids[..., :, :-1, :]) / (l * max(h - 1, 1) * w)
    dz = sq(grids[..., 1:, :, :] - grids[..., :-1, :, :]) / (max(l - 1, 1) * h * w)
    return (dx + dy + dz) / (c * n)


def warmup_exponential_lr(base_lr: float, step: int, total_steps: int, warmup_steps: int = 1000,
                          start_factor: float = 0.01, final_factor: float = 0.01) -> float:
    """The grid's LR at `step` (reference WarmupExponentialLR,
    scheduler.hpp:29-59): linear warmup from 1% over 1000 steps, then
    exponential decay to final_factor at total_steps. Float32 on the host,
    in the JAX package's order."""
    f32 = np.float32
    step_f = f32(step)
    warm = f32(start_factor) + f32(1.0 - start_factor) * min(step_f / f32(warmup_steps), f32(1.0))
    gamma = f32(final_factor ** (1.0 / max(total_steps - warmup_steps, 1)))
    decay = np.power(gamma, step_f - f32(warmup_steps), dtype=f32) if step_f > warmup_steps else f32(1.0)
    return float(f32(base_lr) * warm * decay)
