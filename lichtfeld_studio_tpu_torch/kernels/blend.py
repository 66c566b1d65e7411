"""Kernel P2 wrapper: forward tile blend (counterpart of the inference
variant of lichtfeld_studio_tpu/kernels/blend_pallas.py::blend_pallas_fused).

Inputs are the tile binning (tile_start / tile_count over the compact,
depth-sorted `gaussian_idx`) and the PER-GAUSSIAN projected features; the
kernel gathers each instance's features itself. Colours are float32 with
3 channels, or 4 when depth rides as the fourth. Returns
(image [Hp, Wp, C], alpha [Hp, Wp]) over the padded tile grid.

CUDA tensors launch csrc/blend_forward.cu (32-px tiles); CPU tensors take
the plain version: a port of lichtfeld_studio_tpu/ops/blend_tiles.py on
ops/blend_ref.py with no k_max truncation and the kernel's termination
rule (the reference done flag at 1e-4, and a pixel stops once a counted
contribution leaves its transmittance below 1/512).
"""

from __future__ import annotations

import torch

from lichtfeld_studio_tpu_torch.kernels import _build
from lichtfeld_studio_tpu_torch.ops.blend_ref import blend_along_axis, compute_alphas

# Inference termination threshold: what is left out after stopping at
# transmittance T is at most T (colours <= 1), so 1/512 stays under half a
# u8 step (the JAX package's INFERENCE_TERM_THRESHOLD).
INFERENCE_TERM_THRESHOLD = 1.0 / 512.0
KERNEL_TILE_SIZE = 32
# elements per [tiles, K, P] intermediate of the plain version; tiles are
# blended in groups that keep each intermediate under this size
_PLAIN_CHUNK_ELEMS = 1 << 24


def _check_inputs(tile_start, tile_count, gaussian_idx, mean2d, conic, opacity,
                  color, grid_w, grid_h):
    n_tiles = grid_w * grid_h
    n = mean2d.shape[0]
    expect = {
        "tile_start": (tile_start, torch.int32, (n_tiles,)),
        "tile_count": (tile_count, torch.int32, (n_tiles,)),
        "gaussian_idx": (gaussian_idx, torch.int32, (gaussian_idx.shape[0],)),
        "mean2d": (mean2d, torch.float32, (n, 2)),
        "conic": (conic, torch.float32, (n, 3)),
        "opacity": (opacity, torch.float32, (n,)),
        "color": (color, torch.float32, (n, color.shape[-1])),
    }
    for name, (t, dtype, shape) in expect.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"blend_forward: {name} must be {dtype} {shape}, got {t.dtype} {tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"blend_forward: {name} must be contiguous")
        if t.device != mean2d.device:
            raise ValueError(f"blend_forward: {name} is on {t.device}, mean2d on {mean2d.device}")
    if color.shape[1] not in (3, 4):
        raise ValueError(f"blend_forward: color needs 3 or 4 channels, got {color.shape[1]}")


def blend_forward_plain(
    tile_start, tile_count, gaussian_idx, mean2d, conic, opacity, color,
    *, grid_w: int, grid_h: int, tile_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense per-tile blend: gather each tile's instances up to the deepest
    tile's count, alphas [tiles, K, P], masked prefix products."""
    dev = mean2d.device
    ts = tile_size
    n_tiles = grid_w * grid_h
    n_pix = ts * ts
    n_ch = color.shape[1]
    i_cap = gaussian_idx.shape[0]
    k_max = max(int(tile_count.max()), 1)
    k = torch.arange(k_max, device=dev)
    rows, cols = torch.meshgrid(
        torch.arange(ts, device=dev), torch.arange(ts, device=dev), indexing="ij"
    )
    cols = cols.reshape(-1).to(torch.float32)
    rows = rows.reshape(-1).to(torch.float32)

    out_c = torch.empty((n_tiles, n_pix, n_ch), dtype=torch.float32, device=dev)
    out_t = torch.empty((n_tiles, n_pix), dtype=torch.float32, device=dev)
    step = max(1, _PLAIN_CHUNK_ELEMS // (k_max * n_pix))
    for t0 in range(0, n_tiles, step):
        tids = torch.arange(t0, min(t0 + step, n_tiles), device=dev)
        start = tile_start[tids].long()
        count = tile_count[tids].long()
        idx = torch.clamp(start[:, None] + k[None, :], 0, i_cap - 1)
        in_range = k[None, :] < count[:, None]
        g = gaussian_idx[idx].long()  # [t, K]
        opac = torch.where(in_range, opacity[g], 0.0)
        tx = ((tids % grid_w) * ts).to(torch.float32)
        ty = ((tids // grid_w) * ts).to(torch.float32)
        px = tx[:, None] + cols[None, :] + 0.5  # [t, P]
        py = ty[:, None] + rows[None, :] + 0.5
        alphas = compute_alphas(mean2d[g], conic[g], opac, px, py)  # [t, K, P]
        c, t_final = blend_along_axis(alphas, color[g], INFERENCE_TERM_THRESHOLD)
        out_c[t0 : t0 + len(tids)] = c
        out_t[t0 : t0 + len(tids)] = t_final

    image = (
        out_c.reshape(grid_h, grid_w, ts, ts, n_ch)
        .permute(0, 2, 1, 3, 4)
        .reshape(grid_h * ts, grid_w * ts, n_ch)
    )
    alpha = (
        (1.0 - out_t)
        .reshape(grid_h, grid_w, ts, ts)
        .permute(0, 2, 1, 3)
        .reshape(grid_h * ts, grid_w * ts)
    )
    return image, alpha


def blend_forward(
    tile_start: torch.Tensor,  # [T] int32 — first instance of each tile
    tile_count: torch.Tensor,  # [T] int32 — instances of each tile
    gaussian_idx: torch.Tensor,  # [I] int32 — owning gaussian, tile/depth order
    mean2d: torch.Tensor,  # [N, 2] f32
    conic: torch.Tensor,  # [N, 3] f32
    opacity: torch.Tensor,  # [N] f32
    color: torch.Tensor,  # [N, 3 or 4] f32 (unclamped)
    *,
    grid_w: int,
    grid_h: int,
    tile_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    _check_inputs(tile_start, tile_count, gaussian_idx, mean2d, conic, opacity,
                  color, grid_w, grid_h)
    kw = dict(grid_w=grid_w, grid_h=grid_h, tile_size=tile_size)
    if mean2d.device.type == "cpu":
        return blend_forward_plain(tile_start, tile_count, gaussian_idx, mean2d,
                                   conic, opacity, color, **kw)
    if mean2d.device.type != "cuda":
        raise ValueError(f"blend_forward: unsupported device {mean2d.device}")
    if tile_size != KERNEL_TILE_SIZE:
        raise ValueError(
            f"blend_forward: the CUDA kernel blends {KERNEL_TILE_SIZE}-px tiles, got {tile_size}"
        )
    lib = _build.load_library()
    n_ch = color.shape[1]
    hp, wp = grid_h * tile_size, grid_w * tile_size
    image = torch.empty((hp, wp, n_ch), dtype=torch.float32, device=mean2d.device)
    alpha = torch.empty((hp, wp), dtype=torch.float32, device=mean2d.device)
    stream = torch.cuda.current_stream(mean2d.device).cuda_stream
    err = lib.lfs_blend_forward(
        tile_start.data_ptr(), tile_count.data_ptr(), gaussian_idx.data_ptr(),
        mean2d.data_ptr(), conic.data_ptr(), opacity.data_ptr(), color.data_ptr(),
        n_ch, grid_w, grid_h, INFERENCE_TERM_THRESHOLD, image.data_ptr(), alpha.data_ptr(), stream,
    )
    _build.check(err, "lfs_blend_forward")
    blend_forward.launches += 1
    return image, alpha


blend_forward.launches = 0  # kernel launches since the last reset
