"""Differentiable 3DGS rasterization (counterpart of
lichtfeld_studio_tpu/ops/rasterize.py).

projection -> tile binning -> blend -> background composite. Modes:
  * "oracle": dense per-pixel blend over all gaussians (tests, tiny scenes),
              differentiable by plain autograd;
  * "cuda":   the binned path, the counterpart of the JAX package's
              "pallas" mode: kernel P1 (expand) in the binning, then for
              inference the forward blend P2 alone, for training
              `blend_fused` (P2, and P3 + P4 in its backward).

Each stage runs inside a profiler range (profiling.stage: projection,
binning, P2, composite), which a trace reads as per-stage device time.

Render modes RGB / D / ED / RGB_D / RGB_ED composite depth as an extra
blend channel (accumulated depth = sum_i w_i depth_i; expected depth = that
/ alpha).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from lichtfeld_studio_tpu_torch.core.camera import CameraParams
from lichtfeld_studio_tpu_torch.core.splat_data import SplatData
from lichtfeld_studio_tpu_torch.kernels.blend import blend_forward, blend_fused
from lichtfeld_studio_tpu_torch.ops import blend_ref
from lichtfeld_studio_tpu_torch.ops.projection import ProjectedSplats, project_gaussians
from lichtfeld_studio_tpu_torch.ops.tiles import build_tile_assignment
from lichtfeld_studio_tpu_torch.profiling import stage

# the port computes in float32 wherever the JAX package pinned precision
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@dataclass
class RenderOutput:
    image: torch.Tensor  # [H, W, 3]
    alpha: torch.Tensor  # [H, W]
    depth: torch.Tensor | None  # [H, W] accumulated depth (None unless requested)
    n_instances: torch.Tensor  # [] int32 true instance count (overflow detection)
    visibility: torch.Tensor | None  # [C] bool — gaussian touched any tile
    width: int = 0
    height: int = 0


def _project(splats: SplatData, camera: CameraParams, *, tile_size: int) -> ProjectedSplats:
    return project_gaussians(
        splats.means, splats.scaling, splats.rotation, splats.opacity,
        splats.sh0, splats.shN, splats.active_mask(), splats.active_sh_degree,
        camera.w2c, camera.cam_position, camera.K,
        width=camera.width, height=camera.height, tile_size=tile_size,
        # coarser tiles -> tiny bboxes: a 16-cell exact test at 32-px tiles
        exact_tile_cap=32 if tile_size < 32 else 16,
    )


def count_instances(splats: SplatData, camera: CameraParams, *, tile_size: int = 32) -> torch.Tensor:
    """Scalar: total tile instances this view would bin (projection only,
    no sort, no blend) — the headless renderer's probe for a snug cap."""
    return _project(splats, camera, tile_size=tile_size).n_touched.sum()


def rasterize(
    splats: SplatData,
    camera: CameraParams,
    bg_color: torch.Tensor,  # [3]
    *,
    mode: str = "cuda",
    tile_size: int | None = None,
    instance_cap: int = 2**20,
    with_depth: bool = False,
    projection: str = "auto",
    gut_exact: bool = False,
    inference: bool = False,
) -> RenderOutput:
    """`inference=True` selects the forward-only binning layout (fused sort
    key, no gradient); do not differentiate through an inference render.
    `tile_size=None` picks 32 px for inference renders, 16 otherwise."""
    if projection not in ("auto", "ewa"):
        raise NotImplementedError(
            f"projection={projection!r}: the UT projection comes with the GUT path "
            "(ROADMAP.md, queue 1)"
        )
    if gut_exact:
        raise NotImplementedError("gut_exact comes with the GUT path (ROADMAP.md, queue 1)")
    if tile_size is None:
        tile_size = 32 if (inference and mode == "cuda") else 16
    width, height = camera.width, camera.height
    grid_w = -(-width // tile_size)
    grid_h = -(-height // tile_size)

    if mode not in ("oracle", "cuda"):
        raise ValueError(f"unknown rasterize mode: {mode}")
    with stage("projection"):
        proj = _project(splats, camera, tile_size=tile_size)
        color = proj.color
        if with_depth:
            color = torch.cat([color, proj.depth[:, None]], dim=-1)

    if mode == "oracle":
        image4, alpha = _oracle_with_channels(proj, color, width=width, height=height)
        n_instances = proj.n_touched.sum()
    else:
        with stage("binning"):
            assignment = build_tile_assignment(
                proj, grid_w=grid_w, grid_h=grid_h, instance_cap=instance_cap,
                need_grad=not inference,
            )
        kw = dict(grid_w=grid_w, grid_h=grid_h, tile_size=tile_size)
        with stage("P2"):
            if inference:
                image4, alpha = blend_forward(
                    assignment.tile_start, assignment.tile_count, assignment.gaussian_idx,
                    proj.mean2d, proj.conic, proj.opacity, color, **kw,
                )
            else:
                image4, alpha = blend_fused(
                    proj.mean2d, proj.conic, proj.opacity, color, assignment, **kw
                )
        n_instances = assignment.n_instances

    with stage("composite"):
        image4 = image4[:height, :width]
        alpha = alpha[:height, :width]
        image, depth = _split_depth(image4, with_depth)
        image = image + (1.0 - alpha[..., None]) * bg_color[None, None, :]
    return RenderOutput(
        image=image, alpha=alpha, depth=depth, n_instances=n_instances,
        visibility=proj.valid, width=width, height=height,
    )


def _split_depth(image: torch.Tensor, with_depth: bool):
    if with_depth:
        return image[..., :3], image[..., 3]
    return image, None


def _oracle_with_channels(proj: ProjectedSplats, color: torch.Tensor, *, width: int, height: int):
    inf = torch.full_like(proj.depth, float("inf"))
    order = torch.argsort(torch.where(proj.valid, proj.depth, inf))
    mean2d = proj.mean2d[order]
    conic = proj.conic[order]
    op = torch.where(proj.valid[order], proj.opacity[order], 0.0)
    col = color[order]
    dev = proj.depth.device
    ys, xs = torch.meshgrid(
        torch.arange(height, device=dev), torch.arange(width, device=dev), indexing="ij"
    )
    px = xs.reshape(-1).to(torch.float32) + 0.5
    py = ys.reshape(-1).to(torch.float32) + 0.5
    alphas = blend_ref.compute_alphas(mean2d, conic, op, px, py)
    color_out, t_final = blend_ref.blend_along_axis(alphas, col)
    ch = color.shape[-1]
    return color_out.reshape(height, width, ch), (1.0 - t_final).reshape(height, width)


def apply_render_mode(out: RenderOutput, render_mode: str) -> torch.Tensor:
    """Final framebuffer per render mode (reference rasterizer.cpp:364-394);
    ED divides by alpha (expected depth)."""
    if render_mode == "RGB":
        return out.image
    if out.depth is None:
        raise ValueError(f"render mode {render_mode} needs a render with_depth=True")
    d = out.depth
    if render_mode.endswith("ED"):
        d = d / torch.clamp(out.alpha, min=1e-10)
    if render_mode in ("D", "ED"):
        return d[..., None]
    return torch.cat([out.image, d[..., None]], dim=-1)
