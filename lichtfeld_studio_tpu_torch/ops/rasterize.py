"""Differentiable 3DGS rasterization (counterpart of
lichtfeld_studio_tpu/ops/rasterize.py).

projection -> tile binning -> blend -> background composite. Projections:
"ewa" (the fastgs frustum-clamped EWA path, pinhole only), "ut" (the 3DGUT
unscented transform, every camera model and shutter), "auto" (UT for any
camera that is not a global-shutter pinhole, trainer.cpp:654-659). Modes:
  * "oracle": a dense blend, differentiable by plain autograd: per pixel
              over all gaussians for the 2D blend, per tile over the binned
              instances (ops/world_blend.py::world_blend_tiles) for the
              exact world-space blend;
  * "cuda":   the binned path, the counterpart of the JAX package's
              "pallas" mode: kernel P1 (expand) in the binning, then the 2D
              blend (P2 for inference, `blend_fused` = P2 + P3/P4 for
              training) or, with `gut_exact`, the world-space blend (P5 for
              inference, `world_blend_fused` = P5 + P6/P4 for training).
              An ORTHO camera (per-pixel ray origins) and a pose gradient
              (`cam_grad`: d loss / d rays, which P6 does not return) take
              the dense `world_blend_tiles` on the exact path, as the JAX
              package's do (rasterize.py:229-235).

Each stage runs inside a profiler range (profiling.stage: projection,
binning, P2 or rays, stream and P5, composite), which a trace reads as
per-stage device time.

Render modes RGB / D / ED / RGB_D / RGB_ED composite depth as an extra
blend channel (accumulated depth = sum_i w_i depth_i; expected depth = that
/ alpha).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from lichtfeld_studio_tpu_torch.core.camera import CameraModelType, CameraParams
from lichtfeld_studio_tpu_torch.core.splat_data import SplatData
from lichtfeld_studio_tpu_torch.kernels.blend import blend_forward, blend_fused
from lichtfeld_studio_tpu_torch.kernels.world_blend import (
    pack_world_stream,
    pack_world_stream_rs,
    world_blend_forward,
    world_blend_fused,
)
from lichtfeld_studio_tpu_torch.ops import blend_ref
from lichtfeld_studio_tpu_torch.ops.projection import ProjectedSplats, project_gaussians
from lichtfeld_studio_tpu_torch.ops.tiles import build_tile_assignment
from lichtfeld_studio_tpu_torch.ops.ut_projection import project_gaussians_ut
from lichtfeld_studio_tpu_torch.ops.world_blend import (
    pack_world_features,
    pixel_shutter_times,
    world_blend_tiles,
    world_ray_table,
)
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
    # [C, 2] projected means, in the autograd graph of a training render:
    # d loss / d mean2d feeds the ADC densification statistics
    mean2d: torch.Tensor | None = None
    width: int = 0
    height: int = 0


def _resolve_projection(projection: str, camera: CameraParams) -> str:
    if projection == "auto":
        return "ewa" if camera.perfect_pinhole else "ut"
    if projection not in ("ewa", "ut"):
        raise ValueError(f"projection must be 'auto', 'ewa' or 'ut', got {projection!r}")
    return projection


def _project(splats: SplatData, camera: CameraParams, *, tile_size: int,
             projection: str = "ewa", exact_tile_test: bool = True,
             antialiasing: bool = False, dilate_px: float = 0.0,
             feature_only: bool = False) -> ProjectedSplats:
    """The view's projection. `dilate_px` and `feature_only` (EWA only):
    the frame-coherent renderer's dilated bin pass and its frame pass
    (ops/projection.py::screen_bounds)."""
    args = (splats.means, splats.scaling, splats.rotation, splats.opacity, splats.sh0, splats.shN,
            splats.active_mask(), splats.active_sh_degree, camera.w2c, camera.cam_position,
            camera.K)
    if projection == "ut":
        if dilate_px or feature_only:
            raise ValueError("dilate_px and feature_only are EWA (pinhole) options")
        return project_gaussians_ut(
            *args, width=camera.width, height=camera.height, tile_size=tile_size,
            camera_model=camera.camera_model, radial=camera.radial, tangential=camera.tangential,
            w2c_end=camera.w2c_end, shutter_type=camera.shutter_type,
            exact_tile_test=exact_tile_test, antialiasing=antialiasing)
    return project_gaussians(
        *args, width=camera.width, height=camera.height, tile_size=tile_size,
        antialiasing=antialiasing, dilate_px=dilate_px,
        # coarser tiles -> tiny bboxes: a 16-cell exact test at 32-px tiles
        exact_tile_cap=0 if feature_only else (32 if tile_size < 32 else 16),
    )


def count_instances(splats: SplatData, camera: CameraParams, *, tile_size: int = 32,
                    projection: str = "auto", dilate_px: float = 0.0) -> torch.Tensor:
    """Scalar: total tile instances this view would bin (projection only,
    no sort, no blend) — the headless renderer's probe for a snug cap;
    with `dilate_px` (EWA), the coherent renderer's dilated bin pass's."""
    return _project(splats, camera, tile_size=tile_size, dilate_px=dilate_px,
                    projection=_resolve_projection(projection, camera)).n_touched.sum()


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
    antialiasing: bool = False,
    cam_grad: bool = False,
) -> RenderOutput:
    """`inference=True` selects the forward-only binning layout (fused sort
    key, no gradient); do not differentiate through an inference render.
    `tile_size=None` picks 32 px for inference renders, 16 otherwise.
    `gut_exact` (UT projection only) blends every pixel's world ray against
    the 3D gaussians exactly (the reference's 3DGUT rasterizer) instead of
    the 2D conics. `cam_grad` (pose optimisation) makes the exact path
    differentiable with respect to the camera's pose through its ray
    table: it takes the dense blend."""
    if tile_size is None:
        tile_size = 32 if (inference and mode == "cuda") else 16
    if mode not in ("oracle", "cuda"):
        raise ValueError(f"unknown rasterize mode: {mode}")
    projection = _resolve_projection(projection, camera)
    exact = gut_exact and projection == "ut"
    width, height = camera.width, camera.height
    grid_w = -(-width // tile_size)
    grid_h = -(-height // tile_size)
    kw = dict(grid_w=grid_w, grid_h=grid_h, tile_size=tile_size)

    with stage("projection"):
        proj = _project(splats, camera, tile_size=tile_size, projection=projection,
                        exact_tile_test=not exact, antialiasing=antialiasing)
        color = proj.color
        if with_depth:
            color = torch.cat([color, proj.depth[:, None]], dim=-1)

    if mode == "oracle" and not exact:
        image4, alpha = _oracle_with_channels(proj, color, width=width, height=height)
        n_instances = proj.n_touched.sum()
    else:
        with stage("binning"):
            assignment = build_tile_assignment(
                proj, grid_w=grid_w, grid_h=grid_h, instance_cap=instance_cap,
                need_grad=not inference,
            )
        if exact:
            dense = mode == "oracle" or cam_grad or camera.camera_model == CameraModelType.ORTHO
            image4, alpha = _world_blend(splats, camera, proj, assignment, dense=dense,
                                         cam_grad=cam_grad, with_depth=with_depth,
                                         inference=inference, **kw)
        else:
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
        visibility=proj.valid, width=width, height=height, mean2d=proj.mean2d,
    )


def _rays(camera: CameraParams, tile_size: int, grad: bool = False):
    """The camera's per-pixel world rays (ray_o, ray_d [Hp*Wp, 3]) and, for
    a rolling shutter, each pixel's shutter time tau [Hp*Wp]; in the
    autograd graph only with `grad`."""
    with stage("rays"), torch.set_grad_enabled(grad and torch.is_grad_enabled()):
        rays_o, rays_d = world_ray_table(
            camera.w2c, camera.K, camera.camera_model, camera.radial, camera.tangential,
            camera.width, camera.height, tile_size, w2c_end=camera.w2c_end,
            shutter_type=camera.shutter_type)
        tau = (pixel_shutter_times(camera.shutter_type, camera.width, camera.height, tile_size,
                                   rays_d.device) if camera.rolling else None)
    return rays_o, rays_d, tau


def _world_blend(splats, camera, proj, assignment, *, dense, cam_grad, with_depth, inference,
                 grid_w, grid_h, tile_size):
    """The exact world-space blend over the binned instances (JAX
    rasterize.py:205-307): the per-pixel ray table, then the stream and P5
    (P5 + P6/P4 for training), or the dense `world_blend_tiles`."""
    kw = dict(grid_w=grid_w, grid_h=grid_h, tile_size=tile_size)
    n_ch = 4 if with_depth else 3
    depth = proj.depth if with_depth else None
    rays_o, rays_d, tau = _rays(camera, tile_size, grad=cam_grad)
    if dense:
        with stage("stream"):
            featw = pack_world_features(splats.means, splats.scaling, splats.rotation,
                                        proj.opacity, proj.color, depth)
        with stage("blend"):
            return world_blend_tiles(featw, rays_o, rays_d, assignment, n_channels=n_ch, **kw)
    with stage("stream"):
        if camera.rolling:
            r0, t0 = camera.w2c[:3, :3], camera.w2c[:3, 3]
            r1, t1 = camera.w2c_end[:3, :3], camera.w2c_end[:3, 3]
            stream = pack_world_stream_rs(splats.means, splats.scaling, splats.rotation,
                                          proj.opacity, proj.color, -(r0.T @ t0), -(r1.T @ t1),
                                          depth)
        else:
            stream = pack_world_stream(splats.means, splats.scaling, splats.rotation,
                                       proj.opacity, proj.color, camera.cam_position, depth)
    with stage("P5"):
        if inference:
            return world_blend_forward(stream, rays_d, tau, assignment.tile_start,
                                       assignment.tile_count, assignment.gaussian_idx,
                                       n_channels=n_ch, **kw)[:2]
        return world_blend_fused(stream, rays_d, tau, assignment, n_channels=n_ch, **kw)


def capture_world_inputs(splats, params, *, tile_size, instance_cap, with_depth=False,
                         inference=False):
    """The arguments that rasterize(projection="ut", gut_exact=True) hands
    its world blend, captured in place of the blend, so that a check reads
    what the path reads (for the tests, tools/ab_kernels.py and
    chip_smoke.py): (stream, rays_d, tau, assignment, kw) for the training
    path (world_blend_fused), (stream, rays_d, tau, tile_start, tile_count,
    gaussian_idx, kw) for the forward frame's (world_blend_forward); kw
    holds n_channels and the tile grid."""
    name = "world_blend_forward" if inference else "world_blend_fused"
    seen = []

    def capture(*args, **kw):
        seen.append((*args, kw))
        hp, wp = kw["grid_h"] * kw["tile_size"], kw["grid_w"] * kw["tile_size"]
        z = torch.zeros((hp, wp), device=args[0].device)
        out = (torch.zeros((hp, wp, kw["n_channels"]), device=z.device), z, z, z.int())
        return out if inference else out[:2]

    real = globals()[name]
    globals()[name] = capture
    try:
        with torch.no_grad():
            rasterize(splats, params, torch.zeros(3, device=params.w2c.device), mode="cuda",
                      tile_size=tile_size, instance_cap=instance_cap, with_depth=with_depth,
                      projection="ut", gut_exact=True, inference=inference)
    finally:
        globals()[name] = real
    return seen[0]


def _split_depth(image: torch.Tensor, with_depth: bool):
    if with_depth:
        return image[..., :3], image[..., 3]
    return image, None


# the dense oracle holds [gaussians, pixels] arrays: above this many
# elements it walks the pixels in chunks
_ORACLE_CHUNK_ELEMS = 1 << 26


def _oracle_with_channels(proj: ProjectedSplats, color: torch.Tensor, *, width: int, height: int):
    inf = torch.full_like(proj.depth, float("inf"))
    order = torch.argsort(torch.where(proj.valid, proj.depth, inf))
    n = order.shape[0]
    if n * width * height > 2 * _ORACLE_CHUNK_ELEMS:
        # culled gaussians sort last and blend with alpha 0: leaving them
        # out changes no value
        n = int(proj.valid.sum())
        order = order[:n]
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
    step = max(1, _ORACLE_CHUNK_ELEMS // max(n, 1))
    parts = [blend_ref.blend_along_axis(
        blend_ref.compute_alphas(mean2d, conic, op, px[i:i + step], py[i:i + step]), col)
        for i in range(0, px.shape[0], step)]
    color_out = torch.cat([c for c, _ in parts]) if len(parts) > 1 else parts[0][0]
    t_final = torch.cat([t for _, t in parts]) if len(parts) > 1 else parts[0][1]
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
