"""Headless rendering (counterpart of lichtfeld_studio_tpu/render/headless.py).

projection -> binning (kernel P1) -> blend (kernel P2) -> u8 quantisation
on the device -> PNG. The instance cap is probe-snug: a projection-only
pass counts the view's instances and the cap is the next bucket above it.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from lichtfeld_studio_tpu_torch.core.camera import Camera, look_at_camera
from lichtfeld_studio_tpu_torch.core.splat_data import SplatData
from lichtfeld_studio_tpu_torch.io.image import save_image
from lichtfeld_studio_tpu_torch.io.ply import read_ply
from lichtfeld_studio_tpu_torch.ops.rasterize import count_instances, rasterize

# Snug instance-cap buckets: every binning/sort/blend stage scales with the
# cap, so a sparse view rendered at the worst-case cap wastes cap/count of
# that work; x1.5 steps bound the waste at 50%.
_CAP_BUCKETS = [
    1 << 17, 196_608, 1 << 18, 393_216, 1 << 19, 786_432, 1 << 20,
    1_572_864, 1 << 21, 3_145_728, 1 << 22,
]


def _bucket_cap(count: int, margin: float = 1.1) -> int:
    need = int(count * margin) + 1
    for b in _CAP_BUCKETS:
        if b >= need:
            return b
    return _CAP_BUCKETS[-1]


def default_device() -> torch.device:
    """The device the CLI renders on: the first GPU. Raises RuntimeError
    where there is none; it never falls back to the CPU (a caller that
    wants the CPU's plain versions passes device="cpu" itself)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no NVIDIA GPU found (torch.cuda.is_available() is false): the port "
                           "renders on the GPU")
    return torch.device("cuda")


@torch.no_grad()
def render_view(
    splats: SplatData,
    camera: Camera,
    bg_color=(0.0, 0.0, 0.0),
    mode: str = "cuda",
    instance_cap: int | None = None,
) -> np.ndarray:
    """[H, W, 3] float32 image in [0, 1], u8-quantised. instance_cap=None
    probes the view's instance count and picks a snug bucket. Raises when
    the view's instances overflow the cap (the frame would be lossy)."""
    device = splats.means.device
    params = camera.device_params(device)
    if instance_cap is None:
        n = int(count_instances(splats, params, tile_size=32 if mode == "cuda" else 16))
        instance_cap = _bucket_cap(n)
    bg = torch.tensor(bg_color, dtype=torch.float32, device=device)
    img_u8, n_instances = render_frame_u8(splats, params, bg, mode, instance_cap)
    _check_overflow(int(n_instances), instance_cap)
    return img_u8.cpu().numpy().astype(np.float32) / 255.0


def render_frame_u8(splats: SplatData, params, bg: torch.Tensor, mode: str, instance_cap: int):
    """One frame on the device: rasterize, then quantise to u8 there (the
    consumer is an 8-bit image). Returns ([H, W, 3] uint8, n_instances)."""
    out = rasterize(splats, params, bg, mode=mode, instance_cap=instance_cap, inference=True)
    return torch.clamp(out.image * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8), out.n_instances


def _check_overflow(n_instances: int, instance_cap: int) -> None:
    if n_instances > instance_cap:
        raise RuntimeError(
            f"instance cap overflow: {n_instances} instances > cap {instance_cap}"
        )


def snug_cap(splats: SplatData, cameras: list[Camera]) -> tuple[int, int]:
    """(peak, cap) for a fixed camera set: the peak instance count over the
    cameras (projection-only probe, 32-px tiles) and a cap 4% above it,
    rounded up to 128, as tools/bench_render.py sizes its orbit."""
    device = splats.means.device
    peak = max(
        int(count_instances(splats, c.device_params(device), tile_size=32)) for c in cameras
    )
    return peak, -(-int(peak * 1.04) // 128) * 128


def splats_from_ply(
    path: str | Path, capacity: int | None = None, device: str | torch.device = "cpu"
) -> SplatData:
    """Load a splat from .ply or .sog (reference loader facade detection,
    src/loader/loader.cpp:19-80)."""
    from lichtfeld_studio_tpu_torch.io.sog import is_sog, read_sog

    pc = read_sog(path) if is_sog(path) else read_ply(path)
    if pc.sh0 is None:
        raise ValueError(f"{path}: not a 3DGS splat PLY (no f_dc_* properties)")
    return SplatData.from_arrays(
        pc.means, pc.sh0, pc.shN, pc.scaling, pc.rotation, pc.opacity,
        capacity=capacity, device=device,
    )


def concat_splats(models: list[SplatData]) -> SplatData:
    """Concatenate several splat models into one composite scene (the
    headless analogue of the reference SceneManager's multi-PLY scene graph,
    src/visualizer/scene/scene_manager.cpp): SH padded with zeros to the
    widest model, the largest scene_scale, on the first model's device."""
    if not models:
        raise ValueError("concat_splats needs at least one model")
    if len(models) == 1:
        return models[0]
    pcs = [m.to_point_cloud() for m in models]
    max_k = max(pc.shN.shape[1] for pc in pcs)

    def pad_sh(x):
        out = np.zeros((x.shape[0], max_k, 3), np.float32)
        out[:, : x.shape[1]] = x
        return out

    return SplatData.from_arrays(
        np.concatenate([pc.means for pc in pcs]),
        np.concatenate([pc.sh0 for pc in pcs]),
        np.concatenate([pad_sh(pc.shN) for pc in pcs]),
        np.concatenate([pc.scaling for pc in pcs]),
        np.concatenate([pc.rotation for pc in pcs]),
        np.concatenate([pc.opacity for pc in pcs]),
        scene_scale=max(float(m.scene_scale) for m in models),
        device=models[0].means.device,
    )


def _orbit_cameras(splats: SplatData, n: int, width: int, height: int) -> list[Camera]:
    with torch.no_grad():
        center = splats.means[: int(splats.n_active)].mean(0).cpu().numpy()
    radius = 2.5 * splats.scene_scale
    cams = []
    for k in range(n):
        theta = 2.0 * np.pi * k / max(n, 1)
        eye = center + radius * np.array([np.sin(theta), -0.2, np.cos(theta)])
        cams.append(look_at_camera(
            eye, center, np.array([0.0, -1.0, 0.0]),
            fx=0.8 * width, fy=0.8 * width, width=width, height=height,
        ))
    return cams


def render_ply_orbit(
    splats_or_path: SplatData | str | Path,
    output: str = "render.png",
    n_frames: int = 1,
    width: int = 1920,
    height: int = 1080,
) -> None:
    """Render one or more orbit views of a splat model (or .ply/.sog path)."""
    splats = (
        splats_or_path
        if isinstance(splats_or_path, SplatData)
        else splats_from_ply(splats_or_path, device=default_device())
    )
    out_path = Path(output)
    t0 = time.time()
    for k, cam in enumerate(_orbit_cameras(splats, n_frames, width, height)):
        img = render_view(splats, cam)
        path = out_path if n_frames == 1 else out_path.with_stem(f"{out_path.stem}_{k:04d}")
        save_image(str(path), img)
    dt = time.time() - t0
    print(f"rendered {n_frames} frame(s) on {splats.means.device} in {dt:.2f}s "
          f"({n_frames / dt:.1f} FPS incl IO)")


@torch.no_grad()
def benchmark_fps(
    splats: SplatData,
    width: int = 1920,
    height: int = 1080,
    n_frames: int = 30,
    instance_cap: int | None = None,
    cameras: list[Camera] | None = None,
) -> float:
    """Render throughput, frames per second of the device path (u8 frames
    stay on the device), cycling over `cameras` (default: 8 orbit cameras
    at width x height). instance_cap=None takes the probe-snug cap of
    `snug_cap` over those cameras. Raises when a frame overflows the cap."""
    device = splats.means.device
    cameras = cameras or _orbit_cameras(splats, 8, width, height)
    if instance_cap is None:
        _, instance_cap = snug_cap(splats, cameras)
    bg = torch.zeros(3, device=device)
    params = [c.device_params(device) for c in cameras]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    render_frame_u8(splats, params[0], bg, "cuda", instance_cap)  # warm-up: builds the kernels
    sync()
    counts = []
    t0 = time.perf_counter()
    for k in range(n_frames):
        counts.append(render_frame_u8(splats, params[k % len(params)], bg, "cuda", instance_cap)[1])
    sync()
    fps = n_frames / (time.perf_counter() - t0)
    _check_overflow(int(torch.stack(counts).max()), instance_cap)
    return fps
