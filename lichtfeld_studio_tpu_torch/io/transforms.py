"""Blender / NeRF-synthetic `transforms*.json` datasets.

Reference: src/loader/formats/transforms.cpp + loaders/blender_loader.cpp.
Semantics preserved: `fl_x` or `camera_angle_x` intrinsics (transforms.cpp:
126-142), OpenGL camera-to-world matrices flipped (y/z negated) and inverted
into w2c, white-background alpha compositing for RGBA PNGs (done in
io.image), and a random point cloud when no SfM points ship with the scene.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from lichtfeld_studio_tpu_torch.core.camera import Camera
from lichtfeld_studio_tpu_torch.core.point_cloud import PointCloud


def is_transforms_dataset(data_path: str | Path) -> bool:
    p = Path(data_path)
    return any(
        (p / n).exists() for n in ("transforms.json", "transforms_train.json")
    )


def _image_size(path: Path) -> tuple[int, int]:
    from PIL import Image

    with Image.open(path) as im:
        return im.width, im.height


def load_transforms(
    data_path: str | Path,
    resize_factor: int = -1,
    max_width: int = 3840,
) -> tuple[list[Camera], PointCloud, np.ndarray]:
    data_path = Path(data_path)
    tf = data_path / "transforms.json"
    if not tf.exists():
        tf = data_path / "transforms_train.json"
    meta = json.loads(tf.read_text())

    frames = meta["frames"]
    cameras: list[Camera] = []
    positions = []
    for uid, fr in enumerate(frames):
        file_path = fr["file_path"]
        img_path = data_path / file_path
        if not img_path.exists():
            for ext in (".png", ".jpg", ".jpeg", ".JPG", ".PNG"):
                if img_path.with_suffix(ext).exists():
                    img_path = img_path.with_suffix(ext)
                    break
        w, h = _image_size(img_path)

        # intrinsics: explicit focal lengths or camera_angle_x (:126-142)
        if "fl_x" in meta or "fl_x" in fr:
            fx = float(fr.get("fl_x", meta.get("fl_x")))
            fy = float(fr.get("fl_y", meta.get("fl_y", fx)))
            cx = float(fr.get("cx", meta.get("cx", w / 2.0)))
            cy = float(fr.get("cy", meta.get("cy", h / 2.0)))
        else:
            angle_x = float(meta["camera_angle_x"])
            fx = 0.5 * w / np.tan(0.5 * angle_x)
            fy = fx
            cx, cy = w / 2.0, h / 2.0

        c2w = np.asarray(fr["transform_matrix"], np.float64)
        # OpenGL -> COLMAP convention: flip y and z axes of the camera frame
        c2w[:3, 1:3] *= -1.0
        w2c = np.linalg.inv(c2w)
        R = w2c[:3, :3].astype(np.float32)
        T = w2c[:3, 3].astype(np.float32)

        cam = Camera(
            R=R, T=T, fx=fx, fy=fy, cx=cx, cy=cy, width=w, height=h,
            image_path=str(img_path), image_name=Path(file_path).name, uid=uid,
        )
        factor = resize_factor if resize_factor > 0 else 1
        if cam.width / factor > max_width:
            factor = cam.width / max_width
        if factor != 1:
            cam = cam.resized(factor)
        cameras.append(cam)
        positions.append(cam.cam_position)

    # Synthetic scenes ship no SfM points: random init inside the camera hull
    # (blender_loader.cpp falls back the same way).
    rng = np.random.default_rng(42)
    n_pts = 100_000
    pos = np.asarray(positions)
    lo, hi = pos.min(axis=0) - 1.0, pos.max(axis=0) + 1.0
    means = rng.uniform(lo * 0.5, hi * 0.5, (n_pts, 3)).astype(np.float32)
    colors = rng.uniform(0, 255, (n_pts, 3)).astype(np.float32)
    pcd = PointCloud(means=means, colors=colors)
    scene_center = pos.mean(axis=0).astype(np.float32)
    return cameras, pcd, scene_center
