"""Image IO (counterpart of lichtfeld_studio_tpu/io/image.py; reference
src/core/image_io.cpp: load and resize with alpha-over-white compositing,
here through PIL)."""

from __future__ import annotations

import numpy as np


def load_image(path: str, width: int | None = None, height: int | None = None) -> np.ndarray:
    """Load RGB image as float32 HWC in [0,1], resized to (width, height) if
    given. RGBA inputs are alpha-composited over white (transforms datasets,
    reference transforms.cpp white-bg compositing)."""
    from PIL import Image

    with Image.open(path) as im:
        if width is not None and (im.width, im.height) != (width, height):
            im = im.resize((width, height), Image.LANCZOS)
        arr = np.asarray(im).astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.repeat(arr[:, :, None], 3, axis=2)
    if arr.shape[2] == 4:
        rgb, a = arr[..., :3], arr[..., 3:4]
        arr = rgb * a + (1.0 - a)
    return np.ascontiguousarray(arr[..., :3])


def save_image(path: str, img: np.ndarray) -> None:
    """Save float [0,1] HWC (or HW) image as PNG/JPEG/WebP by extension."""
    from PIL import Image

    arr = np.clip(np.asarray(img) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def side_by_side(gt: np.ndarray, pred: np.ndarray) -> np.ndarray:
    """Eval comparison image (reference image_io.cpp side-by-side dumps)."""
    return np.concatenate([gt, pred], axis=1)


def colormap_turbo(x: np.ndarray) -> np.ndarray:
    """Depth colormap (reference uses a turbo-style colormap for depth dumps)."""
    import matplotlib.cm as cm

    x = np.asarray(x, np.float32)
    lo, hi = np.nanmin(x), np.nanmax(x)
    norm = (x - lo) / max(hi - lo, 1e-9)
    return cm.turbo(norm)[..., :3].astype(np.float32)
