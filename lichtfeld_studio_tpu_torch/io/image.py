"""Image output (counterpart of lichtfeld_studio_tpu/io/image.py::save_image)."""

from __future__ import annotations

import numpy as np


def save_image(path: str, img: np.ndarray) -> None:
    """Save float [0,1] HWC (or HW) image as PNG/JPEG/WebP by extension."""
    from PIL import Image

    arr = np.clip(np.asarray(img) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path)
