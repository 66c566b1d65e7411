"""Camera model (counterpart of lichtfeld_studio_tpu/core/camera.py).

`Camera` is host-side numpy; `CameraParams` holds the torch tensors one
render reads, on an explicit device. Convention as in the JAX package and
COLMAP: x_cam = R @ x_world + T, `w2c` is the 4x4 world-to-camera matrix,
camera centre = -R^T @ T. All four camera models and all five shutters are
carried; the EWA projection serves only the global-shutter pinhole, the UT
projection (ops/ut_projection.py) every other camera.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


class CameraModelType:
    """Camera model constants (same values as the JAX package)."""

    PINHOLE = 0
    OPENCV_PINHOLE = 1
    OPENCV_FISHEYE = 2
    ORTHO = 3


class ShutterType:
    """Shutter constants (same values as the JAX package)."""

    ROLLING_TOP_TO_BOTTOM = 0
    ROLLING_LEFT_TO_RIGHT = 1
    ROLLING_BOTTOM_TO_TOP = 2
    ROLLING_RIGHT_TO_LEFT = 3
    GLOBAL = 4


@dataclass
class CameraParams:
    """Per-view camera tensors on one device."""

    w2c: torch.Tensor  # [4, 4] float32
    cam_position: torch.Tensor  # [3] float32
    K: torch.Tensor  # [4] = (fx, fy, cx, cy) float32
    uid: int
    width: int
    height: int
    camera_model: int = CameraModelType.PINHOLE
    radial: torch.Tensor | None = None  # distortion coefficients, [<= 6]
    tangential: torch.Tensor | None = None  # [<= 2]
    # rolling shutter: end-of-frame pose and the scanline direction
    w2c_end: torch.Tensor | None = None  # [4, 4]
    shutter_type: int = ShutterType.GLOBAL

    @property
    def perfect_pinhole(self) -> bool:
        """The camera the EWA projection serves (trainer.cpp:654-659)."""
        return self.camera_model == CameraModelType.PINHOLE and self.shutter_type == ShutterType.GLOBAL

    @property
    def rolling(self) -> bool:
        return self.shutter_type != ShutterType.GLOBAL and self.w2c_end is not None


@dataclass
class Camera:
    """Host-side camera."""

    R: np.ndarray  # [3, 3]
    T: np.ndarray  # [3]
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    uid: int = 0
    camera_model: int = CameraModelType.PINHOLE
    # OpenCV-style distortion (radial k1..k6, tangential p1 p2), empty if none
    radial_distortion: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    tangential_distortion: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))

    @property
    def w2c(self) -> np.ndarray:
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = self.R
        m[:3, 3] = self.T
        return m

    @property
    def cam_position(self) -> np.ndarray:
        return (-self.R.T @ self.T).astype(np.float32)

    def device_params(self, device: str | torch.device = "cpu") -> CameraParams:
        def coeffs(x):
            x = np.asarray(x, np.float32)
            return torch.as_tensor(x, device=device) if x.size else None

        return CameraParams(
            w2c=torch.as_tensor(self.w2c, device=device),
            cam_position=torch.as_tensor(self.cam_position, device=device),
            K=torch.tensor(
                [self.fx, self.fy, self.cx, self.cy], dtype=torch.float32, device=device
            ),
            uid=self.uid,
            width=self.width,
            height=self.height,
            camera_model=self.camera_model,
            radial=coeffs(self.radial_distortion),
            tangential=coeffs(self.tangential_distortion),
        )


def look_at_camera(
    eye: np.ndarray,
    target: np.ndarray,
    up: np.ndarray,
    fx: float,
    fy: float,
    width: int,
    height: int,
    uid: int = 0,
) -> Camera:
    """Camera looking from `eye` toward `target` (+z forward, +x right,
    +y down), built exactly as the JAX package builds it."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.asarray(up, np.float64)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    down /= np.linalg.norm(down)
    R = np.stack([right, down, fwd], axis=0)
    T = -R @ eye
    return Camera(
        R=R.astype(np.float32),
        T=T.astype(np.float32),
        fx=fx,
        fy=fy,
        cx=width / 2.0,
        cy=height / 2.0,
        width=width,
        height=height,
        uid=uid,
    )
