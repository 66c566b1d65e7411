"""Cameras of the GUT parity tests, built with the JAX package: every camera
model and two rolling shutters, at 64x48 (the geometry of scene_utils)."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from lichtfeld_studio_tpu.core.camera import CameraModelType, ShutterType
from tests.scene_utils import make_camera

W, H = 64, 48
CASES = ("pinhole", "opencv", "fisheye", "ortho", "rolling_tb", "rolling_lr")
FISHEYE_RADIAL = np.array([0.08, -0.01, 0.0, 0.0], np.float32)


def rs_params(params, dx=0.2, rot_deg=2.0, shutter=ShutterType.ROLLING_TOP_TO_BOTTOM):
    """A rolling-shutter copy of JAX CameraParams: the end-of-frame pose
    translated by dx and rotated about y by rot_deg."""
    w2c1 = np.asarray(params.w2c).copy()
    w2c1[0, 3] += dx
    a = np.deg2rad(rot_deg)
    ry = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    w2c1[:3, :3] = w2c1[:3, :3] @ ry
    return dataclasses.replace(params, w2c_end=jnp.asarray(w2c1.astype(np.float32)),
                               shutter_type=shutter)


def camera_case(name: str):
    """JAX CameraParams of one named camera of CASES."""
    cam = make_camera(W, H, fov_scale=0.25 if name == "ortho" else 1.0)
    if name == "opencv":
        cam.camera_model = CameraModelType.OPENCV_PINHOLE
        cam.radial_distortion = np.array([0.1, -0.05, 0.01, 0.02, -0.01, 0.005], np.float32)
        cam.tangential_distortion = np.array([0.001, -0.002], np.float32)
    elif name == "fisheye":
        cam.camera_model = CameraModelType.OPENCV_FISHEYE
        cam.radial_distortion = FISHEYE_RADIAL
    elif name == "ortho":
        cam.camera_model = CameraModelType.ORTHO
    params = cam.device_params()
    if name == "rolling_tb":
        params = rs_params(params)
    elif name == "rolling_lr":
        params = rs_params(params, shutter=ShutterType.ROLLING_LEFT_TO_RIGHT)
    return params
