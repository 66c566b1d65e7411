"""COLMAP dataset parsing (binary + text).

Reference: src/loader/formats/colmap.cpp (959 LoC). Parses cameras/images/
points3D in both .bin and .txt forms, supports the 11 COLMAP camera models
(colmap.hpp:13-26), converts qvec/tvec to world-to-camera extrinsics and
distortion coefficients to radial/tangential vectors, and computes the scene
center as the mean camera position (used for scene_scale).

Pure host-side numpy; runs once at startup so there is nothing to accelerate.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from lichtfeld_studio_tpu_torch.core.camera import Camera, CameraModelType
from lichtfeld_studio_tpu_torch.core.point_cloud import PointCloud

# COLMAP camera model ids -> (name, num_params) (colmap.hpp:13-26)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
_NAME_TO_ID = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclass
class ColmapCamera:
    model: str
    width: int
    height: int
    params: np.ndarray


def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    """COLMAP qvec (w, x, y, z) -> rotation matrix (colmap.cpp:28-50)."""
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


# ----------------------------------------------------------------------
# Binary readers
# ----------------------------------------------------------------------
def _read_cameras_bin(path: Path) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            cid, model_id, w, h = struct.unpack("<iiQQ", f.read(24))
            name, np_count = CAMERA_MODELS[model_id]
            params = np.array(struct.unpack(f"<{np_count}d", f.read(8 * np_count)))
            cams[cid] = ColmapCamera(name, int(w), int(h), params)
    return cams


def _read_images_bin(path: Path) -> list[dict]:
    images = []
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            iid = struct.unpack("<I", f.read(4))[0]
            qvec = np.array(struct.unpack("<4d", f.read(32)))
            tvec = np.array(struct.unpack("<3d", f.read(24)))
            cam_id = struct.unpack("<I", f.read(4))[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n2d,) = struct.unpack("<Q", f.read(8))
            f.seek(24 * n2d, os.SEEK_CUR)  # skip 2D points
            images.append(
                dict(id=iid, qvec=qvec, tvec=tvec, camera_id=cam_id, name=name.decode())
            )
    return images


def _read_points3d_bin(path: Path) -> PointCloud:
    with open(path, "rb") as f:
        data = f.read()
    # native fast path (millions of variable-length records)
    from lichtfeld_studio_tpu_torch.io import native

    parsed = native.parse_points3d_bin(data)
    if parsed is not None:
        return PointCloud(means=parsed[0], colors=parsed[1])

    (n,) = struct.unpack_from("<Q", data, 0)
    means = np.empty((n, 3), np.float32)
    colors = np.empty((n, 3), np.float32)
    off = 8
    for i in range(n):
        # id(8) xyz(24) rgb(3) error(8) track_len(8) + track
        xyz = struct.unpack_from("<3d", data, off + 8)
        rgb = struct.unpack_from("<3B", data, off + 32)
        (track_len,) = struct.unpack_from("<Q", data, off + 43)
        means[i] = xyz
        colors[i] = rgb
        off += 51 + 8 * track_len
    return PointCloud(means=means, colors=colors)


# ----------------------------------------------------------------------
# Text readers
# ----------------------------------------------------------------------
def _read_cameras_txt(path: Path) -> dict[int, ColmapCamera]:
    cams = {}
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        cid = int(parts[0])
        cams[cid] = ColmapCamera(
            parts[1], int(parts[2]), int(parts[3]), np.array([float(p) for p in parts[4:]])
        )
    return cams


def _read_images_txt(path: Path) -> list[dict]:
    images = []
    lines = [
        l.strip() for l in open(path) if l.strip() and not l.strip().startswith("#")
    ]
    for i in range(0, len(lines), 2):  # every other line is the 2D point list
        parts = lines[i].split()
        images.append(
            dict(
                id=int(parts[0]),
                qvec=np.array([float(p) for p in parts[1:5]]),
                tvec=np.array([float(p) for p in parts[5:8]]),
                camera_id=int(parts[8]),
                name=parts[9],
            )
        )
    return images


def _read_points3d_txt(path: Path) -> PointCloud:
    means, colors = [], []
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        means.append([float(p) for p in parts[1:4]])
        colors.append([float(p) for p in parts[4:7]])
    return PointCloud(
        means=np.asarray(means, np.float32), colors=np.asarray(colors, np.float32)
    )


# ----------------------------------------------------------------------
# Camera assembly (intrinsics + distortion per model, colmap.cpp)
# ----------------------------------------------------------------------
def _intrinsics_and_distortion(cam: ColmapCamera):
    p = cam.params
    model = cam.model
    radial = np.zeros(0, np.float32)
    tangential = np.zeros(0, np.float32)
    cam_type = CameraModelType.PINHOLE
    if model == "SIMPLE_PINHOLE":
        fx = fy = p[0]; cx, cy = p[1], p[2]
    elif model == "PINHOLE":
        fx, fy, cx, cy = p[0], p[1], p[2], p[3]
    elif model == "SIMPLE_RADIAL":
        fx = fy = p[0]; cx, cy = p[1], p[2]
        radial = np.array([p[3]], np.float32)
        cam_type = CameraModelType.OPENCV_PINHOLE
    elif model == "RADIAL":
        fx = fy = p[0]; cx, cy = p[1], p[2]
        radial = np.array([p[3], p[4]], np.float32)
        cam_type = CameraModelType.OPENCV_PINHOLE
    elif model == "OPENCV":
        fx, fy, cx, cy = p[0], p[1], p[2], p[3]
        radial = np.array([p[4], p[5]], np.float32)
        tangential = np.array([p[6], p[7]], np.float32)
        cam_type = CameraModelType.OPENCV_PINHOLE
    elif model == "OPENCV_FISHEYE":
        fx, fy, cx, cy = p[0], p[1], p[2], p[3]
        radial = np.array([p[4], p[5], p[6], p[7]], np.float32)
        cam_type = CameraModelType.OPENCV_FISHEYE
    elif model == "FULL_OPENCV":
        fx, fy, cx, cy = p[0], p[1], p[2], p[3]
        radial = np.array([p[4], p[5], p[8], p[9], p[10], p[11]], np.float32)
        tangential = np.array([p[6], p[7]], np.float32)
        cam_type = CameraModelType.OPENCV_PINHOLE
    else:
        raise ValueError(f"unsupported COLMAP camera model: {model}")
    if not radial.any() and not tangential.any():
        # distortion-free OpenCV models degrade to the fast pinhole path
        cam_type = CameraModelType.PINHOLE
        radial = np.zeros(0, np.float32)
        tangential = np.zeros(0, np.float32)
    return float(fx), float(fy), float(cx), float(cy), radial, tangential, cam_type


def find_sparse_dir(data_path: Path) -> Path:
    for cand in ("sparse/0", "sparse", "colmap/sparse/0", "colmap/sparse"):
        d = data_path / cand
        if (d / "cameras.bin").exists() or (d / "cameras.txt").exists():
            return d
    raise FileNotFoundError(f"no COLMAP sparse reconstruction under {data_path}")


def is_colmap_dataset(data_path: Path) -> bool:
    try:
        find_sparse_dir(Path(data_path))
        return True
    except FileNotFoundError:
        return False


def load_colmap(
    data_path: str | Path,
    images_dir: str = "images",
    resize_factor: int = -1,
    max_width: int = 3840,
) -> tuple[list[Camera], PointCloud, np.ndarray]:
    """Returns (cameras, point_cloud, scene_center).

    scene_center = mean camera position (reference colmap.cpp scene center).
    resize_factor/max_width semantics mirror DatasetConfig: factor -1 means
    auto (only clamp to max_width)."""
    data_path = Path(data_path)
    sparse = find_sparse_dir(data_path)

    if (sparse / "cameras.bin").exists():
        cams = _read_cameras_bin(sparse / "cameras.bin")
        images = _read_images_bin(sparse / "images.bin")
    else:
        cams = _read_cameras_txt(sparse / "cameras.txt")
        images = _read_images_txt(sparse / "images.txt")

    if (sparse / "points3D.bin").exists():
        pcd = _read_points3d_bin(sparse / "points3D.bin")
    elif (sparse / "points3D.txt").exists():
        pcd = _read_points3d_txt(sparse / "points3D.txt")
    else:
        pcd = PointCloud(means=np.zeros((0, 3), np.float32), colors=np.zeros((0, 3), np.float32))

    img_root = data_path / images_dir

    cameras: list[Camera] = []
    positions = []
    for uid, im in enumerate(sorted(images, key=lambda d: d["name"])):
        cc = cams[im["camera_id"]]
        fx, fy, cx, cy, radial, tangential, cam_type = _intrinsics_and_distortion(cc)
        R = qvec_to_rotmat(im["qvec"]).astype(np.float32)
        T = np.asarray(im["tvec"], np.float32)
        cam = Camera(
            R=R,
            T=T,
            fx=fx,
            fy=fy,
            cx=cx,
            cy=cy,
            width=cc.width,
            height=cc.height,
            image_path=str(img_root / im["name"]),
            image_name=im["name"],
            uid=uid,
            camera_model=cam_type,
            radial_distortion=radial,
            tangential_distortion=tangential,
        )
        factor = resize_factor if resize_factor > 0 else 1
        if cam.width / factor > max_width:
            factor = cam.width / max_width
        if factor != 1:
            cam = cam.resized(factor)
        cameras.append(cam)
        positions.append(cam.cam_position)

    scene_center = np.mean(np.asarray(positions), axis=0).astype(np.float32)
    return cameras, pcd, scene_center
