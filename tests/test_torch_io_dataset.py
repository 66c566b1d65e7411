"""Port parity for the host loaders of lichtfeld_studio_tpu_torch.io against
the JAX package's: a transforms.json scene and a small COLMAP scene (binary
and text) written by the test give equal cameras, point cloud and scene
centre; the split rule; load_image; the native library's entry points; the
prefetch loader's order for one worker and one seed."""

import json
import struct

import numpy as np
import pytest
from PIL import Image

from lichtfeld_studio_tpu.io import dataset as j_dataset
from lichtfeld_studio_tpu.io import image as j_image
from lichtfeld_studio_tpu_torch.core.camera import CameraModelType, look_at_camera
from lichtfeld_studio_tpu_torch.io import colmap as t_colmap
from lichtfeld_studio_tpu_torch.io import dataset as t_dataset
from lichtfeld_studio_tpu_torch.io import image as t_image
from lichtfeld_studio_tpu_torch.io import native as t_native
from tests.test_native import _synthetic_points3d_bin
from tests.torch_parity import to_torch_camera

W, H = 40, 24


def _poses(n):
    cams = []
    for i in range(n):
        theta = 2 * np.pi * i / n
        eye = 4.0 * np.array([np.sin(theta), -0.1 * i, -np.cos(theta)])
        cams.append(look_at_camera(eye, np.zeros(3), np.array([0.0, -1.0, 0.0]), 50.0, 50.0, W, H,
                                   uid=i))
    return cams


def _write_images(rng, root, names, rgba=False):
    root.mkdir(parents=True, exist_ok=True)
    for name in names:
        arr = rng.integers(0, 256, (H, W, 4 if rgba else 3)).astype(np.uint8)
        Image.fromarray(arr).save(root / name)


def _transforms_scene(rng, root, n=7):
    names = [f"r_{i}.png" for i in range(n)]
    _write_images(rng, root / "images", names, rgba=True)
    frames = []
    for cam, name in zip(_poses(n), names):
        c2w = np.linalg.inv(cam.w2c.astype(np.float64))
        c2w[:3, 1:3] *= -1.0
        frames.append({"file_path": f"images/{name}", "transform_matrix": c2w.tolist()})
    (root / "transforms.json").write_text(json.dumps(
        {"camera_angle_x": 2.0 * np.arctan(W / (2 * 50.0)), "frames": frames}))


def _rotmat_to_qvec(R):
    w = np.sqrt(max(0.0, 1 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    x = np.sqrt(max(0.0, 1 + R[0, 0] - R[1, 1] - R[2, 2])) / 2
    y = np.sqrt(max(0.0, 1 - R[0, 0] + R[1, 1] - R[2, 2])) / 2
    z = np.sqrt(max(0.0, 1 - R[0, 0] - R[1, 1] + R[2, 2])) / 2
    return np.array([w, np.copysign(x, R[2, 1] - R[1, 2]), np.copysign(y, R[0, 2] - R[2, 0]),
                     np.copysign(z, R[1, 0] - R[0, 1])])


# COLMAP cameras of the scene: id -> (model id, name, params)
_COLMAP_CAMERAS = {
    1: (1, "PINHOLE", [50.0, 51.0, 20.0, 12.0]),
    2: (4, "OPENCV", [50.0, 50.0, 20.0, 12.0, 0.01, -0.002, 0.001, 0.0005]),
    3: (5, "OPENCV_FISHEYE", [30.0, 30.0, 20.0, 12.0, 0.08, -0.01, 0.0, 0.0]),
    4: (2, "SIMPLE_RADIAL", [48.0, 20.0, 12.0, 0.0]),  # no distortion: a pinhole
}


def _colmap_scene(rng, root, binary, n=6):
    names = [f"im_{i:02d}.png" for i in range(n)]
    _write_images(rng, root / "images", names)
    sparse = root / "sparse" / "0"
    sparse.mkdir(parents=True)
    poses = _poses(n)
    cam_ids = [1 + i % 4 for i in range(n)]
    points_bin, _, _ = _synthetic_points3d_bin(rng, n=50)
    if binary:
        out = bytearray(struct.pack("<Q", len(_COLMAP_CAMERAS)))
        for cid, (mid, _, params) in _COLMAP_CAMERAS.items():
            out += struct.pack("<iiQQ", cid, mid, W, H) + struct.pack(f"<{len(params)}d", *params)
        (sparse / "cameras.bin").write_bytes(bytes(out))
        out = bytearray(struct.pack("<Q", n))
        for i in reversed(range(n)):  # unsorted on disk: the loader sorts by name
            out += struct.pack("<I", i + 1) + struct.pack("<4d", *_rotmat_to_qvec(poses[i].R))
            out += struct.pack("<3d", *poses[i].T) + struct.pack("<I", cam_ids[i])
            out += names[i].encode() + b"\x00" + struct.pack("<Q", 2) + b"\x00" * 48
        (sparse / "images.bin").write_bytes(bytes(out))
        (sparse / "points3D.bin").write_bytes(points_bin)
    else:
        lines = ["# cameras"] + [f"{cid} {name} {W} {H} " + " ".join(map(repr, params))
                                 for cid, (_, name, params) in _COLMAP_CAMERAS.items()]
        (sparse / "cameras.txt").write_text("\n".join(lines) + "\n")
        lines = ["# images"]
        for i in range(n):
            q, t = _rotmat_to_qvec(poses[i].R), poses[i].T
            lines += [f"{i + 1} " + " ".join(repr(float(v)) for v in (*q, *t))
                      + f" {cam_ids[i]} {names[i]}", "1.0 2.0 -1"]
        (sparse / "images.txt").write_text("\n".join(lines) + "\n")
        pts = rng.normal(0, 2, (30, 3))
        (sparse / "points3D.txt").write_text("# points\n" + "\n".join(
            f"{i} {float(p[0])!r} {float(p[1])!r} {float(p[2])!r} {i % 256} {(2 * i) % 256} 7 0.5 1 2"
            for i, p in enumerate(pts)) + "\n")


def _assert_cameras_equal(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.R, b.R)
        np.testing.assert_array_equal(a.T, b.T)
        assert (a.fx, a.fy, a.cx, a.cy, a.width, a.height) == (b.fx, b.fy, b.cx, b.cy, b.width,
                                                              b.height)
        assert (a.image_path, a.image_name, a.uid, a.camera_model) == (
            b.image_path, b.image_name, b.uid, b.camera_model)
        np.testing.assert_array_equal(a.radial_distortion, b.radial_distortion)
        np.testing.assert_array_equal(a.tangential_distortion, b.tangential_distortion)
        assert a.fov_x() == b.fov_x() and a.fov_y() == b.fov_y()


def _assert_loaders_agree(root, **kw):
    cams_t, pcd_t, center_t = t_dataset.load_dataset(str(root), **kw)
    cams_j, pcd_j, center_j = j_dataset.load_dataset(str(root), **kw)
    _assert_cameras_equal(cams_t, cams_j)
    np.testing.assert_array_equal(pcd_t.means, pcd_j.means)
    np.testing.assert_array_equal(pcd_t.colors, pcd_j.colors)
    np.testing.assert_array_equal(center_t, center_j)
    return cams_t, cams_j


def test_transforms_scene_matches_jax(rng, tmp_path):
    _transforms_scene(rng, tmp_path)
    cams_t, cams_j = _assert_loaders_agree(tmp_path)
    assert cams_t[0].width == W and cams_t[0].camera_model == CameraModelType.PINHOLE
    # RGBA composited over white, equal to the JAX package's image
    np.testing.assert_array_equal(cams_t[2].load_image(), cams_j[2].load_image())
    img = cams_t[2].load_image(cache=True)
    assert img.shape == (H, W, 3) and img.dtype == np.float32 and cams_t[2].load_image() is img
    # a resize factor and the width clamp reach the cameras alike
    _assert_loaders_agree(tmp_path, resize_factor=2)
    small_t, _ = _assert_loaders_agree(tmp_path, max_width=20)
    assert small_t[0].width == 20 and small_t[0].load_image().shape == (12, 20, 3)


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "text"])
def test_colmap_scene_matches_jax(rng, tmp_path, binary):
    _colmap_scene(rng, tmp_path, binary)
    assert t_colmap.is_colmap_dataset(tmp_path)
    cams, _ = _assert_loaders_agree(tmp_path)
    models = {c.image_name: c.camera_model for c in cams}
    assert models["im_00.png"] == CameraModelType.PINHOLE
    assert models["im_01.png"] == CameraModelType.OPENCV_PINHOLE
    assert models["im_02.png"] == CameraModelType.OPENCV_FISHEYE
    assert models["im_03.png"] == CameraModelType.PINHOLE  # distortion-free: the fast path
    assert [c.image_name for c in cams] == sorted(models)
    assert cams[1].tangential_distortion.shape == (2,) and cams[2].radial_distortion.shape == (4,)
    _assert_loaders_agree(tmp_path, resize_factor=2)


def test_unrecognised_dataset_raises(tmp_path):
    with pytest.raises(ValueError, match="unrecognized dataset"):
        t_dataset.load_dataset(str(tmp_path))


def test_dataset_split_rule():
    """test_io_formats.py:88: i % test_every == 0 -> val (dataset.hpp:42-48)."""
    cams = _poses(20)
    train = t_dataset.CameraDataset(cams, "train", test_every=8)
    val = t_dataset.CameraDataset(cams, "val", test_every=8)
    assert val.indices() == [0, 8, 16]
    assert len(train) == 17
    assert set(train.indices()) | set(val.indices()) == set(range(20))
    assert len(t_dataset.CameraDataset(cams, "train", test_every=0)) == 20
    assert train[0] is cams[1] and val[1] is cams[8]


def test_load_image_rgba_gray_and_resize(rng, tmp_path):
    rgba = rng.integers(0, 256, (H, W, 4)).astype(np.uint8)
    Image.fromarray(rgba).save(tmp_path / "a.png")
    Image.fromarray(rgba[..., 0]).save(tmp_path / "g.png")
    for name, size in (("a.png", (None, None)), ("a.png", (20, 12)), ("g.png", (None, None))):
        got = t_image.load_image(str(tmp_path / name), *size)
        np.testing.assert_array_equal(got, j_image.load_image(str(tmp_path / name), *size))
        assert got.shape[2] == 3 and got.dtype == np.float32 and got.flags["C_CONTIGUOUS"]
    a = rgba[..., 3:4].astype(np.float32) / 255.0
    want = rgba[..., :3].astype(np.float32) / 255.0 * a + (1.0 - a)
    np.testing.assert_allclose(t_image.load_image(str(tmp_path / "a.png")), want, atol=1e-6)
    both = t_image.side_by_side(want, want)
    assert both.shape == (H, 2 * W, 3)


# --- the native library through the port's bindings (tests/test_native.py) ---

def test_native_builds():
    assert t_native.available(), "native library failed to build"


def test_native_points3d_parse(rng):
    data, means, colors = _synthetic_points3d_bin(rng)
    parsed = t_native.parse_points3d_bin(data)
    assert parsed is not None
    np.testing.assert_allclose(parsed[0], means, atol=1e-6)
    np.testing.assert_allclose(parsed[1], colors, atol=0)


def test_native_points3d_matches_python_reader(rng, tmp_path, monkeypatch):
    data, means, colors = _synthetic_points3d_bin(rng, n=100)
    p = tmp_path / "points3D.bin"
    p.write_bytes(data)
    pc = t_colmap._read_points3d_bin(p)
    np.testing.assert_allclose(pc.means, means, atol=1e-6)
    np.testing.assert_allclose(pc.colors, colors, atol=0)
    # and the pure-Python reader, which serves a machine without a toolchain
    monkeypatch.setattr(t_native, "parse_points3d_bin", lambda data: None)
    pc2 = t_colmap._read_points3d_bin(p)
    np.testing.assert_array_equal(pc2.means, pc.means)
    np.testing.assert_array_equal(pc2.colors, pc.colors)


def test_native_deinterleave(rng):
    n, stride = 1000, 7
    blob = rng.normal(0, 1, (n, stride)).astype(np.float32)
    sel = np.array([0, 3, 6], np.int32)
    out = t_native.deinterleave(blob.reshape(-1), n, stride, sel)
    assert out is not None
    np.testing.assert_allclose(out, blob[:, sel].T, atol=0)


def test_native_resize_box(rng):
    img = rng.uniform(0, 1, (64, 48, 3)).astype(np.float32)
    out = t_native.resize_box(img, 4)
    assert out is not None
    np.testing.assert_allclose(out, img.reshape(16, 4, 12, 4, 3).mean(axis=(1, 3)), atol=1e-6)


@pytest.mark.parametrize("preload", [False, True])
def test_loader_order_matches_jax_for_one_worker(rng, tmp_path, preload):
    """One worker and one seed: the port's loader hands out the JAX
    loader's cameras in its order, with equal images (more workers make the
    queue's order non-deterministic in both packages)."""
    _transforms_scene(rng, tmp_path, n=5)
    cams_t, _, _ = t_dataset.load_dataset(str(tmp_path))
    cams_j, _, _ = j_dataset.load_dataset(str(tmp_path))
    lt = t_dataset.InfiniteRandomLoader(t_dataset.CameraDataset(cams_t, "train", 3),
                                        num_workers=1, seed=1, preload=preload)
    lj = j_dataset.InfiniteRandomLoader(j_dataset.CameraDataset(cams_j, "train", 3),
                                        num_workers=1, seed=1, preload=preload)
    try:
        for _ in range(9):  # more than two epochs of the 3 training views
            (cam_t, img_t), (cam_j, img_j) = next(lt), next(lj)
            assert cam_t.uid == cam_j.uid and cam_t.uid % 3 != 0
            assert isinstance(img_t, np.ndarray) and img_t.shape == (H, W, 3)
            np.testing.assert_array_equal(img_t, img_j)
    finally:
        lt.stop()
        lj.stop()
    assert to_torch_camera(cams_j[1]).image_name == cams_t[1].image_name
