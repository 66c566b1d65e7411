"""Port parity for the headless render slice as a whole: PLY interchange
with the JAX package, render_view against the JAX package's render_view
(u8 images: >= 99.5% of values within 2 levels, median 0), and the CLI."""

import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

from lichtfeld_studio_tpu.io.ply import write_ply as j_write_ply
from lichtfeld_studio_tpu.render.headless import render_view as j_render_view
from lichtfeld_studio_tpu_torch import cli as tcli
from lichtfeld_studio_tpu_torch.io.ply import read_ply as t_read_ply
from lichtfeld_studio_tpu_torch.io.ply import write_ply as t_write_ply
from lichtfeld_studio_tpu_torch.render import headless as theadless
from tests.scene_utils import make_camera, make_random_splats
from tests.torch_parity import to_torch_camera, to_torch_splats


def _splats(rng, n=60):
    sd = make_random_splats(rng, n=n)
    return dataclasses.replace(sd, scene_scale=1.6)


def test_ply_roundtrip_with_jax_package(rng, tmp_path):
    sd = _splats(rng)
    pc = sd.to_point_cloud()
    j_path = tmp_path / "jax.ply"
    j_write_ply(pc, j_path)
    pt = t_read_ply(j_path)
    for name in ("means", "sh0", "shN", "opacity", "scaling", "rotation", "normals"):
        np.testing.assert_array_equal(getattr(pt, name), getattr(pc, name), err_msg=name)
    assert pt.attribute_names == pc.attribute_names
    # byte-compatible writer: the port's file is the JAX package's file
    t_path = tmp_path / "torch.ply"
    t_write_ply(pc, t_path)
    assert t_path.read_bytes() == j_path.read_bytes()
    # the port's export of the same model matches to float32 rounding
    # (quaternion normalisation in another order)
    pc_t = to_torch_splats(sd).to_point_cloud()
    assert pc_t.attribute_names == pc.attribute_names
    for name in ("means", "sh0", "shN", "opacity", "scaling", "rotation"):
        np.testing.assert_allclose(getattr(pc_t, name), getattr(pc, name), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


def test_render_view_matches_jax(rng):
    sd = _splats(rng)
    cam = make_camera(64, 48)
    img_j = j_render_view(sd, cam, bg_color=(0.1, 0.2, 0.3))
    img_t = theadless.render_view(to_torch_splats(sd), to_torch_camera(cam), bg_color=(0.1, 0.2, 0.3))
    assert img_t.shape == img_j.shape == (48, 64, 3)
    diff = np.abs(np.round(img_t * 255.0) - np.round(np.asarray(img_j) * 255.0))
    assert np.mean(diff <= 2) >= 0.995
    assert np.median(diff) == 0
    assert img_t.std() > 0.01


def test_cli_renders_png(rng, tmp_path, monkeypatch):
    """The CLI on the CPU: the test asks for it (the CLI itself renders
    only on a GPU)."""
    sd = _splats(rng)
    ply = tmp_path / "scene.ply"
    j_write_ply(sd.to_point_cloud(), ply)
    png = tmp_path / "out" / "view.png"
    monkeypatch.setattr(theadless, "default_device", lambda: torch.device("cpu"))
    rc = tcli.main(["-v", str(ply), "--render-output", str(png), "--render-size", "64", "48"])
    assert rc == 0
    img = np.asarray(Image.open(png))
    assert img.shape == (48, 64, 3)
    assert img.std() > 1.0  # not uniform


def test_cli_refuses_to_render_without_a_gpu(rng, tmp_path, capsys, monkeypatch):
    """No GPU and no request for the CPU: the CLI exits non-zero and writes
    nothing (there is no fallback to the CPU's plain versions)."""
    ply = tmp_path / "scene.ply"
    j_write_ply(_splats(rng).to_point_cloud(), ply)
    png = tmp_path / "view.png"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        theadless.default_device()
    rc = tcli.main(["-v", str(ply), "--render-output", str(png), "--render-size", "64", "48"])
    assert rc != 0
    assert "GPU" in capsys.readouterr().err
    assert not png.exists()


def test_cli_clean_errors(tmp_path, capsys):
    assert tcli.main(["-v", str(tmp_path / "missing.ply")]) == 2
    assert "not found" in capsys.readouterr().err
    bad = tmp_path / "bad.ply"
    bad.write_bytes(b"ply\nformat binary_little_endian 1.0\nelement vertex 5\n")
    assert tcli.main(["-v", str(bad), "--render-output", str(tmp_path / "x.png")]) == 2
    assert "could not load" in capsys.readouterr().err
    assert tcli.main(["-d", str(tmp_path / "somewhere"), "--iterations", "5"]) == 2
    assert "dataset not found" in capsys.readouterr().err
    assert tcli.main(["-d", str(tmp_path), "--devices", "2"]) == 2  # --sog is ported now
    assert "not ported yet" in capsys.readouterr().err
    assert tcli.main(["-v", str(bad), "--render-output", str(tmp_path / "x.html")]) == 2


def test_bucket_cap_and_overflow(rng):
    assert theadless._bucket_cap(100_000) == 1 << 17
    assert theadless._bucket_cap(2_000_000) == 3_145_728
    assert theadless._bucket_cap(10**9) == 1 << 22
    sd = to_torch_splats(_splats(rng))
    cam = to_torch_camera(make_camera(64, 48))
    with pytest.raises(RuntimeError, match="overflow"):
        theadless.render_view(sd, cam, instance_cap=8)


def test_benchmark_fps_snug_cap_and_overflow(rng):
    sd = to_torch_splats(_splats(rng))
    cams = [to_torch_camera(make_camera(48, 32))]
    peak, cap = theadless.snug_cap(sd, cams)
    assert 0 < peak <= cap < peak * 1.04 + 128 and cap % 128 == 0
    assert theadless.benchmark_fps(sd, n_frames=2, cameras=cams) > 0
    with pytest.raises(RuntimeError, match="overflow"):
        theadless.benchmark_fps(sd, n_frames=1, instance_cap=8, cameras=cams)


def test_splat_data_from_numpy_keeps_slots(rng):
    sd = make_random_splats(rng, n=20, capacity=32)
    ts = to_torch_splats(sd)
    assert ts.capacity == 32 and int(ts.n_active) == 20
    np.testing.assert_array_equal(ts.active_mask().numpy(), np.asarray(sd.active_mask()))
    np.testing.assert_allclose(
        ts.get_opacity().detach().numpy(), np.asarray(sd.get_opacity()), rtol=1e-6
    )
    # from_arrays pads dead slots exactly as the JAX package does
    live = [np.asarray(getattr(sd, k))[:20] for k in FIELDS]
    ts2 = theadless.SplatData.from_arrays(*live, capacity=32)
    sd2 = type(sd).from_arrays(*live, capacity=32)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(ts2, k).detach().numpy(), np.asarray(getattr(sd2, k)))
    assert int(ts2.active_sh_degree) == int(sd2.active_sh_degree)


FIELDS = ("means", "sh0", "shN", "scaling", "rotation", "opacity")
