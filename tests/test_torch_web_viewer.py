"""The port's HTML viewer export: byte for byte the JAX package's for the
same model and seed (one model, several, sampled down, with camera
frustums), and the reference's cases of tests/test_web_viewer.py on the
port, the CLI's .html export and multi-model -v among them."""

import base64
import json
import re

import numpy as np
import pytest
import torch

from lichtfeld_studio_tpu.core.camera import look_at_camera as j_look_at
from lichtfeld_studio_tpu.render.web_viewer import export_html as j_export_html
from lichtfeld_studio_tpu_torch import cli as t_cli
from lichtfeld_studio_tpu_torch.core.camera import look_at_camera
from lichtfeld_studio_tpu_torch.core.point_cloud import PointCloud
from lichtfeld_studio_tpu_torch.io.ply import write_ply
from lichtfeld_studio_tpu_torch.render import headless
from lichtfeld_studio_tpu_torch.render.web_viewer import export_html
from tests.scene_utils import make_random_splats
from tests.torch_parity import np_, to_torch_splats

STRIDE = 12 + 4 + 12 + 9
FIELDS = ("means", "sh0", "shN", "opacity", "scaling", "rotation")


def _extract(html: str):
    meta = json.loads(re.search(r"const META = (\{.*?\});", html).group(1))
    data = base64.b64decode(re.search(r'atob\("([A-Za-z0-9+/=]*)"\)', html).group(1))
    return meta, data


def _splats(rng, n, capacity=None):
    return to_torch_splats(make_random_splats(rng, n=n, capacity=capacity))


def _cams(look):
    return [look(np.array([2.0, 0.5, float(k)]), np.zeros(3), np.array([0.0, -1.0, 0.0]),
                 fx=60.0, fy=60.0, width=64, height=48) for k in range(3)]


# --- byte for byte against the JAX package ------------------------------------------

@pytest.mark.parametrize("case", ["one", "sampled", "several", "cameras"])
def test_export_is_byte_identical_to_jax(rng, tmp_path, case):
    js = [make_random_splats(rng, n=n, capacity=n + 8) for n in (90, 50)]
    kw_t, kw_j = {}, {}
    if case == "sampled":
        kw_t = kw_j = {"max_points": 40, "seed": 7}
    if case == "cameras":
        kw_t, kw_j = {"cameras": _cams(look_at_camera)}, {"cameras": _cams(j_look_at)}
    j_pcs = [j.to_point_cloud() for j in js]
    t_pcs = [PointCloud(**{k: getattr(pc, k) for k in FIELDS}) for pc in j_pcs]
    if case == "several":
        j_arg, t_arg = list(zip("ab", j_pcs)), list(zip("ab", t_pcs))
    else:
        j_arg, t_arg = j_pcs[0], t_pcs[0]
    want = j_export_html(j_arg, tmp_path / "j.html", **kw_j).read_bytes()
    got = export_html(t_arg, tmp_path / "t.html", **kw_t).read_bytes()
    assert got == want
    # and from the models themselves (the port's to_point_cloud)
    if case == "one":
        got = export_html(to_torch_splats(js[0]), tmp_path / "s.html").read_bytes()
        want = j_export_html(js[0], tmp_path / "js.html").read_bytes()
        assert got == want


# --- tests/test_web_viewer.py on the port -----------------------------------------

def test_export_layout_and_quantization(rng, tmp_path):
    splats = _splats(rng, 100, 128)
    meta, data = _extract(export_html(splats, tmp_path / "v.html").read_text())
    assert meta["count"] == 100
    assert len(data) == 100 * STRIDE
    buf = np.frombuffer(data, np.uint8).reshape(100, STRIDE)
    pos = buf[:, 0:12].copy().view("<f4")
    np.testing.assert_allclose(pos, np_(splats.means[:100]), rtol=1e-6)
    opac = buf[:, 15].astype(np.float64)
    want = 255.0 / (1.0 + np.exp(-np_(splats.opacity[:100, 0]).astype(np.float64)))
    assert np.abs(opac - want).max() <= 1.0
    sh1 = buf[:, 28:37].copy().view(np.int8).astype(np.float32) * meta["sh1_scale"]
    want_sh1 = np_(splats.shN[:100, :3, :]).reshape(100, 9)
    assert np.abs(sh1 - want_sh1).max() <= meta["sh1_scale"] * 1.01


def test_export_feature_surface(rng, tmp_path):
    html = export_html(_splats(rng, 50, 64), tmp_path / "v.html").read_text()
    for needle in ["uniform int mode", "turbo(", "point cloud", "splitx", "a_sh1a",
                   "drawArraysInstanced", "vertexAttribDivisor"]:
        assert needle in html, needle
    assert "__META__" not in html and "__DATA__" not in html


def test_export_overlay_tools(rng, tmp_path):
    splats = _splats(rng, 80, 128)
    html = export_html(splats, tmp_path / "v.html", cameras=_cams(look_at_camera)).read_text()
    meta, _ = _extract(html)
    assert np.all(np.asarray(meta["bbox_min"]) <= np.asarray(meta["bbox_max"]))
    assert len(meta["frustums"]) == 3
    assert all(len(f) == 15 for f in meta["frustums"])
    np.testing.assert_allclose(np.asarray(meta["frustums"][1][:3]), [2.0, 0.5, 1.0], atol=1e-5)
    for needle in ["useCrop", "cropMin", "cropMax", "axesLines", "gridLines", "boxLines",
                   "frustumGeo", "drawLines"]:
        assert needle in html, needle
    meta2, _ = _extract(export_html(splats, tmp_path / "v2.html").read_text())
    assert meta2["frustums"] == []


def test_export_respects_max_points(rng, tmp_path):
    html = export_html(_splats(rng, 200, 256), tmp_path / "v.html", max_points=64).read_text()
    meta, data = _extract(html)
    assert meta["count"] == 64
    assert len(data) == 64 * STRIDE


def test_export_multi_model_scene(rng, tmp_path):
    a, b = _splats(rng, 60, 64), _splats(rng, 40, 64)
    html = export_html([("left", a), ("right", b)], tmp_path / "scene.html").read_text()
    meta, data = _extract(html)
    assert [m["name"] for m in meta["models"]] == ["left", "right"]
    assert [m["count"] for m in meta["models"]] == [60, 40]
    assert meta["models"][1]["start"] == 60 and meta["count"] == 100
    assert len(data) == 100 * STRIDE
    pos = np.frombuffer(data, np.uint8).reshape(100, STRIDE)[:, 0:12].copy().view("<f4")
    np.testing.assert_allclose(pos[:60], np_(a.means[:60]), rtol=1e-6)
    np.testing.assert_allclose(pos[60:], np_(b.means[:40]), rtol=1e-6)
    for needle in ["modelOf", "drawCount", 'getElementById("scene")']:
        assert needle in html, needle


def test_cli_multi_model_view(rng, tmp_path, monkeypatch):
    """-v a.ply,b.ply exports a two-model viewer through the CLI, with no
    GPU asked for (the export is host numpy)."""
    def no_gpu():
        raise AssertionError("the HTML export asked for a GPU")

    monkeypatch.setattr(headless, "default_device", no_gpu)
    pa, pb = tmp_path / "a.ply", tmp_path / "b.ply"
    write_ply(_splats(rng, 30, 32).to_point_cloud(), pa)
    write_ply(_splats(rng, 20, 32).to_point_cloud(), pb)
    out = tmp_path / "scene.html"
    assert t_cli.main(["-v", f"{pa},{pb}", "--render-output", str(out)]) == 0
    meta, _ = _extract(out.read_text())
    assert [m["name"] for m in meta["models"]] == ["a", "b"]
    assert meta["count"] == 50


def test_cli_multi_model_composite_render(rng, tmp_path, monkeypatch):
    """-v a.ply,b.ply --render-output x.png composites both models (on the
    CPU, which the test asks for)."""
    monkeypatch.setattr(headless, "default_device", lambda: torch.device("cpu"))
    pa, pb = tmp_path / "a.ply", tmp_path / "b.ply"
    write_ply(_splats(rng, 16, 16).to_point_cloud(), pa)
    write_ply(_splats(rng, 12, 16).to_point_cloud(), pb)
    out = tmp_path / "composite.png"
    assert t_cli.main(["-v", f"{pa},{pb}", "--render-output", str(out),
                       "--render-size", "64", "48"]) == 0
    from lichtfeld_studio_tpu_torch.io.image import load_image

    assert load_image(str(out)).shape[:2] == (48, 64)
