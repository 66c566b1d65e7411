"""The frame-coherent renderer of the port: the dilated and the
feature-only projection against the JAX package's (n_touched, tile bounds,
mask and validity exact), the reference's cases of tests/test_coherent.py on
the port, its frames against the JAX CoherentRenderer's on the same cameras
(the reference's u8 bounds), the re-bin after an in-place write of the
model, the zeroed features of culled gaussians and max_reuse."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lichtfeld_studio_tpu.core.camera import look_at_camera as j_look_at
from lichtfeld_studio_tpu.core.splat_data import SplatData as JSplatData
from lichtfeld_studio_tpu.ops.projection import project_gaussians as j_project
from lichtfeld_studio_tpu.render.coherent import CoherentRenderer as JCoherentRenderer
from lichtfeld_studio_tpu_torch.core.camera import look_at_camera
from lichtfeld_studio_tpu_torch.ops.projection import project_gaussians as t_project
from lichtfeld_studio_tpu_torch.ops.rasterize import count_instances, rasterize
from lichtfeld_studio_tpu_torch.render import coherent as t_coherent
from lichtfeld_studio_tpu_torch.render.coherent import CoherentRenderer
from tests.scene_utils import make_camera, make_random_splats
from tests.torch_parity import np_, to_torch_camera, to_torch_splats

W = H = 64
N = 400


def _j_scene():
    """tests/test_coherent.py's scene, in the JAX package."""
    rng = np.random.default_rng(3)
    pos = rng.normal(0, 0.8, (N, 3)).astype(np.float32)
    col = rng.uniform(0.1, 0.9, (N, 3)).astype(np.float32)
    s = JSplatData.from_point_cloud(pos, col, np.zeros(3, np.float32), capacity=N)
    return s.replace_trainable({
        **s.trainable_dict(),
        "opacity": jnp.full((N, 1), 1.5),
        "scaling": jnp.full((N, 3), float(np.log(0.06))),
    })


def _scene():
    return to_torch_splats(_j_scene())


def _cam(theta, look=look_at_camera):
    eye = 4.0 * np.array([np.sin(theta), -0.2, -np.cos(theta)])
    return look(eye, np.zeros(3), np.array([0.0, -1.0, 0.0]), fx=60.0, fy=60.0, width=W,
                height=H)


def _exact_u8(splats, cam):
    with torch.no_grad():
        out = rasterize(splats, cam.device_params(), torch.zeros(3), mode="cuda", tile_size=32,
                        instance_cap=4096, inference=True)
    return np_(torch.clamp(out.image * 255.0 + 0.5, 0, 255).to(torch.uint8)).astype(np.int32)


def _assert_u8_close(img, ref):
    """tests/test_coherent.py's bounds: only the blend ORDER within a tile
    may deviate, by a few u8 steps on edge pixels."""
    diff = np.abs(img.astype(np.int32) - ref.astype(np.int32))
    assert np.median(diff) <= 1, np.median(diff)
    assert (diff <= 3).mean() > 0.99, (diff.max(), (diff > 3).mean())


# --- the projection's dilated and feature-only modes --------------------------------

@pytest.mark.parametrize("dilate_px,exact_cap", [(0.0, 16), (2.0, 16), (6.0, 16), (2.0, 32),
                                                 (0.0, 0), (2.0, 0)])
def test_projection_dilation_and_feature_only_match_jax(rng, dilate_px, exact_cap):
    sd = make_random_splats(rng, n=120, capacity=128, spread=1.5)
    cam = make_camera(96, 64)
    cp = cam.device_params()
    common = dict(width=cam.width, height=cam.height, tile_size=32 if exact_cap == 16 else 16,
                  exact_tile_cap=exact_cap, dilate_px=dilate_px)
    pj = jax.jit(j_project, static_argnames=tuple(common))(
        sd.means, sd.scaling, sd.rotation, sd.opacity, sd.sh0, sd.shN, sd.active_mask(),
        sd.active_sh_degree, cp.w2c, cp.cam_position, cp.K, **common)
    ts = to_torch_splats(sd)
    with torch.no_grad():
        pt = t_project(ts.means, ts.scaling, ts.rotation, ts.opacity, ts.sh0, ts.shN,
                       ts.active_mask(), ts.active_sh_degree,
                       torch.tensor(np.asarray(cp.w2c)), torch.tensor(np.asarray(cp.cam_position)),
                       torch.tensor(np.asarray(cp.K)), **common)
    for name in ("valid", "bbox", "n_touched", "tile_mask"):
        np.testing.assert_array_equal(np_(getattr(pt, name)), np_(getattr(pj, name)), err_msg=name)
    assert np_(pt.valid).sum() > 60
    if exact_cap == 0:
        assert not np_(pt.tile_mask).any()


def test_dilation_grows_the_instance_count(rng):
    """count_instances(dilate_px) is the bin pass's count: it grows with the
    dilation and never falls below the exact count."""
    sd = to_torch_splats(make_random_splats(rng, n=200, spread=1.5))
    params = to_torch_camera(make_camera(128, 96)).device_params()
    with torch.no_grad():
        counts = [int(count_instances(sd, params, dilate_px=d)) for d in (0.0, 2.0, 6.0)]
    assert counts[0] < counts[1] < counts[2], counts


# --- tests/test_coherent.py on the port -------------------------------------------

def test_coherent_matches_exact_nearby():
    splats = _scene()
    r = CoherentRenderer(W, H, tile_size=32, instance_cap=4096, dilate_px=6.0)
    thetas = [0.0, 0.002, 0.004, 0.006]  # a slow orbit: drift well under the budget
    for th in thetas:
        _assert_u8_close(r.render(splats, _cam(th)), _exact_u8(splats, _cam(th)))
    assert r.stats["bins"] == 1, r.stats  # every frame reused one binning
    assert r.stats["frames"] == len(thetas)


def test_rebin_on_large_motion_and_model_change():
    splats = _scene()
    r = CoherentRenderer(W, H, tile_size=32, instance_cap=4096, dilate_px=6.0)
    r.render(splats, _cam(0.0))
    r.render(splats, _cam(0.8))  # ~0.8 rad: far past the drift budget
    assert r.stats["bins"] == 2, r.stats
    img_far = r.render(splats, _cam(0.8))
    exact = _exact_u8(splats, _cam(0.8))
    assert (np.abs(img_far.astype(np.int32) - exact) <= 3).mean() > 0.99
    # another model object forces a re-bin
    r.render(_scene(), _cam(0.8))
    assert r.stats["bins"] == 3, r.stats


def test_in_place_write_rebins():
    """The trainer writes the model in place (Adam, refines): the object
    stays, its version moves, and the next frame re-bins and shows the
    written model."""
    splats = _scene()
    r = CoherentRenderer(W, H, tile_size=32, instance_cap=4096, dilate_px=6.0)
    r.render(splats, _cam(0.0))
    r.render(splats, _cam(0.0))
    assert r.stats["bins"] == 1
    with torch.no_grad():
        splats.replace_trainable({"means": splats.means + torch.tensor([1.0, 0.0, 0.0])})
    img = r.render(splats, _cam(0.0))
    assert r.stats["bins"] == 2, r.stats
    _assert_u8_close(img, _exact_u8(splats, _cam(0.0)))


def test_max_reuse_rebins():
    splats = _scene()
    r = CoherentRenderer(W, H, tile_size=32, instance_cap=4096, dilate_px=6.0, max_reuse=2)
    for _ in range(7):
        r.render(splats, _cam(0.0))
    assert r.stats["bins"] == 3, r.stats  # frames 0, 3 and 6


def test_culled_gaussians_reach_p2_as_zeros(monkeypatch):
    """Reused lists from a far bin camera: gaussians behind the current
    camera reach P2 with opacity, mean2d, conic and colour 0, all finite."""
    splats = _scene()
    with torch.no_grad():
        splats.replace_trainable({"means": splats.means * 3.0})  # some end behind the camera
    seen = []
    real = t_coherent.blend_forward

    def spy(*args, **kw):
        seen.append(args)
        return real(*args, **kw)

    monkeypatch.setattr(t_coherent, "blend_forward", spy)
    r = CoherentRenderer(W, H, tile_size=32, instance_cap=1 << 14, dilate_px=6.0,
                         drift_budget=1e9)
    r.render(splats, _cam(0.0))
    r.render(splats, _cam(0.3))  # the bin of camera 0.0, reused
    assert r.stats["bins"] == 1
    mean2d, conic, opacity, color = seen[-1][3:]
    with torch.no_grad():
        params = _cam(0.3).device_params()
        depth = (splats.means @ params.w2c[:3, :3].T + params.w2c[:3, 3])[:, 2]
    behind = depth < 0.01
    assert behind.any() and (~behind).any()
    for t in (mean2d, conic, opacity, color):
        assert torch.isfinite(t).all()
        assert (t[behind] == 0).all()


def test_frames_match_the_jax_coherent_renderer():
    """The same cameras through both packages' coherent renderers: the same
    bin count, every frame within the reference's u8 bounds."""
    j_r = JCoherentRenderer(W, H, tile_size=32, instance_cap=4096, dilate_px=6.0)
    t_r = CoherentRenderer(W, H, tile_size=32, instance_cap=4096, dilate_px=6.0)
    j_splats, t_splats = _j_scene(), _scene()
    for th in (0.0, 0.004, 0.8):
        _assert_u8_close(t_r.render(t_splats, _cam(th)), j_r.render(j_splats, _cam(th, j_look_at)))
    assert t_r.stats["bins"] == j_r.stats["bins"] == 2
