"""Port parity for kernel P2 (forward tile blend): the port's
rasterize(mode="cuda", inference=True) on CPU tensors, which runs the plain
version of the blend, against the JAX package.

Tolerances:
  * vs JAX rasterize(mode="oracle"): image and alpha atol 2.5e-3 — the
    inference termination at T < 1/512 leaves out at most 1/512 per pixel,
    plus float32 noise;
  * vs JAX rasterize(mode="pallas", inference=True) in interpret mode:
    image atol 6e-3, which adds the JAX kernel's bf16 colours (~0.4%);
  * depth: the same 2.5e-3 bound scaled by the largest depth.
The CUDA kernel against the plain version is in test_torch_kernels_cuda.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# jitted: one compile per shape instead of an eager compile per op
from lichtfeld_studio_tpu.ops.rasterize import rasterize_jit as j_rasterize
from lichtfeld_studio_tpu_torch.core.camera import CameraModelType
from lichtfeld_studio_tpu_torch.kernels import blend as tblend
from lichtfeld_studio_tpu_torch.ops.rasterize import apply_render_mode
from lichtfeld_studio_tpu_torch.ops.rasterize import rasterize as t_rasterize
from lichtfeld_studio_tpu_torch.tools.checks import blend_groups, blend_work
from tests.scene_utils import make_camera, make_random_splats
from tests.torch_parity import (
    binned_blend_inputs,
    crafted_blend_inputs,
    np_,
    random_scene,
    to_torch_camera,
    to_torch_splats,
)

ORACLE_ATOL = 2.5e-3
PALLAS_ATOL = 6e-3
BG = (0.2, 0.1, 0.4)


def _port_render(sd, cam, bg=BG, device="cpu", **kw):
    with torch.no_grad():
        return t_rasterize(
            to_torch_splats(sd, device), to_torch_camera(cam).device_params(device),
            torch.tensor(bg, device=device), mode="cuda", inference=True,
            instance_cap=8192, **kw,
        )


def test_blend_matches_jax_oracle(rng):
    cam = make_camera(48, 32)
    sd = make_random_splats(rng, n=96)
    out_t = _port_render(sd, cam)
    out_o = j_rasterize(sd, cam.device_params(), jnp.asarray(BG), mode="oracle")
    assert out_t.image.shape == (32, 48, 3)
    np.testing.assert_allclose(np_(out_t.image), np_(out_o.image), atol=ORACLE_ATOL)
    np.testing.assert_allclose(np_(out_t.alpha), np_(out_o.alpha), atol=ORACLE_ATOL)


def test_blend_matches_jax_pallas_inference(rng):
    cam = make_camera(48, 32)
    sd = make_random_splats(rng, n=96)
    out_t = _port_render(sd, cam)
    out_p = j_rasterize(
        sd, cam.device_params(), jnp.asarray(BG), mode="pallas", inference=True,
        instance_cap=4096,
    )
    assert int(out_t.n_instances) == int(out_p.n_instances)
    np.testing.assert_allclose(np_(out_t.image), np_(out_p.image), atol=PALLAS_ATOL)
    np.testing.assert_allclose(np_(out_t.alpha), np_(out_p.alpha), atol=ORACLE_ATOL)


def test_blend_deep_tile_early_termination(rng):
    """Many near-opaque gaussians on one tile: termination and walks deeper
    than one batch must still match the oracle."""
    cam = make_camera(32, 32)
    sd = make_random_splats(rng, n=300, spread=0.25, opacity_range=(0.85, 0.99))
    out_t = _port_render(sd, cam, bg=(0.0, 0.0, 0.0))
    out_o = j_rasterize(sd, cam.device_params(), jnp.zeros(3), mode="oracle")
    assert int(out_t.n_instances) > 256
    np.testing.assert_allclose(np_(out_t.image), np_(out_o.image), atol=ORACLE_ATOL)
    np.testing.assert_allclose(np_(out_t.alpha), np_(out_o.alpha), atol=ORACLE_ATOL)


def test_blend_depth_mode(rng):
    cam = make_camera(32, 32)
    sd = make_random_splats(rng, n=24)
    out_t = _port_render(sd, cam, bg=(0.0, 0.0, 0.0), with_depth=True)
    out_o = j_rasterize(sd, cam.device_params(), jnp.zeros(3), mode="oracle", with_depth=True)
    d_o = np_(out_o.depth)
    np.testing.assert_allclose(np_(out_t.depth), d_o, atol=ORACLE_ATOL * float(np.abs(d_o).max()))
    np.testing.assert_allclose(np_(out_t.image), np_(out_o.image), atol=ORACLE_ATOL)
    ed = np_(apply_render_mode(out_t, "ED"))
    assert ed.shape == (32, 32, 1) and np.isfinite(ed).all()


def test_port_oracle_matches_jax_oracle(rng):
    cam = make_camera(32, 24)
    sd = make_random_splats(rng, n=40)
    with torch.no_grad():
        out_t = t_rasterize(
            to_torch_splats(sd), to_torch_camera(cam).device_params(),
            torch.tensor(BG), mode="oracle",
        )
    out_o = j_rasterize(sd, cam.device_params(), jnp.asarray(BG), mode="oracle")
    np.testing.assert_allclose(np_(out_t.image), np_(out_o.image), atol=1e-5)
    np.testing.assert_allclose(np_(out_t.alpha), np_(out_o.alpha), atol=1e-5)


def test_training_and_gut_paths_raise(rng):
    """The training, UT and gut-exact paths render, the gut-exact path's
    ORTHO camera too (a finite, non-empty frame)."""
    cam = make_camera(32, 32)
    sd = make_random_splats(rng, n=8)
    ts, cp = to_torch_splats(sd), to_torch_camera(cam).device_params()
    # the training path is ported: it renders a differentiable image
    assert t_rasterize(ts, cp, torch.zeros(3), mode="cuda", inference=False).image.requires_grad
    for kw in (dict(gut_exact=True, projection="ut"), dict(projection="ut")):
        out = t_rasterize(ts, cp, torch.zeros(3), mode="cuda", inference=True, **kw)
        assert torch.isfinite(out.image).all() and float(out.alpha.max()) > 0.0
    fisheye = dataclasses.replace(to_torch_camera(cam), camera_model=CameraModelType.OPENCV_FISHEYE)
    assert fisheye.device_params().camera_model == CameraModelType.OPENCV_FISHEYE
    ortho = dataclasses.replace(cp, camera_model=CameraModelType.ORTHO,
                                K=cp.K * torch.tensor([0.25, 0.25, 1.0, 1.0]))
    out = t_rasterize(ts, ortho, torch.zeros(3), mode="cuda", inference=True, gut_exact=True)
    assert torch.isfinite(out.image).all() and float(out.alpha.max()) > 0.0


def test_blend_rejects_bad_inputs(rng):
    sd, cam = random_scene(rng, n=32)
    args, kw = binned_blend_inputs(sd, cam, "cpu")
    bad = list(args)
    bad[3] = args[3].double()
    with pytest.raises(ValueError):
        tblend.blend_forward(*bad, **kw)
    bad = list(args)
    bad[4] = args[4].t().contiguous().t()  # same shape, not contiguous
    with pytest.raises(ValueError):
        tblend.blend_forward(*bad, **kw)


@pytest.mark.parametrize("tile_size", [16, 32])
@pytest.mark.parametrize("kind", ["large", "tiny", "patch_edge", "clamped", "elongated",
                                  "ill_conditioned"])
def test_reach_mirror_never_skips_a_passing_pair(kind, tile_size):
    """The plain mirror of P2's and P3's (warp patch, instance) reach skip
    (kernels/blend.py::patch_reach_skip_group, counted over every tile's
    whole range by tools/checks.py::blend_work, which the bounds count by)
    skips no pair in which a pixel passes the plain alpha test, on gaussians
    made for the kernels' patches: larger than a tile, smaller than a patch,
    on patch edges, clamped, thin and turned, and with conics near
    singular, indefinite or not finite (never skipped)."""
    args, _, kw = crafted_blend_inputs(kind, tile_size, 3, torch.device("cpu"))
    r = blend_work(blend_groups(args, kw), tile_size)
    assert r["lost"] == 0, r
    assert 0 <= r["skipped"] < r["patch_pairs"], r
    if kind == "large":  # every patch is in reach
        assert r["skipped"] == 0, r
    if kind in ("tiny", "elongated"):  # a tiny one reaches at most four of eight patches
        assert r["skipped"] >= r["patch_pairs"] // (2 if kind == "tiny" else 8), r
    if kind == "ill_conditioned":  # the unbounded boxes reach every patch
        box = tblend.reach_2d_plain(*args[3:6])
        assert bool(torch.isinf(box).all(dim=-1).any())

