"""Port parity of the exact world-space (3DGUT) blend: the ray tables and the
dense oracle (ops/world_blend.py), the stream, and the plain versions of
P5 and P6 (kernels/world_blend.py, through rasterize mode "cuda" on the
CPU) against the JAX package, at 64x48 on scenes made with numpy from a
seed.

Tolerances:
  * ray tables and world_blend_tiles within 1e-5, its gradients within
    1e-4 of the largest per group (the same dense math on both sides);
  * P5/P6 plain against JAX's dense path (mode "tiles", k_max 512, float32
    colours): image and alpha within 1e-4, gradients within 1e-3 of the
    largest per group (the stream form evaluates dist as |C'd|^2/|Md|^2,
    the dense path as |Md x gro|^2/|Md|^2); rolling shutter with rotation
    within the JAX test's own bounds (the stream's origin is chordal);
  * against the Pallas kernel in interpret mode (bf16 colours, 3-pass bf16
    moments): image median 1e-5, max 1e-2; gradients 5e-2 of the largest.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lichtfeld_studio_tpu.core.camera import CameraModelType
from lichtfeld_studio_tpu.kernels.world_blend_pallas import pack_world_stream as j_pack_stream
from lichtfeld_studio_tpu.ops.rasterize import rasterize as j_rasterize
from lichtfeld_studio_tpu.ops.tiles import build_tile_assignment as j_bin
from lichtfeld_studio_tpu.ops.tiles import gather_instance_features
from lichtfeld_studio_tpu.ops.ut_projection import project_gaussians_ut as j_project_ut
from lichtfeld_studio_tpu.ops.world_blend import pack_world_features as j_pack_features
from lichtfeld_studio_tpu.ops.world_blend import world_blend_tiles as j_world_blend_tiles
from lichtfeld_studio_tpu.ops.world_blend import world_ray_table as j_world_ray_table
from lichtfeld_studio_tpu_torch.core.camera import CameraModelType as TCameraModelType
from lichtfeld_studio_tpu_torch.kernels.world_blend import (
    pack_world_stream,
    world_blend_forward,
)
from lichtfeld_studio_tpu_torch.ops.rasterize import _project, capture_world_inputs
from lichtfeld_studio_tpu_torch.ops.rasterize import rasterize as t_rasterize
from lichtfeld_studio_tpu_torch.ops.tiles import build_tile_assignment as t_bin
from lichtfeld_studio_tpu_torch.ops.world_blend import pack_world_features, world_blend_tiles
from lichtfeld_studio_tpu_torch.ops.world_blend import world_ray_table
from chip_smoke import blend_work, world_groups
from tests.gut_cases import CASES, FISHEYE_RADIAL, H, W, camera_case, rs_params
from tests.scene_utils import make_camera, make_random_splats
from tests.torch_parity import (
    np_,
    random_scene,
    rolling_params,
    to_torch_params,
    to_torch_splats,
    world_blend_inputs,
)

TILE = 16
FEAT_GROUPS = ("means", "log_scales", "quats", "opacity", "color")
SPLAT_GROUPS = ("means", "scaling", "rotation", "opacity", "sh0")


def _ray_args(p):
    return (p.w2c, p.K, p.camera_model, p.radial, p.tangential, p.width, p.height, TILE)


def _ortho_rays(p):
    """The ORTHO camera's world rays in float64: each pixel's own origin,
    camera-space ((px - cx) / fx, (py - cy) / fy, 0) taken to the world by
    the inverse pose, and the direction R^T (0, 0, 1). (The JAX package
    gives every pixel the camera centre, a fault of the reference.)"""
    w2c, (fx, fy, cx, cy) = np.asarray(p.w2c, np.float64), np.asarray(p.K, np.float64)
    ys, xs = np.mgrid[0:-(-H // TILE) * TILE, 0:-(-W // TILE) * TILE]
    o_cam = np.stack([(xs + 0.5 - cx) / fx, (ys + 0.5 - cy) / fy, np.zeros(xs.shape)], -1)
    r, t = w2c[:3, :3], w2c[:3, 3]
    o = (o_cam.reshape(-1, 3) - t) @ r
    return o, np.broadcast_to(r.T @ np.array([0.0, 0.0, 1.0]), o.shape)


def _jax_rays(p):
    if p.camera_model == CameraModelType.ORTHO:
        return tuple(jnp.asarray(x, jnp.float32) for x in _ortho_rays(p))
    zeros = jnp.zeros((0,), jnp.float32)
    return j_world_ray_table(p.w2c, p.K, p.camera_model,
                             p.radial if p.radial is not None else zeros,
                             p.tangential if p.tangential is not None else zeros,
                             p.width, p.height, TILE, w2c_end=p.w2c_end,
                             shutter_type=p.shutter_type)


@pytest.fixture
def one_torch_thread():
    """The port's ray table on one intra-op thread. After a JAX computation
    in the same process, torch's worker threads sometimes (about one
    process in five) return sqrt with errors up to 1.4e-4 on the part of
    the fisheye table they compute (rows 24-47 of 48); not once in 26 runs
    without the JAX call, nor in 10 on one thread. The port's arithmetic is
    what the test compares, so it runs where that arithmetic is exact."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", CASES)
def test_ray_tables_match_jax(case, one_torch_thread):
    """The port's ray tables against the JAX package's; the ortho case
    against the per-pixel origins computed here (_ortho_rays)."""
    p = camera_case(case)
    o_j, d_j = _jax_rays(p)
    q = to_torch_params(p)
    o_t, d_t = world_ray_table(*_ray_args(q), w2c_end=q.w2c_end, shutter_type=q.shutter_type)
    assert d_t.shape == (64 * 48, 3)
    np.testing.assert_allclose(np_(o_t), np.asarray(o_j), atol=1e-5)
    np.testing.assert_allclose(np_(d_t), np.asarray(d_j), atol=1e-5)


def _features(rng, n):
    quat = rng.normal(size=(n, 4)).astype(np.float32)
    return {
        "means": rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32),
        "log_scales": rng.uniform(np.log(0.03), np.log(0.2), (n, 3)).astype(np.float32),
        "quats": quat,
        "opacity": rng.uniform(0.2, 0.9, n).astype(np.float32),
        "color": rng.uniform(-0.1, 1.0, (n, 3)).astype(np.float32),
    }


@pytest.mark.parametrize("case", CASES)
def test_world_blend_tiles_matches_jax(case):
    """The dense oracle on the same binning (UT projection, full bboxes):
    values within 1e-5, gradients to its per-gaussian inputs within 1e-4 of
    the largest per group."""
    rng = np.random.default_rng(10 + CASES.index(case))
    sd = make_random_splats(rng, n=48, spread=1.0, sh_degree=0)
    p = camera_case(case)
    proj = j_project_ut(sd.means, sd.scaling, sd.rotation, sd.opacity, sd.sh0, sd.shN,
                        sd.active_mask(), sd.active_sh_degree, p.w2c, p.cam_position, p.K,
                        width=W, height=H, tile_size=TILE, camera_model=p.camera_model,
                        radial=p.radial, tangential=p.tangential, w2c_end=p.w2c_end,
                        shutter_type=p.shutter_type, exact_tile_test=False)
    gw, gh = -(-W // TILE), -(-H // TILE)
    a_j = j_bin(proj, grid_w=gw, grid_h=gh, instance_cap=8192)
    rays_j = _jax_rays(p)
    feats = _features(rng, sd.capacity)
    wi = rng.normal(size=(gh * TILE, gw * TILE, 3)).astype(np.float32)
    wa = rng.normal(size=(gh * TILE, gw * TILE)).astype(np.float32)

    def loss_j(f):
        feat = gather_instance_features(j_pack_features(**f), a_j, proj.n_touched)
        img, alpha = j_world_blend_tiles(feat, *rays_j, a_j, grid_w=gw, grid_h=gh, tile_size=TILE,
                                         k_max=512)
        return jnp.sum(img * wi) + jnp.sum(alpha * wa), (img, alpha)

    f_j = {k: jnp.asarray(v) for k, v in feats.items()}
    (_, (img_j, alpha_j)), g_j = jax.value_and_grad(loss_j, has_aux=True)(f_j)
    assert int(jnp.max(a_j.tile_count)) <= 512

    q = to_torch_params(p)
    proj_t = _project(to_torch_splats(sd), q, tile_size=TILE, projection="ut",
                      exact_tile_test=False)
    a_t = t_bin(proj_t, grid_w=gw, grid_h=gh, instance_cap=8192)
    rays_t = world_ray_table(*_ray_args(q), w2c_end=q.w2c_end, shutter_type=q.shutter_type)
    f_t = {k: torch.tensor(v, requires_grad=True) for k, v in feats.items()}
    img_t, alpha_t = world_blend_tiles(pack_world_features(**f_t), *rays_t, a_t, grid_w=gw,
                                       grid_h=gh, tile_size=TILE)
    g_t = torch.autograd.grad((img_t * torch.from_numpy(wi)).sum()
                              + (alpha_t * torch.from_numpy(wa)).sum(), list(f_t.values()))
    assert float(alpha_t.detach().max()) > 0.01, "fixture: nothing rendered"
    np.testing.assert_allclose(np_(img_t), np.asarray(img_j), atol=1e-5)
    np.testing.assert_allclose(np_(alpha_t), np.asarray(alpha_j), atol=1e-5)
    for k, g in zip(FEAT_GROUPS, g_t):
        ref = np.asarray(g_j[k])
        assert np.abs(np_(g) - ref).max() <= 1e-4 * np.abs(ref).max(), k


def test_pack_world_stream_matches_jax():
    """Geometry and opacity rows equal to float32 rounding; the colours are
    f32 here where the JAX package packs bf16 pairs."""
    f = _features(np.random.default_rng(3), 40)
    ray_o = np.array([0.3, -0.2, -4.0], np.float32)
    s_j = np.asarray(j_pack_stream(*(jnp.asarray(f[k]) for k in FEAT_GROUPS), jnp.asarray(ray_o)))
    s_t = np_(pack_world_stream(*(torch.from_numpy(f[k]) for k in FEAT_GROUPS),
                                torch.from_numpy(ray_o)))
    assert s_t.shape == (40, 24)
    # C' entries are differences of products ~10x their size
    np.testing.assert_allclose(s_t[:, :19], s_j[:19].T, rtol=1e-5, atol=1e-6 * np.abs(s_j).max())
    np.testing.assert_array_equal(s_t[:, 19:22], f["color"])
    assert not s_t[:, 22:].any()


# --- P5/P6 plain (rasterize mode "cuda" on the CPU) against the JAX package --

def _render_loss(render, splats, gt, with_depth=False):
    out = render(splats)
    loss = ((out.image - gt) ** 2).mean() + 0.1 * out.alpha.mean()
    if with_depth:
        loss = loss + 0.01 * out.depth.mean()
    return loss, out


def _compare(sd, params, *, rel_grad, img_tol=None, img_median=None, with_depth=False,
             jax_mode="tiles", k_max=512):
    """Render and differentiate a loss with the JAX package (jax_mode) and
    with the port's plain P5/P6 (mode "cuda" on the CPU); returns the two
    images for the caller's further checks."""
    gt = np.random.default_rng(0).uniform(0, 1, (H, W, 3)).astype(np.float32)

    def jax_loss(tr):
        s = sd.replace_trainable(tr)
        out = j_rasterize(s, params, jnp.zeros(3), mode=jax_mode, instance_cap=8192, k_max=k_max,
                          projection="ut", gut_exact=True, with_depth=with_depth)
        loss = jnp.mean((out.image - gt) ** 2) + 0.1 * jnp.mean(out.alpha)
        if with_depth:
            loss = loss + 0.01 * jnp.mean(out.depth)
        return loss, out

    (loss_j, out_j), g_j = jax.value_and_grad(jax_loss, has_aux=True)(sd.trainable_dict())
    ts = to_torch_splats(sd)
    loss_t, out_t = _render_loss(
        lambda s: t_rasterize(s, to_torch_params(params), torch.zeros(3), mode="cuda",
                              instance_cap=8192, projection="ut", gut_exact=True,
                              with_depth=with_depth),
        ts, torch.from_numpy(gt), with_depth)
    params_t = ts.trainable_dict()
    g_t = dict(zip(params_t, torch.autograd.grad(loss_t, list(params_t.values()), allow_unused=True)))
    err = np.abs(np_(out_t.image) - np.asarray(out_j.image))
    if img_tol is not None:
        assert err.max() <= img_tol, err.max()
        assert np.abs(np_(out_t.alpha) - np.asarray(out_j.alpha)).max() <= img_tol
    if img_median is not None:
        assert np.median(err) <= img_median[0] and err.max() <= img_median[1], (np.median(err), err.max())
    if with_depth:
        assert np.abs(np_(out_t.depth) - np.asarray(out_j.depth)).max() <= 1e-4
    n = int(sd.n_active)
    for k in SPLAT_GROUPS:
        a, b = np.asarray(g_j[k])[:n], np_(g_t[k])[:n]
        assert np.isfinite(np_(g_t[k])).all(), k
        assert np.abs(a - b).max() <= rel_grad * np.abs(a).max(), (k, np.abs(a - b).max() / np.abs(a).max())
    return out_t, out_j


def _fisheye(params):
    return dataclasses.replace(params, camera_model=CameraModelType.OPENCV_FISHEYE,
                               radial=jnp.asarray(FISHEYE_RADIAL))


STREAM_CASES = {
    # name: (n, spread, opacity range, camera, with_depth)
    "pinhole": (40, 1.0, (0.3, 0.95), lambda p: p, False),
    "fisheye": (40, 1.0, (0.3, 0.95), _fisheye, False),
    "depth": (24, 0.8, (0.3, 0.95), lambda p: p, True),
    "deep_tile": (96, 0.25, (0.05, 0.25), lambda p: p, False),
    "rolling_translation": (40, 1.0, (0.3, 0.95), lambda p: rs_params(p, dx=0.25, rot_deg=0.0),
                            False),
}


@pytest.mark.parametrize("name", list(STREAM_CASES))
def test_stream_plain_matches_jax_dense(name):
    n, spread, op_range, cam, with_depth = STREAM_CASES[name]
    sd = make_random_splats(np.random.default_rng(20 + len(name)), n=n, spread=spread,
                            sh_degree=0, opacity_range=op_range)
    out_t, _ = _compare(sd, cam(make_camera(W, H).device_params()), rel_grad=1e-3, img_tol=1e-4,
                        with_depth=with_depth)
    if name == "deep_tile":  # the fixture stacks more than 32 instances in a tile
        ts = to_torch_splats(sd)
        proj = _project(ts, to_torch_params(make_camera(W, H).device_params()), tile_size=TILE,
                        projection="ut", exact_tile_test=False)
        a = t_bin(proj, grid_w=4, grid_h=3, instance_cap=8192)
        assert int(a.tile_count.max()) > 32


def test_stream_plain_rolling_rotation_close_to_jax_dense():
    """Inter-frame rotation: the stream's chordal origin deviates from the
    dense path's slerped origins within the JAX test's bounds."""
    sd = make_random_splats(np.random.default_rng(7), n=40, spread=1.0, sh_degree=0)
    _compare(sd, rs_params(make_camera(W, H).device_params(), dx=0.1, rot_deg=2.0),
             rel_grad=5e-2, img_median=(1e-4, 3e-2))


def test_stream_plain_matches_jax_pallas_interpret():
    """Once against the Pallas kernels in interpret mode, forward and VJP in
    one call (10-28 s each here)."""
    sd = make_random_splats(np.random.default_rng(30), n=32, spread=0.8, sh_degree=0)
    _compare(sd, make_camera(W, H).device_params(), rel_grad=5e-2, img_median=(1e-5, 1e-2),
             jax_mode="pallas")


def test_gut_exact_ortho_raises_with_its_roadmap_item():
    """gut_exact with an ORTHO camera renders (the dense route, per-pixel
    origins) what the UT projection renders of the same camera: median
    |difference| below 0.01, alpha max within 10%. The JAX package's exact
    ORTHO frame walks one ray for every pixel (ROADMAP queue 3): on the same
    scene it renders alpha max 0.027 in 2 distinct colours, where its UT
    frame has 0.899 in 1,210."""
    sd_j = make_random_splats(np.random.default_rng(0), n=64)
    j = j_rasterize(sd_j, camera_case("ortho"), jnp.zeros(3), mode="tiles", projection="ut",
                    gut_exact=True, instance_cap=8192, k_max=512)
    assert float(j.alpha.max()) < 0.05
    assert len(np.unique(np.asarray(j.image).reshape(-1, 3), axis=0)) <= 2
    p = to_torch_params(camera_case("ortho"))
    sd = to_torch_splats(sd_j)
    bg = torch.tensor([0.1, 0.2, 0.3])
    with torch.no_grad():
        exact = t_rasterize(sd, p, bg, mode="cuda", projection="ut", gut_exact=True)
        ut = t_rasterize(sd, p, bg, mode="cuda", projection="ut")
    a_ut = float(ut.alpha.max())
    assert a_ut > 0.5, "fixture: nothing rendered"
    assert np.median(np.abs(np_(exact.image) - np_(ut.image))) < 0.01
    assert abs(float(exact.alpha.max()) - a_ut) <= 0.1 * a_ut
    assert len(np.unique(np_(exact.image).reshape(-1, 3), axis=0)) > 500


@pytest.mark.parametrize("rolling", [False, True])
def test_captured_world_inputs_reproduce_the_training_render(rolling):
    """The inputs that rasterize's gut_exact training path builds, captured
    in place of the blend and put through P5 (its plain version here), give
    rasterize's own image; P5's T_final is 1 - alpha, and a pixel has a last
    counted index exactly where it has alpha."""
    sd, cam = random_scene(np.random.default_rng(5), n=120, spread=0.5)
    cam.camera_model = TCameraModelType.OPENCV_FISHEYE
    cam.radial_distortion = FISHEYE_RADIAL
    stream, rays_d, tau, a, kw = world_blend_inputs(sd, cam, "cpu", rolling=rolling,
                                                    instance_cap=8192)
    assert stream.shape[1] == (32 if rolling else 24) and (tau is not None) == rolling
    image, alpha, t_final, last = world_blend_forward(stream, rays_d, tau, a.tile_start,
                                                      a.tile_count, a.gaussian_idx, **kw)
    params = cam.device_params("cpu")
    bg = torch.tensor([0.2, 0.1, 0.4])
    with torch.no_grad():
        out = t_rasterize(sd, rolling_params(params) if rolling else params, bg, mode="cuda",
                          tile_size=16, instance_cap=8192, projection="ut", gut_exact=True)
    h, w = cam.height, cam.width
    assert float(alpha.max()) > 0.01, "fixture: nothing rendered"
    assert torch.equal(image[:h, :w] + (1.0 - alpha[:h, :w, None]) * bg, out.image)
    assert torch.equal(alpha, 1.0 - t_final)
    assert torch.equal(last >= 0, alpha > 0)


@pytest.mark.parametrize("case,tile_size", [("pinhole", 16), ("opencv", 32), ("fisheye", 16),
                                            ("fisheye", 32), ("rolling_tb", 16),
                                            ("fisheye+opaque", 16)])
def test_ray_space_skip_never_drops_a_counted_pair(case, tile_size):
    """The plain mirror of the (warp patch, instance) bound in ray space
    that P5 and P6 share (kernels/world_blend.py::patch_ray_skip_group,
    counted over every tile's whole range by chip_smoke.py::blend_work)
    skips no pair in which a pixel passes the plain alpha test, and does
    skip some, through every camera model of tests/gut_cases.py and a
    rolling shutter. In particular it skips no pair that passes P5's keep
    test before the pixel is done (the forward's own `lost`), and P5's test
    on |y|^2 alone (kernels/world_blend.py::pixel_reject_group) drops no
    pair that passes the alpha test, and does drop some; "+opaque"
    stacks near-opaque gaussians, so that pixels reach the done flag and
    the forward walk ends before the tile's range does."""
    camera, _, opaque = case.partition("+")
    sd = to_torch_splats(make_random_splats(
        np.random.default_rng(40 + tile_size), n=300 if opaque else 60,
        spread=0.5 if opaque else 0.9, sh_degree=0,
        opacity_range=(0.9, 0.99) if opaque else (0.3, 0.95)))
    stream, rays_d, tau, a, kw = capture_world_inputs(sd, to_torch_params(camera_case(camera)),
                                                      tile_size=tile_size, instance_cap=1 << 15)
    r = blend_work(world_groups(stream, rays_d, tau, a, kw), tile_size)
    assert r["lost"] == 0 and r["forward_lost"] == 0 and r["reject_lost"] == 0, r
    assert r["counted"] <= r["forward_full"] < r["forward_kept"], r
    if opaque:  # pixels done before their range ends: the forward walks fewer pairs
        assert r["forward_walked"] < int(a.tile_count.sum()) * tile_size ** 2, r
    assert 0 < r["skipped"] < r["patch_pairs"], r
    assert r["forward_kept"] < r["forward_walked"] and r["counted"] > 0, r
