"""The port's CUDA kernels against their plain PyTorch versions on the same
CUDA tensors. Needs an NVIDIA GPU; skips elsewhere. Imports no JAX, so on
a machine without it run:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from chip_smoke import stream_column_groups
from lichtfeld_studio_tpu_torch.kernels import blend as tblend
from lichtfeld_studio_tpu_torch.kernels import expand as texpand
from lichtfeld_studio_tpu_torch.kernels import segment_reduce as tseg
from lichtfeld_studio_tpu_torch.kernels import world_blend as twb
from lichtfeld_studio_tpu_torch.core.camera import CameraModelType
from lichtfeld_studio_tpu_torch.ops.rasterize import _project, rasterize
from lichtfeld_studio_tpu_torch.ops.tiles import build_tile_assignment, segment_offsets
from tests.torch_parity import (
    EXPAND_CASES,
    assert_expand_equal_on_valid,
    binned_blend_inputs,
    expand_inputs,
    random_scene,
    require_cuda,
    rolling_params,
    world_blend_inputs,
)

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("name", list(EXPAND_CASES))
def test_expand_kernel_matches_plain(name):
    """Exact equality on valid slots, in-bounds g everywhere."""
    dev = require_cuda()
    nt, cap = EXPAND_CASES[name]
    nt, payload = expand_inputs(nt, seed=len(name))
    plain = texpand.expand_instances_plain(torch.from_numpy(nt), torch.from_numpy(payload), cap)
    before = texpand.expand_instances.launches
    out = texpand.expand_instances(
        torch.from_numpy(nt).to(dev), torch.from_numpy(payload).to(dev), cap
    )
    torch.cuda.synchronize()
    assert texpand.expand_instances.launches == before + 1
    assert_expand_equal_on_valid(nt, out, plain, cap)


@pytest.mark.parametrize("n,spread", [(400, 0.8), (600, 0.25)])
@pytest.mark.parametrize("with_depth", [False, True])
def test_blend_kernel_matches_plain(n, spread, with_depth):
    """Within 1e-4: alpha and transmittance follow the plain version's
    operation order; the colour sums run in another order. The second
    scene stacks hundreds of gaussians per tile (early stop, several
    batches)."""
    dev = require_cuda()
    sd, cam = random_scene(np.random.default_rng(n), n=n, spread=spread, device=dev)
    args, kw = binned_blend_inputs(sd, cam, dev, with_depth=with_depth)
    img_p, alpha_p = tblend.blend_forward_plain(*args, **kw)
    before = tblend.blend_forward.launches
    img_k, alpha_k = tblend.blend_forward(*args, **kw)
    torch.cuda.synchronize()
    assert tblend.blend_forward.launches == before + 1
    assert torch.isfinite(img_k).all()
    assert float((img_k - img_p).abs().max()) <= 1e-4
    assert float((alpha_k - alpha_p).abs().max()) <= 1e-4


def test_kernel_render_matches_oracle():
    """The whole binned path on the card against the dense oracle: the
    early stop leaves out < 1/512 per pixel (atol 2.5e-3)."""
    dev = require_cuda()
    sd, cam = random_scene(np.random.default_rng(7), n=300, device=dev)
    params = cam.device_params(dev)
    bg = torch.tensor([0.2, 0.1, 0.4], device=dev)
    with torch.no_grad():
        out_k = rasterize(sd, params, bg, mode="cuda", inference=True, instance_cap=16384)
        out_o = rasterize(sd, params, bg, mode="oracle")
    assert float((out_k.image - out_o.image).abs().max()) <= 2.5e-3
    assert float((out_k.alpha - out_o.alpha).abs().max()) <= 2.5e-3


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    dev = require_cuda()
    sd, cam = random_scene(np.random.default_rng(3), n=50, device=dev)
    args, kw = binned_blend_inputs(sd, cam, dev)
    with pytest.raises(ValueError):
        tblend.blend_forward(*args, **{**kw, "tile_size": 8})
    with pytest.raises(ValueError):  # tensors on two devices
        tblend.blend_forward(*args[:3], args[3].cpu(), *args[4:], **kw)


def _train_inputs(seed, n, spread, tile_size, dev):
    """A scene binned for training (exact sort, slot layout, segments)."""
    sd, cam = random_scene(np.random.default_rng(seed), n=n, spread=spread, device=dev)
    with torch.no_grad():
        proj = _project(sd, cam.device_params(dev), tile_size=tile_size)
        gw, gh = -(-cam.width // tile_size), -(-cam.height // tile_size)
        a = build_tile_assignment(proj, grid_w=gw, grid_h=gh, instance_cap=16384, need_grad=True)
    args = (a.tile_start, a.tile_count, a.gaussian_idx, proj.mean2d, proj.conic,
            proj.opacity, proj.color)
    return a, args, dict(grid_w=gw, grid_h=gh, tile_size=tile_size)


SCENES = [(400, 0.8), (600, 0.25)]  # the second stacks hundreds per tile


@pytest.mark.parametrize("tile_size", [16, 32])
@pytest.mark.parametrize("n,spread", SCENES)
def test_blend_train_kernel_matches_plain(n, spread, tile_size):
    """The training variant (no early stop) within 1e-4, the last counted
    index exactly equal."""
    dev = require_cuda()
    _, args, kw = _train_inputs(n, n, spread, tile_size, dev)
    plain = tblend.blend_forward_plain(*args, **kw, train=True)
    before = tblend.blend_forward.launches
    kern = tblend.blend_forward(*args, **kw, train=True)
    torch.cuda.synchronize()
    assert tblend.blend_forward.launches == before + 1
    for k, p in zip(kern[:3], plain[:3]):
        assert torch.isfinite(k).all()
        assert float((k - p).abs().max()) <= 1e-4
    assert torch.equal(kern[3], plain[3])


@pytest.mark.parametrize("tile_size", [16, 32])
@pytest.mark.parametrize("n,spread", SCENES)
def test_blend_backward_kernel_matches_plain(n, spread, tile_size):
    """Per-instance rows (slot order) of P3 against autograd through the
    plain blend, per column group within 1e-4 of the group's largest
    gradient (sums over pixels in another order)."""
    dev = require_cuda()
    a, args, kw = _train_inputs(n + 1, n, spread, tile_size, dev)
    _, _, t_final, last = tblend.blend_forward(*args, **kw, train=True)
    gen = torch.Generator(device=dev).manual_seed(n)
    d_image = torch.randn(t_final.shape + (3,), generator=gen, device=dev)
    d_alpha = torch.randn(t_final.shape, generator=gen, device=dev)
    bwd = (args[0], args[1], args[2], a.slot_layout, *args[3:], t_final, last, d_image, d_alpha)
    plain = tblend.blend_backward_plain(*bwd, **kw)
    before = tblend.blend_backward.launches
    rows = tblend.blend_backward(*bwd, **kw)
    torch.cuda.synchronize()
    assert tblend.blend_backward.launches == before + 1
    assert torch.isfinite(rows).all()
    for cols in (slice(0, 2), slice(2, 5), slice(5, 6), slice(6, 9)):
        scale = float(plain[:, cols].abs().max())
        assert scale > 0
        assert float((rows[:, cols] - plain[:, cols]).abs().max()) <= 1e-4 * scale, cols


@pytest.mark.parametrize("name", list(EXPAND_CASES))
def test_segment_reduce_kernel_matches_plain(name):
    """Within 1e-5 of the largest sum (float32 warp sums against a float64
    prefix difference); overflow-dropped slots contribute nothing."""
    dev = require_cuda()
    nt, cap = EXPAND_CASES[name]
    rows = torch.from_numpy(np.random.default_rng(len(name)).normal(size=(cap, 10))
                            .astype(np.float32)).to(dev)
    off = segment_offsets(torch.from_numpy(np.asarray(nt, np.int32)).to(dev), cap)
    plain = tseg.segment_reduce_plain(rows, off)
    before = tseg.segment_reduce.launches
    out = tseg.segment_reduce(rows, off)
    torch.cuda.synchronize()
    assert tseg.segment_reduce.launches == before + 1
    assert float((out - plain).abs().max()) <= 1e-5 * max(float(plain.abs().max()), 1.0)


@pytest.mark.parametrize("tile_size", [16, 32])
def test_kernel_gradients_match_oracle(tile_size):
    """rasterize(mode="cuda") on the card (P1, P2, P3, P4) against autograd
    through the dense oracle: every parameter group within 1e-4 of its
    largest gradient, finite on every slot."""
    dev = require_cuda()
    sd, cam = random_scene(np.random.default_rng(11), n=300, spread=0.5, device=dev)
    params = cam.device_params(dev)
    bg = torch.tensor([0.2, 0.1, 0.4], device=dev)
    target = torch.rand((cam.height, cam.width, 3), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    grads = {}
    for mode in ("oracle", "cuda"):
        out = rasterize(sd, params, bg, mode=mode, tile_size=tile_size, instance_cap=16384)
        loss = ((out.image - target) ** 2).mean() + 0.1 * out.alpha.mean()
        grads[mode] = torch.autograd.grad(loss, list(sd.trainable_dict().values()))
    for name, g_k, g_o in zip(sd.trainable_dict(), grads["cuda"], grads["oracle"]):
        assert torch.isfinite(g_k).all(), name
        assert float((g_k - g_o).abs().max()) <= 1e-4 * float(g_o.abs().max()), name


@pytest.mark.parametrize("n_columns", [23, 32])
def test_segment_reduce_kernel_wide_rows(n_columns):
    """The 32-wide P4 instance (the world blend's rows) within 1e-5 of the
    largest sum."""
    dev = require_cuda()
    nt, cap = EXPAND_CASES["interleaved_zero_floods"]
    rows = torch.from_numpy(np.random.default_rng(n_columns).normal(size=(cap, n_columns))
                            .astype(np.float32)).to(dev)
    off = segment_offsets(torch.from_numpy(np.asarray(nt, np.int32)).to(dev), cap)
    plain = tseg.segment_reduce_plain(rows, off)
    out = tseg.segment_reduce(rows, off)
    torch.cuda.synchronize()
    assert float((out - plain).abs().max()) <= 1e-5 * float(plain.abs().max())


WORLD_CASES = [  # (tile_size, rolling, with_depth)
    (16, False, False), (32, False, True), (16, True, True), (32, True, False),
]


@pytest.mark.parametrize("tile_size,rolling,with_depth", WORLD_CASES)
def test_world_blend_kernels_match_plain(tile_size, rolling, with_depth):
    """P5 within 1e-4 of its plain version with the last counted index
    equal; P6 -> P4 within 1e-4 of the largest plain gradient per group."""
    dev = require_cuda()
    sd, cam = random_scene(np.random.default_rng(tile_size), n=400, spread=0.5, device=dev)
    inputs = world_blend_inputs(sd, cam, dev, tile_size=tile_size, rolling=rolling,
                                with_depth=with_depth)
    stream, rays_d, tau, a, kw = inputs
    fwd = (stream, rays_d, tau, a.tile_start, a.tile_count, a.gaussian_idx)
    plain = twb.world_blend_forward_plain(*fwd, **kw)
    before = twb.world_blend_forward.launches
    kern = twb.world_blend_forward(*fwd, **kw)
    torch.cuda.synchronize()
    assert twb.world_blend_forward.launches == before + 1
    for k, p in zip(kern[:3], plain[:3]):
        assert torch.isfinite(k).all()
        assert float((k - p).abs().max()) <= 1e-4
    assert torch.equal(kern[3], plain[3])

    gen = torch.Generator(device=dev).manual_seed(tile_size)
    d_image = torch.randn(kern[0].shape, generator=gen, device=dev)
    d_alpha = torch.randn(kern[1].shape, generator=gen, device=dev)
    bwd = (*fwd, a.slot_layout, kern[2], kern[3], d_image, d_alpha)
    grid = {k: kw[k] for k in ("grid_w", "grid_h", "tile_size")}
    g_p = tseg.segment_reduce(twb.world_blend_backward_plain(*bwd, **grid), a.segment_off)
    before = twb.world_blend_backward.launches
    g_k = tseg.segment_reduce(twb.world_blend_backward(*bwd, **grid), a.segment_off)
    torch.cuda.synchronize()
    assert twb.world_blend_backward.launches == before + 1
    assert torch.isfinite(g_k).all()
    for cols in stream_column_groups(stream.shape[1], with_depth):
        scale = float(g_p[:, cols].abs().max())
        assert scale > 0, cols
        assert float((g_k[:, cols] - g_p[:, cols]).abs().max()) <= 1e-4 * scale, cols


GUT_CAMERAS = {  # camera model, radial, tangential
    "fisheye": (CameraModelType.OPENCV_FISHEYE, [0.08, -0.01, 0.0, 0.0], []),
    "opencv": (CameraModelType.OPENCV_PINHOLE, [0.1, -0.05, 0.01, 0.02, -0.01, 0.005],
               [0.001, -0.002]),
    "pinhole": (CameraModelType.PINHOLE, [], []),
}


@pytest.mark.parametrize("model,rolling", [("fisheye", False), ("fisheye", True),
                                           ("opencv", False), ("pinhole", True)])
def test_gut_exact_kernel_gradients_match_oracle(model, rolling):
    """rasterize(mode="cuda", gut_exact=True) on the card (P1, P5, P6, P4)
    against autograd through the dense world oracle, for the fisheye,
    OpenCV and pinhole models and a translation-only rolling shutter:
    within 1e-3 of the largest gradient per parameter group (the stream
    form against the dense form)."""
    dev = require_cuda()
    sd, cam = random_scene(np.random.default_rng(12), n=300, spread=0.5, device=dev)
    cam.camera_model, radial, tangential = GUT_CAMERAS[model]
    cam.radial_distortion = np.array(radial, np.float32)
    cam.tangential_distortion = np.array(tangential, np.float32)
    params = cam.device_params(dev)
    if rolling:
        params = rolling_params(params, dx=0.2)
    bg = torch.tensor([0.2, 0.1, 0.4], device=dev)
    target = torch.rand((cam.height, cam.width, 3), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    grads = {}
    for mode in ("oracle", "cuda"):
        out = rasterize(sd, params, bg, mode=mode, tile_size=16, instance_cap=1 << 16,
                        projection="ut", gut_exact=True)
        loss = ((out.image - target) ** 2).mean() + 0.1 * out.alpha.mean()
        grads[mode] = torch.autograd.grad(loss, list(sd.trainable_dict().values()), allow_unused=True)
    for name, g_k, g_o in zip(sd.trainable_dict(), grads["cuda"], grads["oracle"]):
        assert torch.isfinite(g_k).all(), name
        assert float((g_k - g_o).abs().max()) <= 1e-3 * float(g_o.abs().max()), name
