"""The port's CUDA kernels against their plain PyTorch versions on the same
CUDA tensors. Needs an NVIDIA GPU; skips elsewhere. Imports no JAX, so on
a machine without it run:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from lichtfeld_studio_tpu_torch.kernels import blend as tblend
from lichtfeld_studio_tpu_torch.kernels import expand as texpand
from lichtfeld_studio_tpu_torch.kernels import projection as tproj
from lichtfeld_studio_tpu_torch.kernels import segment_reduce as tseg
from lichtfeld_studio_tpu_torch.kernels import ut_projection as tut
from lichtfeld_studio_tpu_torch.kernels import world_blend as twb
from lichtfeld_studio_tpu_torch.core.camera import CameraModelType
from lichtfeld_studio_tpu_torch.ops.projection import project_gaussians
from lichtfeld_studio_tpu_torch.ops.rasterize import _project, rasterize
from lichtfeld_studio_tpu_torch.ops.tiles import build_tile_assignment, pack_payload, segment_offsets
from lichtfeld_studio_tpu_torch.ops.ut_projection import project_gaussians_ut
from lichtfeld_studio_tpu_torch.tools.checks import (PROJ_GRAD_REL, PROJ_ULP, bits_equal,
                                                     blend_work, stream_column_groups, ulp_diff,
                                                     world_groups)
from tests.torch_parity import (
    EXPAND_CASES,
    PROJECTION_CASES,
    PROJECTION_ILL_CONDITIONED,
    TorchSplatData,
    SEGMENT_CASES,
    UT_CAMERA_MODELS,
    SEGMENT_COLUMNS,
    assert_expand_equal_on_valid,
    binned_blend_inputs,
    crafted_blend_inputs,
    deep_blend_inputs,
    expand_inputs,
    golden_camera,
    golden_splats,
    overfit_single_view,
    projection_case_id,
    projection_inputs,
    projection_output_grads,
    random_scene,
    require_cuda,
    rolling_params,
    segment_inputs,
    ut_camera_kwargs,
    world_blend_inputs,
)

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("name", list(EXPAND_CASES))
def test_expand_kernel_matches_plain(name):
    """Exact equality on valid slots, in-bounds g everywhere; and on every
    slot the plain mirror of the kernel's merge-path partition
    (kernels/expand.py::expand_partition_plain), whose CPU tests hold it
    against the plain version."""
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
    mirror = texpand.expand_partition_plain(torch.from_numpy(nt), torch.from_numpy(payload), cap)
    for k, m in zip(out, mirror):
        assert torch.equal(k.cpu(), m)


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
    index and the tail trim's tile_neff exactly equal."""
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
    assert torch.equal(kern[4], plain[4])


@pytest.mark.parametrize("tile_size", [16, 32])
@pytest.mark.parametrize("n,spread", SCENES)
def test_blend_backward_kernel_matches_plain(n, spread, tile_size):
    """Per-instance rows (slot order) of P3 against autograd through the
    plain blend, per column group within 1e-4 of the group's largest
    gradient (sums over pixels in another order)."""
    dev = require_cuda()
    a, args, kw = _train_inputs(n + 1, n, spread, tile_size, dev)
    _, _, t_final, last, tile_neff = tblend.blend_forward(*args, **kw, train=True)
    gen = torch.Generator(device=dev).manual_seed(n)
    d_image = torch.randn(t_final.shape + (3,), generator=gen, device=dev)
    d_alpha = torch.randn(t_final.shape, generator=gen, device=dev)
    bwd = (args[0], args[1], args[2], a.slot_layout, *args[3:], t_final, last, tile_neff, d_image,
           d_alpha)
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
def test_kernel_gradients_match_oracle(tile_size, monkeypatch):
    """rasterize(mode="cuda") on the card (P1, P2, P3, P4) against autograd
    through the dense oracle: every parameter group within 1e-4 of its
    largest gradient, finite on every slot. With the tail trim off (eps 0):
    the oracle is the exact gradient."""
    monkeypatch.setattr(tblend, "GRAD_SKIP_EPS", 0.0)
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


@pytest.mark.parametrize("scale", [1, 40])
@pytest.mark.parametrize("n_columns", SEGMENT_COLUMNS)
@pytest.mark.parametrize("name", list(SEGMENT_CASES))
def test_segment_reduce_kernel_block_and_chunk_cases(name, n_columns, scale):
    """The table of tests/torch_parity.py on the card, as it stands and
    with its gaussians repeated 40 times (many blocks): a segment over
    several chunks, empty ranges, a flat tail, block edges, one gaussian;
    every template width and the run-time one. Within 1e-5 of the largest
    sum, and the same launch twice gives the same bits."""
    dev = require_cuda()
    rows, nt, cap = segment_inputs(name, n_columns, scale)
    rows = torch.from_numpy(rows).to(dev)
    off = segment_offsets(torch.from_numpy(nt).to(dev), cap)
    plain = tseg.segment_reduce_plain(rows, off)
    out = tseg.segment_reduce(rows, off)
    torch.cuda.synchronize()
    assert out.shape == plain.shape
    assert float((out - plain).abs().max()) <= 1e-5 * max(float(plain.abs().max()), 1.0)
    assert torch.equal(out, tseg.segment_reduce(rows, off))


@pytest.mark.parametrize("n_ch", [3, 4])
@pytest.mark.parametrize("tile_size", [16, 32])
@pytest.mark.parametrize("kind", ["large", "tiny", "patch_edge", "clamped", "elongated"])
def test_blend_backward_kernel_reach_and_patches(kind, tile_size, n_ch):
    """P3's warp patches and reach skip on gaussians made for them: larger
    than a tile, smaller than a patch, centred on patch edges, clamped at
    alpha 0.999, thin and turned. Rows within 1e-4 of the largest plain
    gradient per column group; the same launch twice gives the same bits."""
    dev = require_cuda()
    args, slot_layout, kw = crafted_blend_inputs(kind, tile_size, n_ch, dev)
    bwd = _check_backward_on_crafted(kind, args, slot_layout, kw, dev)
    stats = tblend.blend_backward_skip_stats(*bwd, **kw)
    assert 0 <= stats["skipped"] + stats["reduced"] <= stats["warp_pairs"]
    if kind == "tiny":  # at most four of a tile's eight patches are in reach
        assert stats["skipped"] >= stats["warp_pairs"] // 2
    if kind == "large":  # every patch is
        assert stats["skipped"] == 0


def _check_backward_on_crafted(kind, args, slot_layout, kw, dev):
    """P3 against its plain version on crafted_blend_inputs, and twice for
    the same bits; returns blend_backward's arguments."""
    n_ch, tile_size = args[6].shape[1], kw["tile_size"]
    image, _, t_final, last, tile_neff = tblend.blend_forward(*args, **kw, train=True)
    plain_fwd = tblend.blend_forward_plain(*args, **kw, train=True)
    assert torch.equal(last, plain_fwd[3]) and torch.equal(tile_neff, plain_fwd[4])
    if kind == "clamped":
        assert float(t_final.min()) < 1e-2  # the clamp was reached
    gen = torch.Generator(device=dev).manual_seed(tile_size + n_ch)
    d_image = torch.randn(image.shape, generator=gen, device=dev)
    d_alpha = torch.randn(t_final.shape, generator=gen, device=dev)
    bwd = (*args[:3], slot_layout, *args[3:], t_final, last, tile_neff, d_image, d_alpha)
    plain = tblend.blend_backward_plain(*bwd, **kw)
    rows = tblend.blend_backward(*bwd, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(rows).all()
    for cols in (slice(0, 2), slice(2, 5), slice(5, 6), slice(6, 6 + n_ch)):
        scale = float(plain[:, cols].abs().max())
        assert scale > 0
        assert float((rows[:, cols] - plain[:, cols]).abs().max()) <= 1e-4 * scale, cols
    assert torch.equal(rows, tblend.blend_backward(*bwd, **kw))
    return bwd


@pytest.mark.parametrize("tile_size,size", [(16, 448), (32, 704)])
def test_blend_backward_kernel_heaviest_tile_first(tile_size, size):
    """More tiles (784, 484) than the card holds blocks at once (396 on an
    H100), so P3 ranks them by count first: uneven counts with ties and
    empty tiles, every slot written once, rows as the plain version's."""
    dev = require_cuda()
    args, slot_layout, kw = crafted_blend_inputs("large", tile_size, 3, dev, size=size,
                                                  uneven=True)
    count = args[1]
    assert kw["grid_w"] * kw["grid_h"] > 396 and int((count == 0).sum()) > 50
    assert count.unique().numel() < count.numel()
    _check_backward_on_crafted("large", args, slot_layout, kw, dev)


@pytest.mark.parametrize("tile_size", [16, 32])
def test_blend_backward_kernel_is_deterministic(tile_size):
    """Two launches on equal inputs give bit-equal rows (fixed-order sums,
    no float atomics), on a scene that stacks hundreds per tile."""
    dev = require_cuda()
    a, args, kw = _train_inputs(5, 600, 0.25, tile_size, dev)
    _, _, t_final, last, tile_neff = tblend.blend_forward(*args, **kw, train=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    d_image = torch.randn(t_final.shape + (3,), generator=gen, device=dev)
    d_alpha = torch.randn(t_final.shape, generator=gen, device=dev)
    bwd = (args[0], args[1], args[2], a.slot_layout, *args[3:], t_final, last, tile_neff, d_image,
           d_alpha)
    first = tblend.blend_backward(*bwd, **kw)
    assert torch.equal(first, tblend.blend_backward(*bwd, **kw))
    sums = tseg.segment_reduce(first, a.segment_off)
    assert torch.equal(sums, tseg.segment_reduce(first, a.segment_off))


@pytest.mark.parametrize("eps", [0.0, 1.0 / 255.0], ids=["full_replay", "trim"])
@pytest.mark.parametrize("tile_size", [16, 32])
def test_blend_trim_on_deep_tiles(tile_size, eps, monkeypatch):
    """The tail trim on tests/torch_parity.py::deep_blend_inputs (tiles off
    the windows' grid, one whose walk ends in mid-window): P2-train's
    tile_neff equal to the plain version's (FULL_REPLAY everywhere at eps
    0, fewer windows than the tile has somewhere at 1/255); P3 against the
    plain trimmed backward within 1e-4 of the largest plain gradient per
    column group, the trimmed rows 0, the same bits twice; at eps 0 the
    rows are P3's at tile_neff = FULL_REPLAY to the bit."""
    dev = require_cuda()
    monkeypatch.setattr(tblend, "GRAD_SKIP_EPS", eps)
    args, slot_layout, kw = deep_blend_inputs(tile_size, dev)
    kern = tblend.blend_forward(*args, **kw, train=True)
    plain = tblend.blend_forward_plain(*args, **kw, train=True)
    torch.cuda.synchronize()
    assert torch.equal(kern[3], plain[3]) and torch.equal(kern[4], plain[4]), (kern[4], plain[4])
    windows = (args[0].long() % 128 + args[1].long() + 127) // 128
    if eps == 0.0:
        assert (kern[4] == tblend.FULL_REPLAY).all()
    else:
        assert (kern[4].long() < windows).any()
    gen = torch.Generator(device=dev).manual_seed(tile_size)
    d_image = torch.randn(kern[0].shape, generator=gen, device=dev)
    d_alpha = torch.randn(kern[1].shape, generator=gen, device=dev)
    bwd = (*args[:3], slot_layout, *args[3:], kern[2], kern[3], kern[4], d_image, d_alpha)
    rows_p = tblend.blend_backward_plain(*bwd, **kw)
    rows = tblend.blend_backward(*bwd, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(rows).all()
    for cols in (slice(0, 2), slice(2, 5), slice(5, 6), slice(6, 9)):
        scale = float(rows_p[:, cols].abs().max())
        assert scale > 0
        assert float((rows[:, cols] - rows_p[:, cols]).abs().max()) <= 1e-4 * scale, cols
    assert torch.equal(rows, tblend.blend_backward(*bwd, **kw))
    full = torch.full_like(kern[4], tblend.FULL_REPLAY)
    rows_full = tblend.blend_backward(*bwd[:10], full, *bwd[11:], **kw)
    if eps == 0.0:
        assert torch.equal(rows, rows_full)
    else:  # the trimmed rows are 0, and were not all 0 before
        tail = tblend.trim_tail_slots(args[0], args[1], kern[4], slot_layout)
        assert rows[tail].abs().max() == 0 and rows_full[tail].abs().max() > 0
        stats = tblend.blend_backward_skip_stats(*bwd, **kw)
        assert stats["trimmed_pairs"] > 0 and stats["trimmed_instances"] == tail.numel()


def _check_forward_on_crafted(args, kw, train):
    """P2 against its plain version on crafted_blend_inputs (image, alpha
    and T_final within 1e-4, `last` equal) and its reach skip (no pair that
    would pass the alpha test inside a skipped one); returns the counts."""
    plain = tblend.blend_forward_plain(*args, **kw, train=train)
    before = tblend.blend_forward.launches
    kern = tblend.blend_forward(*args, **kw, train=train)
    torch.cuda.synchronize()
    assert tblend.blend_forward.launches == before + 1
    assert torch.isfinite(kern[0]).all()
    for k, p in zip(kern[:3], plain[:3]):
        assert float((k - p).abs().max()) <= 1e-4
    if train:
        assert torch.equal(kern[3], plain[3]) and torch.equal(kern[4], plain[4])
    for k, again in zip(kern, tblend.blend_forward(*args, **kw, train=train)):
        assert torch.equal(k, again)
    stats = tblend.blend_forward_skip_stats(*args, **kw, train=train)
    assert stats["lost"] == 0 and 0 <= stats["skipped"] <= stats["warp_pairs"], stats
    return stats


@pytest.mark.parametrize("train", [False, True], ids=["inference", "training"])
@pytest.mark.parametrize("n_ch", [3, 4])
@pytest.mark.parametrize("tile_size", [16, 32])
@pytest.mark.parametrize("kind", ["large", "tiny", "patch_edge", "clamped", "elongated",
                                  "ill_conditioned"])
def test_blend_forward_kernel_reach_and_patches(kind, tile_size, n_ch, train):
    """P2's warp patches, reach skip and two batch slots on gaussians made for
    them: larger than a tile, smaller than a patch, centred on patch edges,
    clamped at alpha 0.999, thin and turned, with conics near singular,
    indefinite or not finite. The image within 1e-4 of the plain version's,
    the last counted index equal, the same bits twice."""
    dev = require_cuda()
    args, _, kw = crafted_blend_inputs(kind, tile_size, n_ch, dev)
    stats = _check_forward_on_crafted(args, kw, train)
    if kind == "tiny":  # at most four of a tile's eight patches are in reach
        assert stats["skipped"] >= stats["warp_pairs"] // 2
    if kind == "large":  # every patch is
        assert stats["skipped"] == 0


@pytest.mark.parametrize("train", [False, True], ids=["inference", "training"])
@pytest.mark.parametrize("tile_size,size", [(16, 448), (32, 768)])
def test_blend_forward_kernel_heaviest_tile_first(tile_size, size, train):
    """More tiles (784, 576) than the card holds P2's blocks at once (528 on
    an H100), so P2 ranks them by count first; several batches of 256 in
    the deeper tiles (the second batch slot); uneven counts with ties and
    empty tiles."""
    dev = require_cuda()
    args, _, kw = crafted_blend_inputs("large", tile_size, 3, dev, size=size, n=600, uneven=True)
    count = args[1]
    assert kw["grid_w"] * kw["grid_h"] > 528 and int((count == 0).sum()) > 50
    assert int(count.max()) > 2 * 256
    _check_forward_on_crafted(args, kw, train)


def _crafted_world_scene(kind, dev, n=120, width=128, height=96):
    """Port splats made for P6's patches and ray-space skip, and a fisheye
    camera (OpenCV fisheye, radial (0.08, -0.01)) looking at them: larger
    than a tile, smaller than a patch, thin and turned, clamped at alpha
    0.999, or spread to the image's edge and past it."""
    from lichtfeld_studio_tpu_torch.core.camera import look_at_camera

    rng = np.random.default_rng(len(kind) + 100)
    quat = rng.normal(size=(n, 4)).astype(np.float32)
    means = rng.uniform(-0.8, 0.8, (n, 3))
    op = rng.uniform(0.3, 0.95, n)
    scales = {"large": lambda: rng.uniform(0.5, 1.2, (n, 3)),
              "tiny": lambda: rng.uniform(0.01, 0.03, (n, 3)),
              "clamped": lambda: rng.uniform(0.1, 0.3, (n, 3)),
              "edge": lambda: rng.uniform(0.05, 0.3, (n, 3))}.get(
        kind, lambda: np.stack([rng.uniform(0.3, 0.8, n), rng.uniform(0.01, 0.02, n),
                                rng.uniform(0.01, 0.02, n)], -1))()
    if kind == "clamped":
        op = np.full(n, 0.99995)
    if kind == "edge":  # view angles up to ~70 degrees: the fisheye's rim and beyond
        means = np.stack([rng.uniform(-9, 9, n), rng.uniform(-7, 7, n), rng.uniform(-1, 1, n)], -1)
    sd = TorchSplatData.from_arrays(
        means.astype(np.float32), rng.normal(0, 1, (n, 1, 3)).astype(np.float32),
        np.zeros((n, 0, 3), np.float32), np.log(scales).astype(np.float32),
        quat / np.linalg.norm(quat, axis=1, keepdims=True),
        np.log(op / (1 - op)).astype(np.float32)[:, None], device=dev)
    cam = look_at_camera(np.array([0.0, 0.0, -4.0]), np.zeros(3), np.array([0.0, -1.0, 0.0]),
                         60.0, 60.0, width, height)
    cam.camera_model = CameraModelType.OPENCV_FISHEYE
    cam.radial_distortion = np.array([0.08, -0.01, 0.0, 0.0], np.float32)
    return sd, cam


@pytest.mark.parametrize("with_depth", [False, True], ids=["3ch", "4ch"])
@pytest.mark.parametrize("rolling", [False, True], ids=["global", "rolling"])
@pytest.mark.parametrize("tile_size", [16, 32])
@pytest.mark.parametrize("kind", ["large", "tiny", "elongated", "clamped", "edge"])
def test_world_blend_backward_kernel_patches_and_ray_skip(kind, tile_size, rolling, with_depth):
    """P6's warp patches and ray-space skip on gaussians made for them,
    through a fisheye camera, global and rolling shutters: rows through P4
    within 1e-4 of the largest plain gradient per group, no pixel that P5
    counted inside a skipped (warp, instance) pair (the kernel's counting
    instance and the plain mirror of its bound), the same bits twice."""
    dev = require_cuda()
    sd, cam = _crafted_world_scene(kind, dev)
    stream, rays_d, tau, a, kw = world_blend_inputs(sd, cam, dev, tile_size=tile_size,
                                                    rolling=rolling, with_depth=with_depth)
    fwd = (stream, rays_d, tau, a.tile_start, a.tile_count, a.gaussian_idx)
    kern = twb.world_blend_forward(*fwd, **kw)
    plain_fwd = twb.world_blend_forward_plain(*fwd, **kw)
    assert torch.equal(kern[3], plain_fwd[3])
    if kind == "clamped":
        assert float(kern[2].min()) < 1e-2  # the clamp was reached
    gen = torch.Generator(device=dev).manual_seed(tile_size + 2 * rolling)
    d_image = torch.randn(kern[0].shape, generator=gen, device=dev)
    d_alpha = torch.randn(kern[1].shape, generator=gen, device=dev)
    bwd = (*fwd, a.slot_layout, kern[2], kern[3], d_image, d_alpha)
    grid = {k: kw[k] for k in ("grid_w", "grid_h", "tile_size")}
    g_p = tseg.segment_reduce(twb.world_blend_backward_plain(*bwd, **grid), a.segment_off)
    rows = twb.world_blend_backward(*bwd, **grid)
    g_k = tseg.segment_reduce(rows, a.segment_off)
    torch.cuda.synchronize()
    assert torch.isfinite(g_k).all()
    for cols in stream_column_groups(stream.shape[1], with_depth):
        scale = float(g_p[:, cols].abs().max())
        assert scale > 0, cols
        assert float((g_k[:, cols] - g_p[:, cols]).abs().max()) <= 1e-4 * scale, cols
    assert torch.equal(rows, twb.world_blend_backward(*bwd, **grid))
    stats = twb.world_blend_backward_skip_stats(*bwd, **grid)
    mirror = blend_work(world_groups(stream, rays_d, tau, a, kw), tile_size)
    assert stats["lost"] == 0 and mirror["lost"] == 0, (stats, mirror)
    assert 0 <= stats["skipped"] + stats["reduced"] <= stats["warp_pairs"]
    if kind == "tiny":  # most patches are out of a tiny gaussian's reach
        assert stats["skipped"] > 0 and mirror["skipped"] >= mirror["patch_pairs"] // 2, stats


def test_world_blend_backward_kernel_heaviest_tile_first():
    """More tiles (1,200 at 16 px) than the card holds P6's blocks at once
    (264 on an H100): ranked by count first, rows as the plain version's
    and the same bits twice."""
    dev = require_cuda()
    sd, cam = _crafted_world_scene("edge", dev, n=800, width=640, height=480)
    stream, rays_d, tau, a, kw = world_blend_inputs(sd, cam, dev, tile_size=16,
                                                    instance_cap=1 << 18)
    assert kw["grid_w"] * kw["grid_h"] > 264
    fwd = (stream, rays_d, tau, a.tile_start, a.tile_count, a.gaussian_idx)
    kern = twb.world_blend_forward(*fwd, **kw)
    gen = torch.Generator(device=dev).manual_seed(3)
    bwd = (*fwd, a.slot_layout, kern[2], kern[3], torch.randn(kern[0].shape, generator=gen,
                                                               device=dev),
           torch.randn(kern[1].shape, generator=gen, device=dev))
    grid = {k: kw[k] for k in ("grid_w", "grid_h", "tile_size")}
    g_p = tseg.segment_reduce(twb.world_blend_backward_plain(*bwd, **grid), a.segment_off)
    rows = twb.world_blend_backward(*bwd, **grid)
    g_k = tseg.segment_reduce(rows, a.segment_off)
    for cols in stream_column_groups(stream.shape[1], False):
        scale = float(g_p[:, cols].abs().max())
        assert float((g_k[:, cols] - g_p[:, cols]).abs().max()) <= 1e-4 * scale, cols
    assert torch.equal(rows, twb.world_blend_backward(*bwd, **grid))


def _check_world_forward(fwd, kw):
    """P5 against its plain version (image, alpha and T_final within 1e-4,
    `last` equal), the same bits twice, and its counting instance (no
    pixel, not yet done, inside a skipped (warp, instance) pair whose
    evaluation passes the keep test); returns the outputs and the counts."""
    plain = twb.world_blend_forward_plain(*fwd, **kw)
    before = twb.world_blend_forward.launches
    kern = twb.world_blend_forward(*fwd, **kw)
    torch.cuda.synchronize()
    assert twb.world_blend_forward.launches == before + 1
    for k, p in zip(kern[:3], plain[:3]):
        assert torch.isfinite(k).all()
        assert float((k - p).abs().max()) <= 1e-4
    assert torch.equal(kern[3], plain[3])
    for k, again in zip(kern, twb.world_blend_forward(*fwd, **kw)):
        assert torch.equal(k, again)
    stats = twb.world_blend_forward_skip_stats(*fwd, **kw)
    assert stats["lost"] == 0 and 0 <= stats["skipped"] <= stats["warp_pairs"], stats
    return kern, stats


@pytest.mark.parametrize("with_depth", [False, True], ids=["3ch", "4ch"])
@pytest.mark.parametrize("rolling", [False, True], ids=["global", "rolling"])
@pytest.mark.parametrize("tile_size", [16, 32])
@pytest.mark.parametrize("kind", ["large", "tiny", "elongated", "clamped", "edge"])
def test_world_blend_forward_kernel_patches_and_ray_skip(kind, tile_size, rolling, with_depth):
    """P5's warp patches, ray-space skip and warp exit on the gaussians made
    for P6's (a fisheye camera, global and rolling shutters, 3 and 4
    channels): within 1e-4 of the plain version with `last` equal, the same
    bits twice, some (warp, instance) pairs skipped and no keepable pixel
    inside them (the kernel's counting instance and the plain mirror of
    its bound)."""
    dev = require_cuda()
    sd, cam = _crafted_world_scene(kind, dev)
    stream, rays_d, tau, a, kw = world_blend_inputs(sd, cam, dev, tile_size=tile_size,
                                                    rolling=rolling, with_depth=with_depth)
    fwd = (stream, rays_d, tau, a.tile_start, a.tile_count, a.gaussian_idx)
    kern, stats = _check_world_forward(fwd, kw)
    if kind == "clamped":
        assert float(kern[2].min()) < 1e-2  # the clamp was reached
    assert stats["skipped"] > 0, stats
    mirror = blend_work(world_groups(stream, rays_d, tau, a, kw), tile_size)
    assert mirror["lost"] == 0 and mirror["forward_lost"] == 0, mirror


@pytest.mark.parametrize("rolling", [False, True], ids=["global", "rolling"])
def test_world_blend_forward_kernel_heaviest_tile_first(rolling, tmp_path):
    """More tiles (1,200 at 16 px) than the card holds P5's blocks at once
    (396 on an H100 at three an SM): ranked by count first. The outputs are
    the bits of the same source with the ranking taken out
    (tools/ablate_kernels.py's in_tile_order, built here) and within 1e-4
    of the plain version's."""
    from lichtfeld_studio_tpu_torch.tools import ablate_kernels as ablate

    dev = require_cuda()
    sd, cam = _crafted_world_scene("edge", dev, n=800, width=640, height=480)
    stream, rays_d, tau, a, kw = world_blend_inputs(sd, cam, dev, tile_size=16, rolling=rolling,
                                                    instance_cap=1 << 18)
    assert kw["grid_w"] * kw["grid_h"] > 396
    fwd = (stream, rays_d, tau, a.tile_start, a.tile_count, a.gaussian_idx)
    kern, _ = _check_world_forward(fwd, kw)
    fn = ablate.build_variants(tmp_path, only={(ablate.P5, "in_tile_order")})[
        ablate.P5, "in_tile_order"]
    out = [torch.empty_like(t) for t in kern]
    scratch = torch.empty(kw["grid_w"] * kw["grid_h"], dtype=torch.int32, device=dev)
    err = fn(a.tile_start.data_ptr(), a.tile_count.data_ptr(), a.gaussian_idx.data_ptr(),
             stream.data_ptr(), stream.shape[1], rays_d.data_ptr(),
             tau.data_ptr() if rolling else None, kw["n_channels"], kw["grid_w"], kw["grid_h"],
             kw["tile_size"], *(t.data_ptr() for t in out), scratch.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    for k, o in zip(kern, out):
        assert torch.equal(k, o)


def test_world_blend_forward_kernel_on_the_forward_frame():
    """P5 on the forward frame's own inputs (the inference binning that
    rasterize(inference=True, gut_exact=True) hands it), through a fisheye
    camera: as _check_world_forward."""
    dev = require_cuda()
    from lichtfeld_studio_tpu_torch.ops.rasterize import capture_world_inputs

    sd, cam = random_scene(np.random.default_rng(7), n=400, spread=0.5, device=dev)
    cam.camera_model = CameraModelType.OPENCV_FISHEYE
    cam.radial_distortion = np.array([0.08, -0.01, 0.0, 0.0], np.float32)
    *fwd, kw = capture_world_inputs(sd, cam.device_params(dev), tile_size=32,
                                    instance_cap=1 << 16, inference=True)
    _, stats = _check_world_forward(tuple(fwd), kw)
    assert stats["warp_pairs"] > 0


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


# --- the microbenchmark kernels T1a, T1b, T2, T3 ---

def _slabs(g, lo, hi, seed=0, shape=None):
    from lichtfeld_studio_tpu_torch.kernels import microbench as mb

    gen = torch.Generator().manual_seed(seed)
    shape = shape or (mb.DEPTH, mb.WIDTH)
    return torch.rand((g, *shape), generator=gen) * (hi - lo) + lo


@pytest.mark.parametrize("g,reps", [(1, 2), (3, 64)], ids=["small", "full"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_alu_elementwise_kernel_matches_plain(dtype, g, reps):
    """Equal to the bit: the same operations, rounded after each, in both
    (float32 and bf16); negative inputs take the max(x, 0) branch."""
    from lichtfeld_studio_tpu_torch.kernels import microbench as mb

    dev = require_cuda()
    x = _slabs(g, -0.2, 1.0).to(dev)
    before = mb.alu_elementwise.launches
    out = mb.alu_elementwise(x, dtype=dtype, reps=reps)
    torch.cuda.synchronize()
    assert mb.alu_elementwise.launches == before + 1
    assert torch.equal(out, mb.alu_elementwise_plain(x, dtype=dtype, reps=reps))
    assert torch.equal(out.cpu(), mb.alu_elementwise(x.cpu(), dtype=dtype, reps=reps))


@pytest.mark.parametrize("reps", [0, 1, 2, 3, 64, 65])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_alu_elementwise_kernel_every_instance(dtype, reps):
    """T1a's instances: float32's unrolled ones (2, 64) and the run-time
    loop (bf16 at every count; 0, 1, 3, 65: no repetition, one, a count
    below the unroll of 8 and one past a multiple of it), each equal to
    the plain version to the bit on 2 slabs."""
    from lichtfeld_studio_tpu_torch.kernels import microbench as mb

    dev = require_cuda()
    x = _slabs(2, -0.2, 1.0, seed=reps).to(dev)
    out = mb.alu_elementwise(x, dtype=dtype, reps=reps)
    torch.cuda.synchronize()
    assert torch.equal(out, mb.alu_elementwise_plain(x, dtype=dtype, reps=reps))


def test_alu_elementwise_sass_has_the_four_operations():
    """T1a compiles to its four rounded operations a value (bf16: a pair)
    and repetition, none fused or dropped, and spills nothing: in float32's
    instance unrolled whole and in the run-time loop of both types."""
    from lichtfeld_studio_tpu_torch.tools import microbench_bf16_vpu as t1

    require_cuda()
    sass = t1.alu_sass()
    assert {"f32 reps=64", "f32 reps=0", "bf16 reps=0"} <= set(sass), sass
    for name in ("f32 reps=64", "f32 reps=0", "bf16 reps=0"):
        assert round(sass[name]["per_chain_rep"], 3) == 4.0, (name, sass[name])
    assert all(r["spill_stores"] == 0 and r["spill_loads"] == 0 for r in sass.values()), sass


@pytest.mark.parametrize("g,reps", [(1, 1), (2, 2), (3, 64)], ids=["one_rep", "small", "full"])
@pytest.mark.parametrize("impl", ["reg", "shfl", "smem"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_scan_prod_kernel_matches_plain(dtype, impl, g, reps):
    """Equal to the bit: every mechanism walks the plain version's tree
    (the register form each level in place, descending, so every multiply
    reads the row above before its level writes it). (At 64 repetitions
    every value has underflowed to 0, as the TPU original's does; 1 and 2
    repetitions carry the check.)"""
    from lichtfeld_studio_tpu_torch.kernels import microbench as mb

    dev = require_cuda()
    x = _slabs(g, 0.99, 1.0, seed=reps).to(dev)
    before = mb.scan_prod.launches
    out = mb.scan_prod(x, dtype=dtype, impl=impl, reps=reps)
    torch.cuda.synchronize()
    assert mb.scan_prod.launches == before + 1
    assert torch.equal(out, mb.scan_prod_plain(x, dtype=dtype, reps=reps))
    if reps <= 2:
        assert float(out.min()) > 0


@pytest.mark.parametrize("rows,width,nb,blocks", [
    (8, 128, 64, 1), (1, 1024, 64, 5), (2, 128, 3, 3), (16, 128, 37, 4), (8, 512, 2048, 264),
    (1, 4096, 2048, 1), (8, 128, 8192, 264)])
def test_stream_ring_kernel_matches_plain(rows, width, nb, blocks):
    """1e-5 of the sum of |values|: the kernel adds a block's chunks in
    float32 one after the other, the plain version in float64. Fewer chunks
    than ring slots, ragged last blocks and empty blocks included."""
    from lichtfeld_studio_tpu_torch.kernels import microbench as mb

    dev = require_cuda()
    x = torch.randn((rows, nb * width), generator=torch.Generator().manual_seed(nb)).to(dev)
    before = mb.stream_ring.launches
    out = mb.stream_ring(x, width=width, blocks=blocks)
    torch.cuda.synchronize()
    assert mb.stream_ring.launches == before + 1 and out.shape == (blocks,)
    plain = mb.stream_ring_plain(x, width=width, blocks=blocks)
    scale = float(x[0, ::width].abs().sum())
    assert float((out - plain).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("g,pixels,reps", [(1, 128, 2), (2, 1024, 64)], ids=["small", "full"])
@pytest.mark.parametrize("orient", ["lanes", "thread"])
def test_scan_orient_kernel_matches_plain(orient, g, pixels, reps):
    """lanes: equal to the bit (the plain version's log-step scans).
    thread: 1e-5 of the largest value (torch.cumsum on the card adds in
    another order than the kernel's serial walk). The output and the final
    x of every pixel."""
    from lichtfeld_studio_tpu_torch.kernels import microbench as mb

    dev = require_cuda()
    shape = (pixels, mb.DEPTH) if orient == "lanes" else (mb.DEPTH, pixels)
    x = _slabs(g, 0.1, 0.9, shape=shape).to(dev)
    before = mb.scan_orient.launches
    out, x_final = mb.scan_orient(x, orient=orient, reps=reps)
    torch.cuda.synchronize()
    assert mb.scan_orient.launches == before + 1
    out_p, x_p = mb.scan_orient_plain(x, orient=orient, reps=reps)
    if orient == "lanes":
        assert torch.equal(out, out_p) and torch.equal(x_final, x_p)
    else:
        assert float((out - out_p).abs().max()) <= 1e-5 * float(out_p.abs().max())
        assert float((x_final - x_p).abs().max()) <= 1e-5 * float(x_p.abs().max())


def test_adc_mean2d_gradient_through_p3_matches_oracle(monkeypatch):
    """The ADC step's d loss / d mean2d (P3's rows reduced by P4, one more
    input of the one backward pass) against the dense oracle's: 1e-4 of the
    largest entry, as P3's other gradients. With the tail trim off (eps 0):
    the oracle is the exact gradient."""
    from lichtfeld_studio_tpu_torch.train.state import (
        TrainConfig, compute_grads, init_train_state, make_lrs)

    monkeypatch.setattr(tblend, "GRAD_SKIP_EPS", 0.0)
    dev = require_cuda()
    sd, cam = random_scene(np.random.default_rng(9), n=500, spread=0.6, device=dev)
    gt = torch.rand((cam.height, cam.width, 3), generator=torch.Generator().manual_seed(1)).to(dev)
    state = init_train_state(sd, make_lrs(1.6e-4, 2.5e-3, 5e-3, 1e-3, 0.05, sd.scene_scale))
    grads = {}
    for mode in ("oracle", "cuda"):
        cfg = TrainConfig(raster_mode=mode, strategy="default", tile_size=16, instance_cap=1 << 16)
        grads[mode] = compute_grads(state, cam.device_params(dev), gt, torch.zeros(3, device=dev),
                                    cfg)[2]
    want, got = grads["oracle"]["_mean2d"], grads["cuda"]["_mean2d"]
    assert float(want.abs().max()) > 0 and got.shape == (sd.capacity, 2)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_single_view_overfit_on_the_card():
    """tests/test_torch_overfit_quality.py on the kernels: 250 MCMC steps
    from 256 random points past 20 dB, and the model grows."""
    p0, p1, n = overfit_single_view(require_cuda())
    assert p1 > 20.0, (p0, p1)
    assert n > 256


@pytest.mark.parametrize("tile_size", [16, 32])
def test_golden_kernels_match_plain(tile_size):
    """tests/test_torch_golden_data.py's fixture (39,590 trained gaussians)
    at its full 648x420 geometry: P1 on the projection's counts, P2 in both
    variants, P3 and P4 on its training binning against their plain
    versions at the bounds of the tests above."""
    dev = require_cuda()
    sd = golden_splats(dev)
    cam = golden_camera(648, 420, np.array([0.0, -0.4, -4.2]), 570.0, dev)
    gw, gh = -(-648 // tile_size), -(-420 // tile_size)
    kw = dict(grid_w=gw, grid_h=gh, tile_size=tile_size)
    with torch.no_grad():
        proj = _project(sd, cam, tile_size=tile_size)
        a = build_tile_assignment(proj, grid_w=gw, grid_h=gh, instance_cap=1 << 21)
    assert int(a.n_instances) <= 1 << 21 and int(a.tile_count.max()) > 256
    # P1 on the counts and payload the binning hands it
    nt, payload = proj.n_touched, pack_payload(proj)
    plain = texpand.expand_instances_plain(nt.cpu(), payload.cpu(), 1 << 21)
    out = texpand.expand_instances(nt, payload, 1 << 21)
    assert_expand_equal_on_valid(nt.cpu().numpy(), out, plain, 1 << 21)
    args = (a.tile_start, a.tile_count, a.gaussian_idx, proj.mean2d, proj.conic, proj.opacity,
            proj.color)
    img_p, alpha_p = tblend.blend_forward_plain(*args, **kw)
    img_k, alpha_k = tblend.blend_forward(*args, **kw)
    assert float((img_k - img_p).abs().max()) <= 1e-4
    assert float((alpha_k - alpha_p).abs().max()) <= 1e-4
    train_p = tblend.blend_forward_plain(*args, **kw, train=True)
    train_k = tblend.blend_forward(*args, **kw, train=True)
    for k, p in zip(train_k[:3], train_p[:3]):
        assert float((k - p).abs().max()) <= 1e-4
    assert torch.equal(train_k[3], train_p[3]) and torch.equal(train_k[4], train_p[4])
    _, _, t_final, last, tile_neff = train_k
    gen = torch.Generator(device=dev).manual_seed(tile_size)
    d_image = torch.randn(t_final.shape + (3,), generator=gen, device=dev)
    d_alpha = torch.randn(t_final.shape, generator=gen, device=dev)
    bwd = (args[0], args[1], args[2], a.slot_layout, *args[3:], t_final, last, tile_neff, d_image,
           d_alpha)
    rows_p = tblend.blend_backward_plain(*bwd, **kw)
    rows = tblend.blend_backward(*bwd, **kw)
    for cols in (slice(0, 2), slice(2, 5), slice(5, 6), slice(6, 9)):
        scale = float(rows_p[:, cols].abs().max())
        assert scale > 0
        assert float((rows[:, cols] - rows_p[:, cols]).abs().max()) <= 1e-4 * scale, cols
    sums_p = tseg.segment_reduce_plain(rows_p, a.segment_off)
    sums = tseg.segment_reduce(rows_p, a.segment_off)
    assert float((sums - sums_p).abs().max()) <= 1e-5 * max(float(sums_p.abs().max()), 1.0)


@pytest.mark.parametrize("case", PROJECTION_CASES, ids=projection_case_id)
def test_projection_kernels_match_plain(case):
    """The EWA projection's kernels on the hazard scenes of tests/
    torch_parity.py: the kept set and the tiles bit for bit, the floats
    within checks.PROJ_ULP, two launches bit-equal, the backward within
    PROJ_GRAD_REL of the largest gradient of the closed form
    (project_ewa_backward_plain) and of autograd of the plain path, on the
    card; the gradients of the gaussians float32 does not resolve are not
    asked for."""
    dev = require_cuda()
    n_rest, degree, aa, ts, cap, dilate = case
    args = projection_inputs(11, n=3000, n_rest=n_rest, degree=degree, width=320, height=200,
                             device=dev)
    kw = dict(width=320, height=200, tile_size=ts, antialiasing=aa, exact_tile_cap=cap,
              dilate_px=dilate)
    with torch.no_grad():
        plain = project_gaussians(*args, **kw)
    before = (tproj.project_ewa_forward.launches, tproj.project_ewa_backward.launches)
    kern = tproj.project_ewa_forward(*args, **kw)
    again = tproj.project_ewa_forward(*args, **kw)
    for name in ("valid", "bbox", "n_touched", "tile_mask"):
        assert torch.equal(getattr(kern, name), getattr(plain, name)), name
    assert int(plain.valid.sum()) > 1000
    for name, lim in PROJ_ULP.items():
        assert ulp_diff(getattr(kern, name), getattr(plain, name)) <= lim, name
        assert torch.equal(getattr(kern, name), getattr(again, name)), name
    grads = list(projection_output_grads(12, 3000, device=dev))
    for g in grads:
        g[PROJECTION_ILL_CONDITIONED] = 0.0
    bargs = (*args[:4], args[5], args[7], *args[8:], *grads)
    bkw = dict(width=320, height=200, antialiasing=aa)
    k = tproj.project_ewa_backward(*bargs, **bkw)
    k2 = tproj.project_ewa_backward(*bargs, **bkw)
    assert (tproj.project_ewa_forward.launches, tproj.project_ewa_backward.launches) == (
        before[0] + 2, before[1] + 2)
    mirror = tproj.project_ewa_backward_plain(*bargs, **bkw)
    leaves = [a.clone().requires_grad_(True) for a in args[:6]]
    p = project_gaussians(*leaves, *args[6:], **kw)
    auto = torch.autograd.grad([p.depth, p.mean2d, p.conic, p.opacity, p.color], leaves, grads,
                               allow_unused=True)
    for i, (x, y, m, a) in enumerate(zip(k, k2, mirror, auto)):
        assert torch.equal(x, y) and torch.isfinite(x).all(), i
        for ref in (m, a):
            if ref is None or ref.numel() == 0:
                continue
            assert float((x - ref).abs().max()) <= PROJ_GRAD_REL * float(ref.abs().max()), i


def test_projection_kernels_on_the_training_path(monkeypatch):
    """compute_grads through rasterize on the card takes both kernels, and
    its gradients match the plain path's (the route forced off)."""
    dev = require_cuda()
    from lichtfeld_studio_tpu_torch.ops import rasterize as rast

    sd, cam = random_scene(np.random.default_rng(13), n=3000, device=dev)
    params = cam.device_params(dev)
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)

    def grads():
        out = rasterize(sd, params, bg, mode="cuda", instance_cap=1 << 17, with_depth=True)
        loss = out.image.square().sum() + out.depth.sum()
        return torch.autograd.grad(loss, [sd.means, sd.scaling, sd.rotation, sd.opacity, sd.sh0,
                                          sd.shN, out.mean2d])

    before = (tproj.project_ewa_forward.launches, tproj.project_ewa_backward.launches)
    routed = grads()
    assert (tproj.project_ewa_forward.launches, tproj.project_ewa_backward.launches) == (
        before[0] + 1, before[1] + 1)
    monkeypatch.setattr(rast, "kernel_route", lambda *a: False)
    plain = grads()
    for i, (r, p) in enumerate(zip(routed, plain)):
        assert float((r - p).abs().max()) <= PROJ_GRAD_REL * float(p.abs().max()), i


UT_SH_CASES = [(15, 3), (15, 1), (8, 2), (3, 1), (0, 0)]  # (shN rows, active degree)


@pytest.mark.parametrize("n_rest,degree", UT_SH_CASES, ids=[f"rest{r}-deg{d}" for r, d in UT_SH_CASES])
@pytest.mark.parametrize("exact", [True, False], ids=["exact-tiles", "bbox"])
@pytest.mark.parametrize("model", UT_CAMERA_MODELS)
def test_ut_projection_kernels_match_plain(model, exact, n_rest, degree):
    """The UT projection's kernels on the hazard scenes of tests/
    torch_parity.py under each camera model: every output of the forward
    bit for bit against the plain path on the card (floats within
    checks.PROJ_ULP, 0), two launches bit-equal, the backward (depth,
    opacity and colour's gradients) within PROJ_GRAD_REL of the largest
    gradient of the closed form (project_ut_backward_plain) and of autograd
    of the plain path."""
    dev = require_cuda()
    args = projection_inputs(11, n=3000, n_rest=n_rest, degree=degree, width=320, height=200,
                             device=dev)
    K, ckw = ut_camera_kwargs(model, args[10])
    args = (*args[:10], K)
    kw = dict(width=320, height=200, tile_size=16, exact_tile_test=exact, **ckw)
    with torch.no_grad():
        plain = project_gaussians_ut(*args, **kw)
    before = (tut.project_ut_forward.launches, tut.project_ut_backward.launches)
    kern = tut.project_ut_forward(*args, **kw)
    again = tut.project_ut_forward(*args, **kw)
    for name in ("valid", "bbox", "n_touched", "tile_mask"):
        assert torch.equal(getattr(kern, name), getattr(plain, name)), name
    assert int(plain.valid.sum()) > 1000
    for name, lim in PROJ_ULP.items():
        assert ulp_diff(getattr(kern, name), getattr(plain, name)) <= lim, name
        assert bits_equal(getattr(kern, name), getattr(again, name)), name
    g_depth, _, _, g_op, g_col = projection_output_grads(12, 3000, device=dev)
    bargs = (args[0], args[3], args[5], args[7], args[8], args[9], g_depth, g_op, g_col)
    k = tut.project_ut_backward(*bargs)
    k2 = tut.project_ut_backward(*bargs)
    assert (tut.project_ut_forward.launches, tut.project_ut_backward.launches) == (
        before[0] + 2, before[1] + 2)
    mirror = tut.project_ut_backward_plain(*bargs)
    leaves = [a.clone().requires_grad_(True) for a in (args[0], args[3], args[4], args[5])]
    p = project_gaussians_ut(leaves[0], args[1], args[2], leaves[1], leaves[2], leaves[3],
                             *args[6:], **kw)
    auto = torch.autograd.grad([p.depth, p.opacity, p.color], leaves, [g_depth, g_op, g_col],
                               allow_unused=True)
    for i, (x, y, m, a) in enumerate(zip(k, k2, mirror, auto)):
        assert torch.equal(x, y) and torch.isfinite(x).all(), i
        for ref in (m, a):
            if ref is None or ref.numel() == 0:
                continue
            assert float((x - ref).abs().max()) <= PROJ_GRAD_REL * float(ref.abs().max()), i


def test_ut_projection_kernels_on_the_gut_exact_path(monkeypatch):
    """rasterize's --gut-exact training path on the card takes both UT
    kernels, and its gradients match the plain path's (the route forced
    off)."""
    dev = require_cuda()
    from lichtfeld_studio_tpu_torch.ops import rasterize as rast

    sd, cam = random_scene(np.random.default_rng(14), n=3000, device=dev)
    params = cam.device_params(dev)
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)

    def grads():
        out = rasterize(sd, params, bg, mode="cuda", instance_cap=1 << 17, with_depth=True,
                        projection="ut", gut_exact=True)
        loss = out.image.square().sum() + out.depth.sum()
        return torch.autograd.grad(loss, [sd.means, sd.scaling, sd.rotation, sd.opacity, sd.sh0,
                                          sd.shN])

    before = (tut.project_ut_forward.launches, tut.project_ut_backward.launches)
    routed = grads()
    assert (tut.project_ut_forward.launches, tut.project_ut_backward.launches) == (
        before[0] + 1, before[1] + 1)
    monkeypatch.setattr(rast, "ut_kernel_route", lambda *a, **k: False)
    plain = grads()
    for i, (r, p) in enumerate(zip(routed, plain)):
        assert float((r - p).abs().max()) <= PROJ_GRAD_REL * float(p.abs().max()), i
