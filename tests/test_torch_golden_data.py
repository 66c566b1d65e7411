"""tests/test_golden_data.py on the port: the golden fixture (a frozen
trained checkpoint, tests/data/golden_splats.npz, 39,590 gaussians) through
the port's projection, binning and kernel path on CPU tensors (the plain
versions of P1-P4).

  * at the full 648x420, 16-px-tile geometry: the fixture's statistics and
    the binning's invariants (the port bins in the compact layout: tile
    ranges contiguous, depth-sorted, every slot inside a range valid), and
    the per-tile counts against the JAX package's binning;
  * at 320x208: the port's kernel path against the JAX package's
    mode="tiles" image, with the reference's bounds (median < 2e-3, more
    than 99.5% of pixels within 0.05, the same for alpha);
  * at 64x48: the gradients of the kernel path against the port's dense
    oracle, as test_golden_data.py:183-215 (more than 99% close per group).

The `cuda` twin (tests/test_torch_kernels_cuda.py::
test_golden_kernels_match_plain) runs P1-P4 at 648x420 on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lichtfeld_studio_tpu.core.camera import look_at_camera as j_look_at
from lichtfeld_studio_tpu.core.splat_data import SplatData as JSplatData
from lichtfeld_studio_tpu.ops.projection import project_gaussians as j_project
from lichtfeld_studio_tpu.ops.rasterize import rasterize as j_rasterize
from lichtfeld_studio_tpu.ops.tiles import build_tile_assignment as j_bin
from lichtfeld_studio_tpu_torch.ops.rasterize import _project, rasterize
from lichtfeld_studio_tpu_torch.ops.tiles import build_tile_assignment
from tests.torch_parity import GOLDEN_FIELDS as FIELDS
from tests.torch_parity import golden_arrays, golden_camera, golden_splats, np_
W, H = 648, 420  # full stats/binning geometry
WR, HR = 320, 208  # render-parity geometry
TS = 16
GW, GH = -(-W // TS), -(-H // TS)
ICAP = 2 * 2**20
EYE_FULL, EYE_RENDER = np.array([0.0, -0.4, -4.2]), np.array([0.0, -0.4, -5.5])
UP = np.array([0.0, -1.0, 0.0])


@pytest.fixture(scope="module")
def golden():
    return golden_splats()


def _jax_golden():
    a = golden_arrays()
    sd = JSplatData.from_arrays(*(a[k] for k in FIELDS), capacity=a["means"].shape[0])
    import dataclasses

    return dataclasses.replace(sd, active_sh_degree=jnp.asarray(3, jnp.int32))


def test_golden_statistics_are_realistic(golden):
    """The fixture exercises trained-model statistics through the port's
    projection and binning."""
    cam = golden_camera(W, H, EYE_FULL, 570.0)
    n = int(golden.n_active)
    assert n >= 20_000, n
    with torch.no_grad():
        proj = _project(golden, cam, tile_size=TS)
        a = build_tile_assignment(proj, grid_w=GW, grid_h=GH, instance_cap=ICAP)
    v = np_(proj.valid)
    assert v.sum() > 0.3 * n
    nt = np_(proj.n_touched)[v]
    assert nt.max() >= 16, nt.max()
    assert 1 <= np.median(nt) <= 32, np.median(nt)
    op = np_(proj.opacity)[v]
    assert (op > 0.5).mean() > 0.05 and (op < 0.1).mean() > 0.05
    counts = np_(a.tile_count)
    assert int(a.n_instances) > 1.5 * v.sum()
    assert counts.max() > 256, "no deep tiles: fixture too sparse"


def test_golden_binning_invariants(golden):
    """The compact layout on real statistics: tile ranges contiguous and
    depth-sorted, every slot inside a range valid and none after the last;
    the per-tile counts and the instance total as the JAX package bins
    them (its compact layout, chunk_align=1) on its own projection."""
    cam = golden_camera(W, H, EYE_FULL, 570.0)
    with torch.no_grad():
        proj = _project(golden, cam, tile_size=TS)
        a = build_tile_assignment(proj, grid_w=GW, grid_h=GH, instance_cap=ICAP)
    start, count = np_(a.tile_start), np_(a.tile_count)
    gidx, valid, depth = np_(a.gaussian_idx), np_(a.instance_valid), np_(proj.depth)
    total = int(a.n_instances)
    assert total <= ICAP and int(count.sum()) == total
    np.testing.assert_array_equal(start[1:], start[:-1] + count[:-1])
    assert valid[:total].all() and not valid[total:].any()
    for t in np.argsort(-count)[:32]:  # the 32 deepest tiles
        s, c = start[t], count[t]
        assert (np.diff(depth[gidx[s:s + c]]) >= -1e-6).all(), f"tile {t} not depth sorted"

    sd = _jax_golden()
    jcam = j_look_at(EYE_FULL, np.zeros(3), UP, fx=570.0, fy=570.0, width=W,
                     height=H).device_params()
    pj = j_project(sd.means, sd.scaling, sd.rotation, sd.opacity, sd.sh0, sd.shN,
                   sd.active_mask(), sd.active_sh_degree, jcam.w2c, jcam.cam_position, jcam.K,
                   width=W, height=H, tile_size=TS)
    aj = j_bin(pj, grid_w=GW, grid_h=GH, instance_cap=ICAP)
    # a gaussian on a tile's edge may round to the other side in one package
    assert abs(int(aj.n_instances) - total) <= 1e-4 * total
    assert np.abs(np.asarray(aj.tile_count) - count).sum() <= 1e-4 * total


def _render_camera(device="cpu"):
    return golden_camera(WR, HR, EYE_RENDER, 260.0, device)


def _loss_grads(render, splats, gt):
    params = splats.trainable_dict()
    out = render(splats)
    loss = (out.image - gt).abs().mean()
    return out, dict(zip(params, torch.autograd.grad(loss, list(params.values()))))


def _assert_mostly_close(a, b, what, frac=0.99):
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    close = np.abs(a - b) <= 0.01 * (np.abs(a).max() + 1e-12) + 1e-9
    assert close.mean() > frac, (what, close.mean())


def test_golden_full_render_matches_jax_tiles(golden):
    """The port's kernel path (plain P1/P2 on CPU tensors) against the JAX
    package's mode="tiles" at deep-tile statistics: the image and alpha
    within the reference's bounds."""
    sd = _jax_golden()
    jcam = j_look_at(EYE_RENDER, np.zeros(3), UP, fx=260.0, fy=260.0, width=WR,
                     height=HR).device_params()
    out_j = jax.jit(lambda s: j_rasterize(s, jcam, jnp.zeros(3), mode="tiles", instance_cap=ICAP,
                                          k_max=2048))(sd)
    with torch.no_grad():
        out_t = rasterize(golden, _render_camera(), torch.zeros(3), mode="cuda", tile_size=TS,
                          instance_cap=ICAP)
    err = np.abs(np_(out_t.image) - np.asarray(out_j.image))
    assert np.median(err) < 2e-3, np.median(err)
    assert (err < 0.05).mean() > 0.995, err.max()
    al = np.abs(np_(out_t.alpha) - np.asarray(out_j.alpha))
    assert np.median(al) < 2e-3 and (al < 0.05).mean() > 0.995


def test_golden_gradients_vs_oracle(golden):
    """Gradients of the kernel path against the port's dense oracle (per
    pixel over all gaussians, no binning) at trained statistics, in a small
    window: more than 99% of entries close per group."""
    cam = golden_camera(64, 48, EYE_RENDER, 110.0)
    gt = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (48, 64, 3)).astype(np.float32))
    grads = {}
    for mode in ("oracle", "cuda"):
        grads[mode] = _loss_grads(
            lambda s: rasterize(s, cam, torch.zeros(3), mode=mode, tile_size=TS,
                                instance_cap=ICAP), golden, gt)[1]
    for k in ("means", "opacity", "sh0", "scaling"):
        _assert_mostly_close(np_(grads["oracle"][k]), np_(grads["cuda"][k]), k)
