"""Port parity for tile binning: build_tile_assignment(chunk_align=1) of
lichtfeld_studio_tpu_torch against the JAX package on the same projected
scene. Sort ties are unstable and the fused key drops depth bits, so raw
orders are not compared: tile counts, starts and n_instances are equal,
each tile holds the same set of gaussians, and depth never decreases
within a tile (in the bits the key keeps)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from lichtfeld_studio_tpu.ops.projection import project_gaussians as j_project
from lichtfeld_studio_tpu.ops.tiles import build_tile_assignment as j_build
from lichtfeld_studio_tpu_torch.ops import tiles as ttiles
from lichtfeld_studio_tpu_torch.ops.projection import ProjectedSplats
from tests.scene_utils import make_camera, make_random_splats
from tests.torch_parity import np_


def _projected(rng, tile_size, n=120):
    sd = make_random_splats(rng, n=n, spread=1.4)
    cam = make_camera(96, 64)
    cp = cam.device_params()
    common = dict(width=cam.width, height=cam.height, tile_size=tile_size,
                  exact_tile_cap=32 if tile_size < 32 else 16)
    pj = jax.jit(j_project, static_argnames=tuple(common))(
        sd.means, sd.scaling, sd.rotation, sd.opacity, sd.sh0, sd.shN,
        sd.active_mask(), sd.active_sh_degree, cp.w2c, cp.cam_position, cp.K, **common,
    )
    # the port bins the SAME projection (its own projection is checked
    # against the JAX package in test_torch_projection.py)
    pt = ProjectedSplats(**{
        f.name: torch.from_numpy(np.array(getattr(pj, f.name)))
        for f in dataclasses.fields(ProjectedSplats)
    })
    grid = (-(-cam.width // tile_size), -(-cam.height // tile_size))
    return pj, pt, grid


def _tile_sets(a, n_tiles):
    start, count, gidx = np_(a.tile_start), np_(a.tile_count), np_(a.gaussian_idx)
    return [sorted(gidx[start[t]: start[t] + count[t]].tolist()) for t in range(n_tiles)]


@pytest.mark.parametrize(
    "tile_size,need_grad,cap",
    [
        (32, False, 4096),  # inference: fused one-word key
        (16, False, 4096),
        (16, True, 4096),  # exact two-key sort
        (16, False, 100),  # overflow: trailing instances dropped
        (16, True, 100),
    ],
)
def test_tile_assignment_matches_jax(rng, tile_size, need_grad, cap):
    pj, pt, (gw, gh) = _projected(rng, tile_size)
    kw = dict(grid_w=gw, grid_h=gh, instance_cap=cap, need_grad=need_grad)
    aj = jax.jit(j_build, static_argnames=(*kw, "chunk_align"))(pj, chunk_align=1, **kw)
    at = ttiles.build_tile_assignment(pt, **kw)
    n_tiles = gw * gh
    assert int(at.n_instances) == int(aj.n_instances) == int(np_(pj.n_touched).sum())
    if cap < int(aj.n_instances):
        assert int(np_(at.tile_count).sum()) == cap  # overflow really happened
    np.testing.assert_array_equal(np_(at.tile_count), np_(aj.tile_count))
    np.testing.assert_array_equal(np_(at.tile_start), np_(aj.tile_start))
    np.testing.assert_array_equal(np_(at.instance_valid), np_(aj.instance_valid))
    assert _tile_sets(at, n_tiles) == _tile_sets(aj, n_tiles)

    # depth order within each tile, in the bits the sort key keeps
    depth_bits = np_(pt.depth).view(np.int32).astype(np.int64)
    fused = (not need_grad) and 31 - n_tiles.bit_length() >= 12
    if fused:
        depth_bits >>= n_tiles.bit_length()
    start, count, gidx = np_(at.tile_start), np_(at.tile_count), np_(at.gaussian_idx)
    for t in range(n_tiles):
        d = depth_bits[gidx[start[t]: start[t] + count[t]]]
        assert np.all(np.diff(d) >= 0), t
    if not fused:  # slot_layout recovers each sorted instance's owner
        valid = np_(at.instance_valid)
        np.testing.assert_array_equal(
            np_(at.slot_gaussian)[np_(at.slot_layout)][valid], gidx[valid]
        )


def test_fused_key_keeps_negative_depth_bits_at_the_end():
    """A culled gaussian with negative depth (sign bit set) must sort behind
    every valid instance: the depth field is shifted logically. The culled
    gaussian is the last one, so the slots past the instance total are its
    (rank >= n_touched) and carry its negative depth bits into the key; an
    arithmetic shift would smear the sign into the tile field and sort those
    invalid slots to the front."""
    depth = torch.tensor([2.0, 1.0, -3.0])
    bits = ttiles._depth_key_bits(depth)
    assert int(bits[2]) < 0
    proj = ProjectedSplats(
        depth=depth,
        mean2d=torch.zeros(3, 2), conic=torch.zeros(3, 3), opacity=torch.ones(3),
        color=torch.zeros(3, 3),
        bbox=torch.tensor([[0, 2, 0, 1], [1, 2, 0, 1], [0, 1, 0, 1]], dtype=torch.int32),
        n_touched=torch.tensor([2, 1, 0], dtype=torch.int32),
        valid=torch.tensor([True, True, False]),
        tile_mask=torch.zeros(3, dtype=torch.int32),
    )
    g, rank, pl_t = ttiles.expand_instances(proj.n_touched, ttiles.pack_payload(proj), 8)
    # the precondition: every slot past the total belongs to the culled gaussian
    assert np_(g)[3:].tolist() == [2] * 5 and np.all(np_(rank)[3:] >= 0)
    assert np.all(np_(pl_t)[2, 3:] == int(bits[2]))
    a = ttiles.build_tile_assignment(proj, grid_w=2, grid_h=1, instance_cap=8, need_grad=False)
    assert np_(a.tile_count).tolist() == [1, 2]
    assert np_(a.tile_start).tolist() == [0, 1]
    # tile 1: gaussian 1 (depth 1) in front of gaussian 0 (depth 2)
    assert np_(a.gaussian_idx)[:3].tolist() == [0, 1, 0]
    assert np_(a.instance_valid).tolist() == [True] * 3 + [False] * 5


def test_select_bit_and_popcount():
    rng = np.random.default_rng(3)
    masks = rng.integers(1, 2**16, 200).astype(np.int32)
    pop = np.array([bin(int(m)).count("1") for m in masks])
    np.testing.assert_array_equal(np_(ttiles._popcount(torch.from_numpy(masks))), pop)
    r = (rng.integers(0, 1 << 30, 200) % pop).astype(np.int32)
    want = [[i for i in range(16) if (int(m) >> i) & 1][int(k)] for m, k in zip(masks, r)]
    got = ttiles._select_bit(torch.from_numpy(masks), torch.from_numpy(r))
    np.testing.assert_array_equal(np_(got), want)
    assert int(ttiles._popcount(torch.tensor([-1], dtype=torch.int32))) == 32
