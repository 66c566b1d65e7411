"""Port parity for the gradient segment reduce (P4): the port's plain
version (on the CPU) against the JAX package's segment_reduce_cols in
interpret mode, on the P1 expansion layouts of tests/torch_parity.py,
overflow included. rtol 1e-6 (float64 prefix difference against float32
sums; atol 1e-6 where a sum cancels to near 0)."""

import numpy as np
import pytest
import torch

from lichtfeld_studio_tpu.kernels.segment_reduce import segment_reduce_cols
from lichtfeld_studio_tpu_torch.kernels.segment_reduce import segment_reduce
from lichtfeld_studio_tpu_torch.ops.tiles import segment_offsets
from tests.torch_parity import (
    EXPAND_CASES, SEGMENT_CASE_COLUMNS, SEGMENT_CASES, np_, segment_inputs)

N_COLUMNS = 10  # 6 geometry + 4 channels, P3's widest row


@pytest.mark.parametrize("name", list(EXPAND_CASES))
def test_segment_reduce_matches_jax(name):
    nt, cap = EXPAND_CASES[name]
    nt = np.asarray(nt, np.int32)
    rows = np.random.default_rng(len(name)).normal(size=(cap, N_COLUMNS)).astype(np.float32)
    want = np.asarray(segment_reduce_cols([rows[:, f] for f in range(N_COLUMNS)], nt, cap))
    off = segment_offsets(torch.from_numpy(nt), cap)
    got = np_(segment_reduce(torch.from_numpy(rows), off))
    assert got.shape == want.shape == (nt.shape[0], N_COLUMNS)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # segments past the cap are empty or cut at it
    assert int(off[-1]) == min(int(nt.sum()), cap)


@pytest.mark.parametrize("n_columns", [23, 32])
@pytest.mark.parametrize("name", ["dense_segments", "overflow_total_beyond_cap"])
def test_segment_reduce_wide_rows_match_jax(name, n_columns):
    """The world blend's rows: 23 used columns (global shutter) and 32
    (rolling shutter)."""
    nt, cap = EXPAND_CASES[name]
    nt = np.asarray(nt, np.int32)
    rows = np.random.default_rng(n_columns).normal(size=(cap, n_columns)).astype(np.float32)
    want = np.asarray(segment_reduce_cols([rows[:, f] for f in range(n_columns)], nt, cap))
    got = np_(segment_reduce(torch.from_numpy(rows), segment_offsets(torch.from_numpy(nt), cap)))
    assert got.shape == want.shape == (nt.shape[0], n_columns)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name,n_columns", SEGMENT_CASE_COLUMNS)
def test_segment_reduce_block_and_chunk_cases_match_jax(name, n_columns):
    """The layouts the kernel's blocks and chunks must survive (a segment
    over several chunks, empty ranges, a flat tail, block edges, one
    gaussian) at 1, 9, 10, 24 and 32 columns; the `cuda` tests run the
    same table on the card."""
    rows, nt, cap = segment_inputs(name, n_columns)
    want = np.asarray(segment_reduce_cols([rows[:, f] for f in range(n_columns)], nt, cap))
    off = segment_offsets(torch.from_numpy(nt), cap)
    got = np_(segment_reduce(torch.from_numpy(rows), off))
    assert got.shape == want.shape == (nt.shape[0], n_columns)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # against a plain loop over the segments
    bounds = off.tolist()
    loop = np.stack([rows[a:b].astype(np.float64).sum(0) for a, b in zip(bounds, bounds[1:])])
    np.testing.assert_allclose(got, loop, rtol=1e-6, atol=1e-6)


def test_segment_cases_hold_what_their_names_say():
    from lichtfeld_studio_tpu_torch.kernels.segment_reduce import BLOCK_GAUSSIANS, CHUNK_FLOATS

    off = {k: segment_offsets(torch.from_numpy(nt), cap).numpy() for k, (nt, cap) in
           SEGMENT_CASES.items()}
    lengths = {k: np.diff(o) for k, o in off.items()}
    assert lengths["segment_longer_than_two_chunks"].max() > 2 * (CHUNK_FLOATS // 9)
    assert lengths["all_segments_empty"].max() == 0
    flat = off["flat_from_the_cap_on"]
    assert flat[-1] == SEGMENT_CASES["flat_from_the_cap_on"][1] and (flat[-60:] == flat[-1]).all()
    assert flat.shape[0] - 1 > BLOCK_GAUSSIANS
    across = lengths["segments_across_a_block_edge"]
    assert across[BLOCK_GAUSSIANS - 1] > 1 and across[BLOCK_GAUSSIANS] > CHUNK_FLOATS // 24
    assert (off["n_not_a_multiple_of_the_block"].shape[0] - 1) % BLOCK_GAUSSIANS != 0
    assert lengths["one_gaussian"].shape == (1,)


def test_segment_offsets_clip_to_the_cap():
    off = segment_offsets(torch.tensor([3, 0, 4, 5], dtype=torch.int32), 6)
    assert off.dtype == torch.int32 and off.tolist() == [0, 3, 3, 6, 6]


def test_training_wrappers_refuse_bad_inputs():
    """The P3 and P4 wrappers check dtype, shape and contiguity before any
    dispatch, on the CPU as on the card."""
    from lichtfeld_studio_tpu_torch.kernels.blend import blend_backward

    rows, off = torch.zeros(8, 10), torch.tensor([0, 3, 8], dtype=torch.int32)
    with pytest.raises(ValueError):
        segment_reduce(rows.double(), off)
    with pytest.raises(ValueError):
        segment_reduce(rows, off.long())
    with pytest.raises(ValueError):
        segment_reduce(torch.zeros(8, 33), off)  # more columns than the kernel sums
    with pytest.raises(ValueError):  # the kernel copies 16-byte vectors from the first row on
        segment_reduce(torch.zeros(9, 10)[1:], off)
    n, i32 = 4, torch.int32
    good = dict(tile_start=torch.zeros(1, dtype=i32), tile_count=torch.zeros(1, dtype=i32),
                gaussian_idx=torch.zeros(8, dtype=i32), slot_layout=torch.zeros(8, dtype=i32),
                mean2d=torch.zeros(n, 2), conic=torch.zeros(n, 3), opacity=torch.zeros(n),
                color=torch.zeros(n, 3), t_final=torch.ones(16, 16),
                last=torch.full((16, 16), -1, dtype=i32), tile_neff=torch.ones(1, dtype=i32),
                d_image=torch.zeros(16, 16, 3), d_alpha=torch.zeros(16, 16))
    kw = dict(grid_w=1, grid_h=1, tile_size=16)
    assert blend_backward(**good, **kw).shape == (8, 9)
    for name, bad in (("slot_layout", torch.zeros(7, dtype=i32)), ("last", torch.ones(16, 16)),
                      ("tile_neff", torch.ones(2, dtype=i32)), ("d_image", torch.zeros(16, 16, 4))):
        with pytest.raises(ValueError):
            blend_backward(**{**good, name: bad}, **kw)
