"""Checks that the tests and the card's smoke test (chip_smoke.py) share:
the least work of the blends counted from plain mirrors of their reach
tests (blend_work over blend_groups or world_groups, in float32
operations by blend_ops), the column groups of a world-blend stream row,
the adversarial segment layouts of P4 (segment_cases), and bit and ulp
equality with the projection kernels' tolerances."""

from __future__ import annotations

import numpy as np
import torch

from lichtfeld_studio_tpu_torch.kernels import blend as kblend
from lichtfeld_studio_tpu_torch.kernels import world_blend as kwb
from lichtfeld_studio_tpu_torch.kernels.segment_reduce import BLOCK_GAUSSIANS
from lichtfeld_studio_tpu_torch.ops.blend_ref import blend_weights

# The least work of a blend, in float32 operations counted from the
# kernels' code. Each (warp patch, instance) pair up to the patch's last
# walked instance is tested once: PATCH_OPS (P2 and P3 the reach box against
# the patch; P5 and P6 the ray-space bound at the patch's centre ray, y_c,
# z_c, their norms, the slack and the test). Only the (pixel, instance)
# pairs inside (patch, instance) pairs that the test keeps are evaluated:
# PAIR_OPS (P2 and P3 sigma and its two limits; P5 and P6 y and z, |y|^2,
# |z|^2, the division and the test). Each pair that counts takes
# COUNTED_OPS more (P2 and P3 exp, scale, clamp and the alpha test, which a
# pair above the sigma limit skips, then the compositing or the backward
# terms). P3's backward walk needs only the instances in front of its tail
# trim (kernels/blend.py::trim_extent): the rows past it are 0 and the
# colour behind could come from the frame's colour, so the bound counts
# pairs up to min(last counted, trim) and the counted pairs in front of the
# trim. Which pairs the test keeps comes from plain mirrors of the
# kernels' tests (kernels/blend.py::reach_2d_plain, kernels/world_blend.py::
# patch_ray_skip_group). The reach of each instance at the gather is not
# counted. P5 and P6 at a global
# shutter, as the main path runs them.
# P5 evaluates y and |y|^2 (20) for each pair inside a kept patch, and z,
# |z|^2, the clamp, the division, the sum and the test (24) only for those
# its |y|^2 test does not drop (FULL_OPS; kernels/world_blend.py::
# pixel_reject_group mirrors that test).
PATCH_OPS = {"P2": 4, "P3": 4, "P5": 60, "P6": 60}
PAIR_OPS = {"P2": 10, "P3": 10, "P5": 20, "P6": 44}
FULL_OPS = {"P5": 24}
COUNTED_OPS = {"P2": 19, "P3": 57, "P5": 18, "P6": 79}


def blend_ops(kernel: str, work: dict, walk: str) -> int:
    """Float32 operations of `kernel` on blend_work's counts for its walk
    ("forward" or "backward")."""
    counted = work["counted" if walk == "forward" else "counted_kept"]
    return (PATCH_OPS[kernel] * work[f"{walk}_tests"] + PAIR_OPS[kernel] * work[f"{walk}_kept"]
            + FULL_OPS.get(kernel, 0) * work[f"{walk}_full"] + COUNTED_OPS[kernel] * counted)


def blend_work(groups, ts: int, threshold: float = 0.0, kept=None) -> dict:
    """What this run's data asks of a blend, from a plain version's
    per-group alphas and a plain mirror of the reach test: `groups` yields
    (alphas [t, K, P], in_range [t, K], tile_count [t], skip [t, 8, K]) and,
    for the world blend, the pairs P5 drops on |y|^2 alone [t, K, P]. A
    forward walk takes each pixel up to the instance that ends it (all of
    them if none does; to within one pair a pixel), a backward walk up to
    its last counted one. For each walk: the (pixel, instance) pairs walked,
    those inside (patch, instance) pairs the test keeps, and the (patch,
    instance) tests, each patch's up to its last walked instance. Also the
    pairs that count, the (patch, instance) pairs in range and skipped, and
    the pairs that pass the alpha test inside skipped ones (`lost`, 0
    unless the mirror is not conservative; `forward_lost` those of them
    before the pixel's forward walk ends, which the forward would have
    evaluated). `*_full`: the kept pairs that P5's |y|^2 test does not drop
    (all kept pairs without that test), and `reject_lost` the pairs that
    pass the alpha test among the dropped ones (0 unless it is not
    conservative). With `kept` (int64 [tiles], kernels/blend.py::
    trim_extent: each tile's instances in front of the tail trim) the
    backward walk ends there too, and `counted_kept` counts the counted
    pairs in front of it (all counted pairs without `kept`);
    `backward_to_last` is the backward walk up to the last counted pairs
    alone."""
    keys = ("forward_walked", "forward_kept", "forward_full", "forward_tests", "backward_walked",
            "backward_kept", "backward_full", "backward_tests", "backward_to_last", "counted",
            "counted_kept", "patch_pairs", "skipped", "lost", "forward_lost", "reject_lost")
    out = dict.fromkeys(keys, 0)
    patch_pix = patch_of = None
    t_at = 0  # the groups are consecutive runs of tiles from tile 0 on
    for alphas, in_range, count, skip, *rejected in groups:
        if patch_pix is None:
            patch_pix = kblend._patch_pixels(ts, alphas.device)  # [8, n]
            patch_of = torch.empty(ts * ts, dtype=torch.long, device=alphas.device)
            patch_of[patch_pix.reshape(-1)] = torch.arange(
                8, device=alphas.device).repeat_interleave(patch_pix.shape[1])
        _, counted = blend_weights(alphas, threshold)
        counted &= in_range[..., None]  # a prefix of each pixel's range
        hit = counted & (alphas > 0.0)
        k = torch.arange(alphas.shape[1], device=alphas.device)[None, :, None]
        keep = ~skip[:, patch_of].transpose(1, 2)  # [t, K, P]
        ends = {"forward": torch.minimum(counted.sum(dim=1) + 1, count[:, None].long()),
                "backward": torch.where(hit, k + 1, 0).amax(dim=1)}  # [t, P]
        out["backward_to_last"] += int(ends["backward"].sum())
        front = hit
        if kept is not None:
            kept_g = kept[t_at:t_at + alphas.shape[0]].to(alphas.device)
            ends["backward"] = torch.minimum(ends["backward"], kept_g[:, None])
            front = hit & (k < kept_g[:, None, None])
        t_at += alphas.shape[0]
        out["counted_kept"] += int(front.sum())
        full = keep & ~rejected[0] if rejected else keep
        for walk, end in ends.items():
            out[f"{walk}_walked"] += int(end.sum())
            out[f"{walk}_kept"] += int(((k < end[:, None, :]) & keep).sum())
            out[f"{walk}_full"] += int(((k < end[:, None, :]) & (full if walk == "forward"
                                                                   else keep)).sum())
            out[f"{walk}_tests"] += int(end[:, patch_pix].amax(dim=-1).sum())
        out["counted"] += int(hit.sum())
        out["patch_pairs"] += 8 * int(in_range.sum())
        out["skipped"] += int(skip.sum())
        out["lost"] += int(((alphas > 0.0) & ~keep).sum())
        out["forward_lost"] += int(((alphas > 0.0) & ~keep & (k < ends["forward"][:, None, :])).sum())
        if rejected:
            out["reject_lost"] += int(((alphas > 0.0) & rejected[0]).sum())
    return out


def blend_groups(args, kw):
    """The 2D blend's per-group alphas (P2's plain version's pieces) and the
    (patch, instance) pairs the plain mirror of its reach test skips."""
    tile_start, tile_count, gidx, mean2d, conic, opacity, _ = args
    ts = kw["tile_size"]
    box = kblend.reach_2d_plain(mean2d, conic, opacity)
    for t0, t1, k_max in kblend._plain_groups(tile_count, ts * ts):
        _, in_range, g, _, px, py = kblend._gather_group(t0, t1, k_max, tile_start, tile_count,
                                                         gidx, kw["grid_w"], ts)
        alphas = kblend.compute_alphas(mean2d[g], conic[g], torch.where(in_range, opacity[g], 0.0),
                                       px, py)
        skip = kblend.patch_reach_skip_group(box[g], in_range, t0, t1, kw["grid_w"], ts)
        yield alphas, in_range, tile_count[t0:t1], skip


def world_groups(stream, rays_d, tau, a, kw):
    """The world blend's per-group alphas (P5's plain version's pieces) and
    the (patch, instance) pairs the plain mirror of the ray-space bound of
    P5 and P6 skips."""
    ts = kw["tile_size"]
    lay = kwb._Layout(stream.shape[1] == kwb.STREAM_ROWS_RS)
    d_t, tau_t = kwb._tile_rays(rays_d, tau, kw["grid_w"], kw["grid_h"], ts)
    patch_pix = kblend._patch_pixels(ts, stream.device)
    patch_of = torch.empty(ts * ts, dtype=torch.long, device=stream.device)
    patch_of[patch_pix.reshape(-1)] = torch.arange(
        8, device=stream.device).repeat_interleave(patch_pix.shape[1])
    for t0, t1, k_max in kblend._plain_groups(a.tile_count, ts * ts):
        _, in_range, g, _, _, _ = kblend._gather_group(t0, t1, k_max, a.tile_start, a.tile_count,
                                                       a.gaussian_idx, kw["grid_w"], ts)
        f, d, tau_g = stream[g], d_t[t0:t1], tau_t[t0:t1] if tau_t is not None else None
        skip, den_hi = kwb.patch_ray_skip_group(f, d, tau_g, in_range, lay, patch_pix,
                                                with_den_hi=True)
        yield (kwb._stream_alphas(f, d, tau_g, in_range, lay), in_range, a.tile_count[t0:t1],
               skip, kwb.pixel_reject_group(f, d, tau_g, lay, den_hi, patch_of))


def stream_column_groups(n_rows: int, with_depth: bool) -> list[slice]:
    """The column groups of a world-blend stream row and of its gradient
    (kernels/world_blend.py): C' (C0' and C1' with a rolling shutter), M,
    -log2 op, the colour, and the depth channel where it is rendered."""
    geo = [slice(0, 9), slice(9, 18)] + ([slice(18, 27)] if n_rows == 32 else [])
    c = 28 if n_rows == 32 else 19
    return geo + [slice(c - 1, c), slice(c, c + 3)] + ([slice(c + 3, c + 4)] if with_depth else [])


def segment_cases() -> dict:
    """Segment layouts P4's blocks and chunks must survive, as name ->
    (n_touched int32 [N], instance cap): a block of csrc/segment_reduce.cu
    owns BLOCK_GAUSSIANS gaussians and streams CHUNK_FLOATS // columns rows
    a chunk. Shared with the tests (tests/torch_parity.py)."""
    G = BLOCK_GAUSSIANS
    rng = np.random.default_rng(6)
    long_segment = rng.integers(0, 3, 40).astype(np.int32)
    long_segment[17] = 1100  # > two chunks of 9-column rows (455 each), > eight of 32-column
    flat = rng.integers(0, 4, G + 90).astype(np.int32)  # off is flat from the cap on
    across = rng.integers(0, 3, 2 * G + 8).astype(np.int32)
    across[G - 1], across[G] = 60, 350  # long segments on both sides of a block's edge
    across[G + 1:G + 40] = 0  # and a run of empty ones behind it
    return {
        "segment_longer_than_two_chunks": (long_segment, int(long_segment.sum()) + 3),
        "all_segments_empty": (np.zeros(G + 44, np.int32), 64),
        "flat_from_the_cap_on": (flat, int(flat[:G - 20].sum()) + 1),
        "segments_across_a_block_edge": (across, int(across.sum())),
        "n_not_a_multiple_of_the_block": (rng.integers(0, 4, G + 37).astype(np.int32), 1024),
        "one_gaussian": (np.array([17], np.int32), 32),
    }


SEGMENT_COLUMNS = (1, 9, 10, 24, 32)  # the run-time width, P3's two, P6's two


def segment_inputs(name: str, n_columns: int, scale: int = 1):
    """(rows [cap, n_columns] f32, n_touched int32, cap) of a segment_cases
    entry as numpy arrays, its gaussians repeated `scale` times."""
    nt, cap = segment_cases()[name]
    nt, cap = np.tile(nt, scale), cap * scale
    rows = np.random.default_rng(n_columns + len(name)).normal(size=(cap, n_columns))
    return rows.astype(np.float32), nt, cap


# The EWA projection's kernels against the plain path: the kept set and
# the tiles bit for bit, the float outputs within PROJ_ULP units in the last
# place (0: the kernel repeats the plain path's every rounding, its sums in
# the order of torch's reduction kernel), the backward within PROJ_GRAD_REL
# of the largest plain gradient of each parameter, against the closed form
# in plain PyTorch and against autograd of the plain path
PROJ_ULP = {"depth": 0, "mean2d": 0, "conic": 0, "opacity": 0, "color": 0}
PROJ_GRAD_REL = 1e-4


def bits_equal(a, b) -> bool:
    """a and b hold the same bits (NaN where the other has the same NaN)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))
    return torch.equal(a, b)


def ulp_diff(a, b) -> int:
    """Largest distance in float32 units in the last place between a and b
    (two NaNs agree; +0 and -0 agree)."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    d = (ordered(a) - ordered(b)).abs()
    d = torch.where(torch.isnan(a) & torch.isnan(b), 0, d)
    return int(d.max()) if d.numel() else 0
