"""Tile binning: instance expansion, (tile, depth) sort, tile ranges
(counterpart of lichtfeld_studio_tpu/ops/tiles.py, compact layout).

1. `n_touched` per gaussian -> each gaussian's segment of a fixed-capacity
   instance buffer; kernel P1 (kernels/expand.py) maps every slot to its
   owning gaussian, its rank in the segment and the gaussian's 4-word
   payload (bbox origin, bbox width | n_touched << 10, depth bits, exact
   tile mask).
2. rank -> tile through the exact-contribution bitmask.
3. ONE sort: for inference a fused one-word key (tile id in the high bits,
   the top bits of the positive-float depth below); otherwise, or when
   fewer than 12 depth bits would remain, the exact (tile, depth) order.
4. Per-tile starts and counts by binary search over the sorted tiles.
5. For gradients: `slot_layout` (each sorted position's pre-sort slot) and
   `segment_off`, each gaussian's segment of slots; the blend backward
   (P3) writes instance rows straight to their pre-sort slots and P4 sums
   each segment, so the JAX package's restore sort
   (sort_rows_to_slot_order) has no counterpart.

Overflow policy (as tiles.py:31-33): when the instances exceed
`instance_cap`, trailing instances in gaussian order are dropped and
`n_instances` still reports the true total.

The sorts and the search are torch.sort / torch.searchsorted, library
calls as XLA's sort and searchsorted were in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from lichtfeld_studio_tpu_torch.kernels.expand import expand_instances
from lichtfeld_studio_tpu_torch.ops.projection import ProjectedSplats

_U32 = 0xFFFFFFFF


@dataclass
class TileAssignment:
    gaussian_idx: torch.Tensor  # [I] int32 — owning gaussian per sorted instance
    slot_layout: torch.Tensor  # [I] int32 — pre-sort slot per position (zeros
    #   on the fused-key path, which has no gradient)
    tile_start: torch.Tensor  # [T] int32 — first instance index per tile
    tile_count: torch.Tensor  # [T] int32 — real instances per tile
    n_instances: torch.Tensor  # [] int32 — true instance total (may exceed I)
    instance_valid: torch.Tensor  # [I] bool
    slot_gaussian: torch.Tensor | None = None  # [I] int32 — owner per PRE-SORT slot
    segment_off: torch.Tensor | None = None  # [C+1] int32 — segment bounds (need_grad)


def segment_offsets(n_touched: torch.Tensor, instance_cap: int) -> torch.Tensor:
    """[C+1] int32: gaussian g owns pre-sort slots [off[g], off[g+1]), the
    exclusive cumsum of n_touched clipped to the cap (instances past it were
    dropped; segment_reduce.py:219-223 in the JAX package)."""
    ends = torch.cumsum(n_touched, 0, dtype=torch.int64)
    off = torch.nn.functional.pad(ends, (1, 0))
    return torch.clamp(off, max=instance_cap).to(torch.int32)


def _depth_key_bits(depth: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern of float32 depth, monotonic for positive depths
    (kernels_forward.cuh:199)."""
    return depth.to(torch.float32).contiguous().view(torch.int32)


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Population count of the low 32 bits of an integer tensor (SWAR)."""
    v = x.to(torch.int64) & _U32
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & _U32) >> 24).to(torch.int32)


def _select_bit(mask: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Index of the r-th set bit of each int32 mask (binary search over
    popcounts): an instance's rank -> its bbox cell under the bitmask."""
    k = torch.zeros_like(r)
    remaining = r
    for w in (16, 8, 4, 2, 1):
        window = (mask >> k) & ((1 << w) - 1)
        cnt = _popcount(window)
        go_right = remaining >= cnt
        remaining = torch.where(go_right, remaining - cnt, remaining)
        k = torch.where(go_right, k + w, k)
    return k


def pack_payload(proj: ProjectedSplats) -> torch.Tensor:
    """Per-gaussian int32 payload [4, C]: x_min | y_min << 16,
    bbox_width | n_touched << 10 (grids <= 1024 tiles wide), depth bits,
    exact tile mask."""
    bbox = proj.bbox
    bb_w = torch.clamp(bbox[:, 1] - bbox[:, 0], min=1)
    return torch.stack(
        [
            bbox[:, 0] | (bbox[:, 2] << 16),
            bb_w | (proj.n_touched << 10),
            _depth_key_bits(proj.depth),
            proj.tile_mask,
        ],
        dim=0,
    ).to(torch.int32)


def build_tile_assignment(
    proj: ProjectedSplats,
    *,
    grid_w: int,
    grid_h: int,
    instance_cap: int,
    need_grad: bool = True,
) -> TileAssignment:
    """Bin projected gaussians into per-tile depth-sorted instance lists,
    in the compact layout (the JAX package's chunk_align=1; the aligned
    layout has no production caller). need_grad=False is the inference
    layout: one fused sort key, no pre-sort slot ids."""
    n_touched = proj.n_touched
    dev = n_touched.device
    num_tiles = grid_w * grid_h
    tile_bits = int(num_tiles).bit_length()  # holds 0..num_tiles (sentinel)
    depth_keep = 31 - tile_bits
    fused_key = (not need_grad) and depth_keep >= 12

    payload_t = pack_payload(proj)
    slot = torch.arange(instance_cap, dtype=torch.int32, device=dev)
    total = n_touched.sum(dtype=torch.int64).to(torch.int32)
    g, rank, pl_t = expand_instances(n_touched, payload_t, instance_cap)

    x_min_i = pl_t[0] & 0xFFFF
    y_min_i = (pl_t[0] >> 16) & 0xFFFF
    bb_w_i = pl_t[1] & 0x3FF
    nt_i = pl_t[1] >> 10
    inst_valid = (slot < total) & (rank < nt_i)

    # rank -> bbox cell: the rank-th contributing cell when the exact tile
    # mask is present (mask == 0 means the conservative full bbox)
    mask = pl_t[3]
    cell = torch.where(mask != 0, _select_bit(mask, rank), rank)
    t_x = x_min_i + cell % bb_w_i
    t_y = y_min_i + cell // bb_w_i
    tile = torch.clamp(t_y * grid_w + t_x, 0, num_tiles - 1)
    tile = torch.where(inst_valid, tile, num_tiles)  # invalid -> end of sort

    if fused_key:
        # logical shift of the depth bits: done in int64 on the low 32 bits,
        # since torch's >> on int32 is arithmetic and would smear a negative
        # depth's sign into the tile field
        depth_hi = (pl_t[2].to(torch.int64) & _U32) >> (31 - depth_keep)
        # < 2^31: the tile field (sentinel included) fits tile_bits bits
        key = ((tile.to(torch.int64) << depth_keep) | depth_hi).to(torch.int32)
        key_sorted, order = torch.sort(key)
        tile_sorted = key_sorted >> depth_keep
        slot_sorted = torch.zeros_like(slot)
    else:
        # exact lexicographic (tile, signed depth bits) as one int64 key
        depth_u = pl_t[2].to(torch.int64) + 2**31
        key = (tile.to(torch.int64) << 32) | depth_u
        _, order = torch.sort(key)
        tile_sorted = tile[order]
        slot_sorted = slot[order]
    g_sorted = g[order]
    valid_sorted = tile_sorted < num_tiles
    g_sorted = torch.where(valid_sorted, g_sorted, 0)

    queries = torch.arange(num_tiles + 1, dtype=torch.int32, device=dev)
    starts_q = torch.searchsorted(tile_sorted, queries, side="left").to(torch.int32)
    counts = starts_q[1:] - starts_q[:-1]
    return TileAssignment(
        gaussian_idx=g_sorted,
        slot_layout=slot_sorted,
        tile_start=starts_q[:num_tiles].contiguous(),
        tile_count=counts,
        n_instances=total,
        instance_valid=valid_sorted,
        slot_gaussian=g,
        segment_off=segment_offsets(n_touched, instance_cap) if need_grad else None,
    )
