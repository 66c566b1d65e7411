"""Kernel P4 wrapper: per-gaussian sums of contiguous slot segments
(counterpart of lichtfeld_studio_tpu/kernels/segment_reduce.py::
segment_reduce_cols / grad_segment_reduce_packed). Up to 32 columns: the
2D blend's 9 or 10 (P3) and the world blend's 24 or 32 (P6).

out[n, :] = sum of rows[s, :] over s in [off[n], off[n+1]), where `off` is
the exclusive cumsum of n_touched clipped to the instance cap
(ops/tiles.py::segment_offsets), so instances dropped by an overflow
contribute nothing.

CUDA tensors launch csrc/segment_reduce.cu: a block owns BLOCK_GAUSSIANS
consecutive gaussians, streams their one contiguous range of rows through
shared memory in chunks of CHUNK_FLOATS floats, and adds each segment
serially in slot order in float32. CPU tensors take the plain version, the
float64 cumsum difference of ops/tiles.py in the JAX package
(tiles.py:412-427): a prefix sum in float64, read at the segment bounds,
rounded to float32 once. Against the kernel's float32 sums the difference is
a few float32 roundings of each segment sum.
"""

from __future__ import annotations

import torch

from lichtfeld_studio_tpu_torch.kernels import _build

MAX_COLUMNS = 32  # csrc/segment_reduce.cu kMaxColumns
BLOCK_GAUSSIANS = 256  # csrc/segment_reduce.cu kThreads: the gaussians a block owns
CHUNK_FLOATS = 4096  # csrc/segment_reduce.cu kChunkFloats: a chunk is CHUNK_FLOATS // F rows


def _check_inputs(rows: torch.Tensor, off: torch.Tensor) -> None:
    if rows.dtype != torch.float32 or rows.ndim != 2 or not 1 <= rows.shape[1] <= MAX_COLUMNS:
        raise ValueError(f"segment_reduce: rows must be float32 [S, 1..{MAX_COLUMNS}], "
                         f"got {rows.dtype} {tuple(rows.shape)}")
    if off.dtype != torch.int32 or off.ndim != 1 or off.shape[0] < 1:
        raise ValueError(f"segment_reduce: off must be int32 [N + 1], got {off.dtype} {tuple(off.shape)}")
    if not (rows.is_contiguous() and off.is_contiguous()):
        raise ValueError("segment_reduce: rows and off must be contiguous")
    if rows.device != off.device:
        raise ValueError(f"segment_reduce: rows on {rows.device}, off on {off.device}")
    if rows.data_ptr() % 16:
        raise ValueError("segment_reduce: rows must start on a 16-byte boundary")


def segment_reduce_plain(rows: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    prefix = torch.nn.functional.pad(torch.cumsum(rows.to(torch.float64), 0), (0, 0, 1, 0))
    off = off.long()
    return (prefix[off[1:]] - prefix[off[:-1]]).to(torch.float32)


def segment_reduce(
    rows: torch.Tensor,  # [S, F] f32 — slot-ordered rows
    off: torch.Tensor,  # [N + 1] int32 — segment bounds, non-decreasing, <= S
) -> torch.Tensor:
    """Per-segment sums [N, F] f32."""
    _check_inputs(rows, off)
    if rows.device.type == "cpu":
        return segment_reduce_plain(rows, off)
    if rows.device.type != "cuda":
        raise ValueError(f"segment_reduce: unsupported device {rows.device}")
    lib = _build.load_library()
    n, n_f = off.shape[0] - 1, rows.shape[1]
    out = torch.empty((n, n_f), dtype=torch.float32, device=rows.device)
    err = lib.lfs_segment_reduce(
        rows.data_ptr(), off.data_ptr(), n, n_f, rows.shape[0], out.data_ptr(),
        torch.cuda.current_stream(rows.device).cuda_stream,
    )
    _build.check(err, "lfs_segment_reduce")
    segment_reduce.launches += 1
    return out


segment_reduce.launches = 0  # kernel launches since the last reset
