"""Kernel P1 wrapper: instance expansion (counterpart of
lichtfeld_studio_tpu/kernels/expand_pallas.py::expand_instances).

Slot s of the instance buffer belongs to gaussian g with in-segment rank r;
segments are laid out consecutively in gaussian order (exclusive cumsum of
n_touched). Returns (g [I], rank [I], pl_t [4, I]) with
pl_t[:, s] == payload_t[:, g[s]]. Slots not covered by a live segment hold
an in-bounds g with rank >= n_touched[g]; callers mask them.

CUDA tensors launch csrc/expand.cu (a merge of the slots with the
inclusive cumsum of n_touched, cut into equal pieces, one a block); CPU
tensors take the plain version, the scatter-marker + cumsum construction of
lichtfeld_studio_tpu/ops/tiles.py. `expand_partition_plain` mirrors the
kernel's partition step by step, for the tests.
"""

from __future__ import annotations

import torch

from lichtfeld_studio_tpu_torch.kernels import _build


def _check_inputs(n_touched: torch.Tensor, payload_t: torch.Tensor, instance_cap: int):
    if n_touched.dtype != torch.int32 or n_touched.ndim != 1:
        raise ValueError(f"n_touched must be 1-D int32, got {n_touched.dtype} {tuple(n_touched.shape)}")
    c = n_touched.shape[0]
    if c == 0:
        raise ValueError("expand_instances needs at least one gaussian")
    if payload_t.dtype != torch.int32 or tuple(payload_t.shape) != (4, c):
        raise ValueError(f"payload_t must be int32 [4, {c}], got {payload_t.dtype} {tuple(payload_t.shape)}")
    if payload_t.device != n_touched.device:
        raise ValueError("n_touched and payload_t must be on one device")
    if instance_cap <= 0:
        raise ValueError(f"instance_cap must be positive, got {instance_cap}")


def expand_instances_plain(
    n_touched: torch.Tensor, payload_t: torch.Tensor, instance_cap: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scatter a marker at each segment start, prefix-sum it to the owner;
    a running max of marked positions gives each segment's start."""
    dev = n_touched.device
    offsets = torch.cumsum(n_touched, 0, dtype=torch.int64) - n_touched
    slot = torch.arange(instance_cap, dtype=torch.int64, device=dev)
    marker = torch.zeros(instance_cap, dtype=torch.int64, device=dev)
    inside = offsets[offsets < instance_cap]  # starts past the cap are dropped
    marker.index_add_(0, inside, torch.ones_like(inside))
    g = torch.cumsum(marker, 0) - 1
    seg_start = torch.cummax(torch.where(marker > 0, slot, 0), 0).values
    rank = slot - seg_start
    pl_t = payload_t[:, g]
    return g.to(torch.int32), rank.to(torch.int32), pl_t


def expand_instances(
    n_touched: torch.Tensor,  # [C] int32 — instances per gaussian (0 = culled)
    payload_t: torch.Tensor,  # [4, C] int32 — per-gaussian packed words
    instance_cap: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _check_inputs(n_touched, payload_t, instance_cap)
    if n_touched.device.type == "cpu":
        return expand_instances_plain(n_touched, payload_t, instance_cap)
    if n_touched.device.type != "cuda":
        raise ValueError(f"expand_instances: unsupported device {n_touched.device}")
    lib = _build.load_library()
    payload_t = payload_t.contiguous()
    ends = torch.cumsum(n_touched, 0, dtype=torch.int32)
    g = torch.empty(instance_cap, dtype=torch.int32, device=n_touched.device)
    rank = torch.empty_like(g)
    pl_t = torch.empty((4, instance_cap), dtype=torch.int32, device=n_touched.device)
    stream = torch.cuda.current_stream(n_touched.device).cuda_stream
    err = lib.lfs_expand_instances(
        ends.data_ptr(), payload_t.data_ptr(), n_touched.shape[0], instance_cap,
        g.data_ptr(), rank.data_ptr(), pl_t.data_ptr(), stream,
    )
    _build.check(err, "lfs_expand_instances")
    expand_instances.launches += 1
    return g, rank, pl_t


expand_instances.launches = 0  # kernel launches since the last reset


# csrc/expand.cu's partition: threads a block, merge steps a thread
THREADS, ITEMS = 256, 4
PIECE = THREADS * ITEMS


def _merge_split(ends: list[int], cap: int, d: int) -> int:
    """How many ends lie among the first d merge items (end i sits at
    i + min(ends[i], cap)), by csrc/expand.cu::merge_split's 32-ary search:
    each round lane l probes one point, one ballot narrows the range."""
    lo, hi = 0, len(ends)
    while True:
        span = hi - lo
        each = span <= 32
        probes = [lo + lane if each else lo + span * (lane + 1) // 33 for lane in range(32)]
        k = sum(p < hi and p + min(ends[p], cap) < d for p in probes)
        if each:
            return lo + k
        if k > 0:
            lo = probes[k - 1] + 1
        if k < 32:
            hi = probes[k]


def expand_partition_plain(
    n_touched: torch.Tensor, payload_t: torch.Tensor, instance_cap: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """expand_instances computed as csrc/expand.cu computes it, in plain
    Python: the merge of the slots with `ends` (the inclusive cumsum of
    n_touched) cut into pieces of PIECE items, each piece's two cuts by
    the 32-ary search, its slice of `ends` staged, each thread's diagonal
    found within the piece and walked ITEMS steps, an end at or below the
    slot first. Slow; for the tests."""
    ends = torch.cumsum(n_touched.long(), 0).tolist()
    n, cap = len(ends), instance_cap
    owner = [-1] * cap
    total = n + cap
    for d0 in range(0, total, PIECE):
        d1 = min(d0 + PIECE, total)
        i0, i1 = _merge_split(ends, cap, d0), _merge_split(ends, cap, d1)
        j0, na = d0 - i0, i1 - i0
        nb = d1 - i1 - j0
        a = ends[i0:i1]
        for t in range(THREADS):
            dt = min(t * ITEMS, na + nb)
            lo, hi = max(0, dt - nb), min(dt, na)
            while lo < hi:
                mid = (lo + hi) // 2
                if mid + min(max(a[mid] - j0, 0), nb) < dt:
                    lo = mid + 1
                else:
                    hi = mid
            i, j = lo, dt - lo
            for _ in range(dt, min(dt + ITEMS, na + nb)):
                if i < na and (j >= nb or a[i] <= j0 + j):
                    i += 1
                else:
                    owner[j0 + j] = i0 + i
                    j += 1
    g = torch.clamp(torch.tensor(owner, dtype=torch.int64), max=n - 1)
    ends_t = torch.tensor([0] + ends, dtype=torch.int64)
    rank = torch.arange(cap, dtype=torch.int64) - ends_t[g]
    return g.to(torch.int32), rank.to(torch.int32), payload_t.cpu()[:, g]
