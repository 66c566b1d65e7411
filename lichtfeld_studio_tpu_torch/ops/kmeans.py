"""K-means for the SOG codebooks (counterpart of
lichtfeld_studio_tpu/ops/kmeans.py; reference kernels/kmeans.cu:1-307, used
by the SOG writer through cluster_1d/cluster_nd, src/core/sogs.cpp:38-52).

Lloyd iterations on torch tensors, on whatever device the input lies on.
1-D: initialised from the sorted values at strided positions, labels by
searchsorted over the sorted centroids' midpoints. N-D: initialised from k
distinct points drawn from `seed`, labels by argmin of |c|^2 - 2 p.c (a
float32 torch.matmul with TF32 off, as the JAX package pins
Precision.HIGHEST), in chunks of points so that the [chunk, k] distances
stay under _DIST_CHUNK_ELEMS. Updates are index_add_ of sums and counts.
"""

from __future__ import annotations

import torch

# elements of one [points, k] distance chunk (1 GiB of float32)
_DIST_CHUNK_ELEMS = 1 << 28


def _labels_1d(values: torch.Tensor, c_sorted: torch.Tensor) -> torch.Tensor:
    mids = 0.5 * (c_sorted[1:] + c_sorted[:-1])
    return torch.searchsorted(mids, values).to(torch.int32)


def _update(points: torch.Tensor, labels: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Mean of each cluster's points; an empty cluster keeps its centroid."""
    k = centroids.shape[0]
    idx = labels.long()
    sums = torch.zeros_like(centroids).index_add_(0, idx, points)
    counts = torch.zeros(k, dtype=points.dtype, device=points.device).index_add_(
        0, idx, torch.ones_like(idx, dtype=points.dtype))
    if points.ndim == 2:
        counts = counts[:, None]
    return torch.where(counts > 0, sums / torch.clamp(counts, min=1), centroids)


@torch.no_grad()
def kmeans_1d(values: torch.Tensor, k: int = 256, iterations: int = 10):
    """1-D k-means. Returns (centroids [k] sorted, labels [N] int32)."""
    values = values.to(torch.float32)
    n = values.shape[0]
    sorted_v = torch.sort(values).values
    pos = (torch.arange(k, dtype=torch.float32, device=values.device) + 0.5) / k * (n - 1)
    centroids = sorted_v[pos.to(torch.int64)]
    for _ in range(iterations):
        c_sorted = torch.sort(centroids).values
        centroids = _update(values, _labels_1d(values, c_sorted), c_sorted)
    c_sorted = torch.sort(centroids).values
    return c_sorted, _labels_1d(values, c_sorted)


def _labels_nd(points: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """argmin_j |c_j|^2 - 2 p.c_j per point, over chunks of points."""
    n, k = points.shape[0], centroids.shape[0]
    c2 = (centroids * centroids).sum(1)[None, :]
    ct = centroids.T.contiguous()
    step = max(1, _DIST_CHUNK_ELEMS // max(k, 1))
    labels = torch.empty(n, dtype=torch.int32, device=points.device)
    for i in range(0, n, step):
        d2 = c2 - 2.0 * torch.matmul(points[i:i + step], ct)
        labels[i:i + step] = torch.argmin(d2, dim=1).to(torch.int32)
    return labels


@torch.no_grad()
def kmeans_nd(points: torch.Tensor, k: int, iterations: int = 10, seed: int = 0,
              init_idx: torch.Tensor | None = None):
    """N-D k-means. points [N, D]. Returns (centroids [k, D], labels [N]
    int32). `init_idx` [k] picks the initial centroids; by default k
    distinct points (k <= N) or k draws with replacement, from a CPU
    torch.Generator seeded with `seed`."""
    points = points.to(torch.float32)
    n = points.shape[0]
    if init_idx is None:
        gen = torch.Generator().manual_seed(seed)
        init_idx = (torch.randperm(n, generator=gen)[:k] if k <= n
                    else torch.randint(n, (k,), generator=gen))
    centroids = points[init_idx.to(device=points.device, dtype=torch.int64)]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for _ in range(iterations):
            centroids = _update(points, _labels_nd(points, centroids), centroids)
        return centroids, _labels_nd(points, centroids)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
