"""Kernel P2 (forward tile blend) and kernel P3 (blend backward) wrappers,
and `blend_fused`, the autograd Function that joins them with P4
(counterpart of lichtfeld_studio_tpu/kernels/blend_pallas.py::
blend_pallas_fused and its custom VJP `_blend_gathered`).

Inputs are the tile binning (tile_start / tile_count over the compact,
depth-sorted `gaussian_idx`) and the PER-GAUSSIAN projected features; the
kernels gather each instance's features themselves. Colours are float32
with 3 channels, or 4 when depth rides as the fourth. Images are over the
padded tile grid [Hp, Wp]; tiles are 16 or 32 px.

CUDA tensors launch csrc/blend_forward.cu and csrc/blend_backward.cu; CPU
tensors take the plain versions: dense per-tile blends on ops/blend_ref.py
(a port of lichtfeld_studio_tpu/ops/blend_tiles.py with no k_max
truncation), differentiated by autograd for the backward.

The backward's tail trim (the JAX package's GRAD_SKIP_EPS, default 1/255,
blend_pallas.py:74-86): the training forward also returns, per tile,
`tile_neff`, 1 + the last 128-instance window of the tile whose largest
blending weight over the tile's pixels, T_entry - T_exit, is at least eps
(at least 1; FULL_REPLAY where eps is 0 or the tile has more windows than
pixels). Windows are aligned to the global sorted position, as the TPU
kernel's chunks are. The backward gives every instance at or past window
`tile_neff` a zero row and every other instance its exact row.
"""

from __future__ import annotations

import os

import torch

from lichtfeld_studio_tpu_torch.kernels import _build
from lichtfeld_studio_tpu_torch.kernels.segment_reduce import segment_reduce
from lichtfeld_studio_tpu_torch.ops.blend_ref import blend_weights, compute_alphas
from lichtfeld_studio_tpu_torch.ops.projection import TRANSMITTANCE_THRESHOLD
from lichtfeld_studio_tpu_torch.profiling import stage

# Inference termination threshold: what is left out after stopping at
# transmittance T is at most T (colours <= 1), so 1/512 stays under half a
# u8 step (the JAX package's INFERENCE_TERM_THRESHOLD). The training blend
# has none: the reference done flag at 1e-4 is its only rule (the JAX
# package's freeze=True).
INFERENCE_TERM_THRESHOLD = 1.0 / 512.0
TILE_SIZES = (16, 32)
# The backward's tail trim (see the module docstring); 0 replays every
# counted contribution. A launch argument of both kernels, read at each call.
GRAD_SKIP_EPS = float(os.environ.get("LFS_GRAD_SKIP_EPS", str(1.0 / 255.0)))
TRIM_WINDOW = 128  # the TPU backward's chunk on the compact training layout
FULL_REPLAY = 1 << 30  # tile_neff of a tile that is not trimmed
# elements per [tiles, K, P] intermediate of the plain versions; tiles are
# blended in groups that keep each intermediate under this size
_PLAIN_CHUNK_ELEMS = 1 << 24


def _check(fn: str, device: torch.device, expect: dict) -> None:
    """Raise unless each tensor has its dtype and shape, is contiguous and
    lies on `device`."""
    for name, (t, dtype, shape) in expect.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{fn}: {name} must be {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
        if t.device != device:
            raise ValueError(f"{fn}: {name} is on {t.device}, mean2d on {device}")


def _check_inputs(fn, tile_start, tile_count, gaussian_idx, mean2d, conic, opacity,
                  color, grid_w, grid_h, tile_size):
    n_tiles = grid_w * grid_h
    n = mean2d.shape[0]
    if color.ndim != 2 or color.shape[1] not in (3, 4):
        raise ValueError(f"{fn}: color must be [N, 3 or 4], got {tuple(color.shape)}")
    if tile_size not in TILE_SIZES:
        raise ValueError(f"{fn}: tiles are {TILE_SIZES} px, got {tile_size}")
    _check(fn, mean2d.device, {
        "tile_start": (tile_start, torch.int32, (n_tiles,)),
        "tile_count": (tile_count, torch.int32, (n_tiles,)),
        "gaussian_idx": (gaussian_idx, torch.int32, (gaussian_idx.shape[0],)),
        "mean2d": (mean2d, torch.float32, (n, 2)),
        "conic": (conic, torch.float32, (n, 3)),
        "opacity": (opacity, torch.float32, (n,)),
        "color": (color, torch.float32, (n, color.shape[1])),
    })


def _device_kind(fn: str, t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {t.device}")
    return t.device.type


# --- the plain versions: dense per-tile blends over groups of tiles ---------

def _plain_groups(tile_count: torch.Tensor, n_pix: int) -> list[tuple[int, int, int]]:
    """(first tile, end tile, K) groups: K is the group's deepest tile, and
    tiles x K x pixels stays under _PLAIN_CHUNK_ELEMS."""
    groups, t0, k_max = [], 0, 1
    counts = tile_count.cpu().tolist()
    for t, c in enumerate(counts):
        k_new = max(k_max, c)
        if t > t0 and (t + 1 - t0) * k_new * n_pix > _PLAIN_CHUNK_ELEMS:
            groups.append((t0, t, k_max))
            t0, k_new = t, max(c, 1)
        k_max = k_new
    groups.append((t0, len(counts), k_max))
    return groups


def _gather_group(t0, t1, k_max, tile_start, tile_count, gaussian_idx, grid_w, ts):
    """Instance positions [t, K], their in-range mask, owners, the depth
    ranks [K] and pixel centres [t, P] of tiles t0..t1."""
    dev = tile_start.device
    tids = torch.arange(t0, t1, device=dev)
    k = torch.arange(k_max, device=dev)
    idx = torch.clamp(tile_start[t0:t1, None].long() + k[None, :], 0, gaussian_idx.shape[0] - 1)
    in_range = k[None, :] < tile_count[t0:t1, None]
    g = gaussian_idx[idx].long()
    p = torch.arange(ts * ts, device=dev)
    px = ((tids % grid_w) * ts)[:, None] + (p % ts)[None, :]
    py = ((tids // grid_w) * ts)[:, None] + (p // ts)[None, :]
    return idx, in_range, g, k, px.to(torch.float32) + 0.5, py.to(torch.float32) + 0.5


def _group_blend(in_range, px, py, mean2d, conic, opacity, color, threshold):
    """Composite gathered [t, K, ...] instances: (colour [t, P, C],
    T_final [t, P], counted-and-not-skipped mask [t, K, P])."""
    alphas = compute_alphas(mean2d, conic, torch.where(in_range, opacity, 0.0), px, py)
    w, counted = blend_weights(alphas, threshold)
    color_out = torch.einsum("tkp,tkc->tpc", w, torch.clamp(color, min=0.0))
    t_final = torch.where(counted, 1.0 - alphas, 1.0).prod(dim=-2)
    return color_out, t_final, counted & (alphas > 0.0)


def _untile(x: torch.Tensor, grid_w: int, grid_h: int, ts: int) -> torch.Tensor:
    """[T, P, ...] per-tile pixels -> [Hp, Wp, ...] image."""
    rest = x.shape[2:]
    x = x.reshape(grid_h, grid_w, ts, ts, *rest).transpose(1, 2)
    return x.reshape(grid_h * ts, grid_w * ts, *rest)


def _tile(x: torch.Tensor, grid_w: int, grid_h: int, ts: int) -> torch.Tensor:
    """[Hp, Wp, ...] image -> [T, P, ...] per-tile pixels."""
    rest = x.shape[2:]
    x = x.reshape(grid_h, ts, grid_w, ts, *rest).transpose(1, 2)
    return x.reshape(grid_h * grid_w, ts * ts, *rest)


def blend_forward_plain(
    tile_start, tile_count, gaussian_idx, mean2d, conic, opacity, color,
    *, grid_w: int, grid_h: int, tile_size: int, train: bool = False,
):
    """Dense per-tile blend: each group's instances up to its deepest tile's
    count, alphas [tiles, K, P], masked prefix products. The training
    variant's tile_neff comes from tile_neff_plain at GRAD_SKIP_EPS."""
    dev = mean2d.device
    ts = tile_size
    n_tiles = grid_w * grid_h
    n_pix = ts * ts
    out_c = torch.empty((n_tiles, n_pix, color.shape[1]), dtype=torch.float32, device=dev)
    out_t = torch.empty((n_tiles, n_pix), dtype=torch.float32, device=dev)
    out_l = torch.empty((n_tiles, n_pix), dtype=torch.int32, device=dev)
    for t0, t1, k_max in _plain_groups(tile_count, n_pix):
        _, in_range, g, k, px, py = _gather_group(
            t0, t1, k_max, tile_start, tile_count, gaussian_idx, grid_w, ts)
        c, t_final, contrib = _group_blend(
            in_range, px, py, mean2d[g], conic[g], opacity[g], color[g],
            0.0 if train else INFERENCE_TERM_THRESHOLD)
        out_c[t0:t1] = c
        out_t[t0:t1] = t_final
        if train:
            out_l[t0:t1] = torch.where(contrib, k[None, :, None], -1).amax(dim=1).to(torch.int32)
    image = _untile(out_c, grid_w, grid_h, ts)
    t_final = _untile(out_t, grid_w, grid_h, ts)
    if train:
        neff = tile_neff_plain(tile_start, tile_count, gaussian_idx, mean2d, conic, opacity,
                               grid_w=grid_w, tile_size=ts, eps=GRAD_SKIP_EPS)
        return image, 1.0 - t_final, t_final, _untile(out_l, grid_w, grid_h, ts), neff
    return image, 1.0 - t_final


def tile_neff_plain(tile_start, tile_count, gaussian_idx, mean2d, conic, opacity, *,
                    grid_w: int, tile_size: int, eps: float):
    """int32 [tiles]: the tail trim's tile_neff (module docstring), from a
    walk in depth over every tile at once in P2's float32 operation order,
    so that T is the kernel's to the bit. A pixel's weight in a window is
    T at the window's entry less T at its exit; at the done crossing the
    pixel's T drops to the crossing product (as the TPU kernel's unfrozen
    product does) and the pixel stops there."""
    dev = mean2d.device
    ts, n_pix, win = tile_size, tile_size * tile_size, TRIM_WINDOW
    count = tile_count.long()
    off = tile_start.long() % win
    neff = torch.full(count.shape, FULL_REPLAY, dtype=torch.int32, device=dev)
    if not eps > 0.0:
        return neff
    order = torch.argsort(count, descending=True, stable=True)  # deepest first
    cnt, start, off_o = count[order], tile_start.long()[order], off[order]
    p = torch.arange(n_pix, device=dev)
    px = (((order % grid_w) * ts)[:, None] + (p % ts)[None, :]).to(torch.float32) + 0.5
    py = (((order // grid_w) * ts)[:, None] + (p // ts)[None, :]).to(torch.float32) + 0.5
    t = torch.ones((order.shape[0], n_pix), dtype=torch.float32, device=dev)
    t_entry = torch.ones_like(t)
    done = torch.zeros_like(t, dtype=torch.bool)
    last_sig = torch.full_like(t, -1, dtype=torch.long)  # last window with weight >= eps

    def close(m, window, ending):  # the window `window` [m] ends in the tiles `ending` [m]
        heavy = ending[:, None] & (t_entry[:m] - t[:m] >= eps)
        last_sig[:m] = torch.where(heavy, torch.maximum(last_sig[:m], window[:, None]),
                                   last_sig[:m])

    counts = cnt.tolist()
    m = len(counts)
    for k in range(counts[0] if counts else 0):
        while counts[m - 1] <= k:  # tiles this deep: a prefix of the order
            m -= 1
        pos = off_o[:m] + k
        edge = (pos % win == 0) & (k > 0)
        close(m, pos // win - 1, edge)
        t_entry[:m] = torch.where(edge[:, None], t[:m], t_entry[:m])
        g = gaussian_idx[start[:m] + k].long()
        a = compute_alphas(mean2d[g][:, None], conic[g][:, None], opacity[g][:, None],
                           px[:m], py[:m])[:, 0]
        a = torch.where(done[:m], 0.0, a)
        nxt = t[:m] * (1.0 - a)
        t[:m] = torch.where(a > 0.0, nxt, t[:m])
        done[:m] |= (a > 0.0) & (nxt < TRANSMITTANCE_THRESHOLD)
    close(len(counts), (off_o + cnt - 1) // win, cnt > 0)
    n_eff = torch.clamp(last_sig.amax(dim=1) + 1, min=1)
    n_eff = torch.where((off_o + cnt + win - 1) // win > n_pix, FULL_REPLAY, n_eff)
    neff[order] = n_eff.to(torch.int32)
    return neff


def blend_forward(
    tile_start: torch.Tensor,  # [T] int32 — first instance of each tile
    tile_count: torch.Tensor,  # [T] int32 — instances of each tile
    gaussian_idx: torch.Tensor,  # [I] int32 — owning gaussian, tile/depth order
    mean2d: torch.Tensor,  # [N, 2] f32
    conic: torch.Tensor,  # [N, 3] f32
    opacity: torch.Tensor,  # [N] f32
    color: torch.Tensor,  # [N, 3 or 4] f32 (unclamped)
    *,
    grid_w: int,
    grid_h: int,
    tile_size: int,
    train: bool = False,
):
    """(image [Hp, Wp, C], alpha [Hp, Wp]). The inference blend stops a
    pixel at T < 1/512; the training blend (`train`) keeps only the done
    flag and also returns the final transmittance [Hp, Wp] f32, the index
    within the tile's range of each pixel's last counted contribution
    [Hp, Wp] int32 (-1 if none), which the backward reads, and the tail
    trim's tile_neff [T] int32 at GRAD_SKIP_EPS as it is at the call."""
    _check_inputs("blend_forward", tile_start, tile_count, gaussian_idx, mean2d, conic,
                  opacity, color, grid_w, grid_h, tile_size)
    kw = dict(grid_w=grid_w, grid_h=grid_h, tile_size=tile_size)
    if _device_kind("blend_forward", mean2d) == "cpu":
        return blend_forward_plain(tile_start, tile_count, gaussian_idx, mean2d, conic,
                                   opacity, color, train=train, **kw)
    out = _launch_blend_forward((tile_start, tile_count, gaussian_idx, mean2d, conic, opacity,
                                 color), grid_w, grid_h, tile_size, train)
    blend_forward.launches += 1
    return out


blend_forward.launches = 0  # kernel launches since the last reset


def _launch_blend_forward(args, grid_w, grid_h, tile_size, train, stats=None):
    """Launch csrc/blend_forward.cu on checked CUDA tensors; with `stats`
    (int64 [3]) its counting instance."""
    lib = _build.load_library()
    dev = args[3].device
    # the kernel reads mean2d in 8-byte and 4-channel colours in 16-byte pieces
    mean2d, color = args[3], args[6]
    args = (*args[:3], mean2d if mean2d.data_ptr() % 8 == 0 else mean2d.clone(), *args[4:6],
            color if color.shape[1] == 3 or color.data_ptr() % 16 == 0 else color.clone())
    hp, wp = grid_h * tile_size, grid_w * tile_size
    image = torch.empty((hp, wp, args[6].shape[1]), dtype=torch.float32, device=dev)
    alpha = torch.empty((hp, wp), dtype=torch.float32, device=dev)
    t_final = torch.empty((hp, wp), dtype=torch.float32, device=dev) if train else None
    last = torch.empty((hp, wp), dtype=torch.int32, device=dev) if train else None
    neff = torch.empty(grid_w * grid_h, dtype=torch.int32, device=dev) if train else None
    order_scratch = torch.empty(grid_w * grid_h, dtype=torch.int32, device=dev)
    ptrs = (*(t.data_ptr() for t in args), args[6].shape[1], grid_w, grid_h, tile_size,
            INFERENCE_TERM_THRESHOLD, GRAD_SKIP_EPS, image.data_ptr(), alpha.data_ptr(),
            *((t.data_ptr() for t in (t_final, last, neff)) if train else (None,) * 3))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if stats is None:
        _build.check(lib.lfs_blend_forward(*ptrs, order_scratch.data_ptr(), stream),
                     "lfs_blend_forward")
    else:
        _build.check(lib.lfs_blend_forward_stats(*ptrs, stats.data_ptr(), order_scratch.data_ptr(),
                                                 stream), "lfs_blend_forward_stats")
    return (image, alpha, t_final, last, neff) if train else (image, alpha)


def blend_forward_skip_stats(*args, grid_w: int, grid_h: int, tile_size: int,
                             train: bool = False) -> dict:
    """blend_forward's arguments -> what its reach test did on them, from
    the kernel's counting instance (a diagnostic, not on any path): the
    (warp, instance) pairs walked, those skipped because the instance
    cannot reach the warp's patch, and the (pixel, instance) pairs inside
    skipped ones that would have passed the alpha test (0 unless the reach
    is not conservative). For CUDA tensors only."""
    if args[3].device.type != "cuda":
        raise ValueError(f"blend_forward_skip_stats: the counts come from the kernel, got {args[3].device}")
    stats = torch.zeros(3, dtype=torch.int64, device=args[3].device)
    _launch_blend_forward(args, grid_w, grid_h, tile_size, train, stats)
    walked, skipped, lost = stats.tolist()
    return {"warp_pairs": walked, "skipped": skipped, "lost": lost}


def trim_extent(tile_start: torch.Tensor, tile_count: torch.Tensor, tile_neff: torch.Tensor):
    """int64 [T]: each tile's instances that the tail trim keeps, the ones
    before sorted position base + TRIM_WINDOW * tile_neff, where base is
    tile_start rounded down to a multiple of TRIM_WINDOW."""
    off = tile_start.long() % TRIM_WINDOW
    return torch.clamp(TRIM_WINDOW * tile_neff.long() - off, max=tile_count.long())


def trim_tail_slots(tile_start, tile_count, tile_neff, slot_layout) -> torch.Tensor:
    """int64: the pre-sort slots of the instances the tail trim drops (the
    rows that blend_backward leaves 0 for it). Tile ranges are consecutive
    in sorted order (tile_start is the running sum of tile_count)."""
    start, count = tile_start.long(), tile_count.long()
    pos = torch.arange(slot_layout.shape[0], device=slot_layout.device)
    tile = torch.searchsorted(start + count, pos, right=True)
    live = tile < start.shape[0]
    tile = tile.clamp(max=start.shape[0] - 1)
    in_tail = live & (pos - start[tile] >= trim_extent(tile_start, tile_count, tile_neff)[tile])
    return slot_layout[in_tail].long()


def blend_backward_plain(
    tile_start, tile_count, gaussian_idx, slot_layout, mean2d, conic, opacity, color,
    t_final, last, tile_neff, d_image, d_alpha, *, grid_w: int, grid_h: int, tile_size: int,
) -> torch.Tensor:
    """Recompute each group's dense training blend under autograd, backprop
    its cotangent, and write each instance's gradient row to its pre-sort
    slot; the rows of the instances the tail trim drops (past trim_extent)
    stay 0. Memory stays bounded by the group size. (t_final and last are
    recomputed, so they are not read.)"""
    ts = tile_size
    n_pix = ts * ts
    n_ch = color.shape[1]
    out = torch.zeros((slot_layout.shape[0], 6 + n_ch), dtype=torch.float32, device=mean2d.device)
    g_img = _tile(d_image, grid_w, grid_h, ts)
    g_t = -_tile(d_alpha, grid_w, grid_h, ts)  # alpha = 1 - T_final
    kept = trim_extent(tile_start, tile_count, tile_neff)
    for t0, t1, k_max in _plain_groups(tile_count, n_pix):
        idx, in_range, g, k, px, py = _gather_group(
            t0, t1, k_max, tile_start, tile_count, gaussian_idx, grid_w, ts)
        leaves = [x[g].detach().requires_grad_(True) for x in (mean2d, conic, opacity, color)]
        with torch.enable_grad():
            c, t_fin, _ = _group_blend(in_range, px, py, *leaves, 0.0)
            grads = torch.autograd.grad((c, t_fin), leaves, (g_img[t0:t1], g_t[t0:t1]))
        rows = torch.cat([grads[0], grads[1], grads[2][..., None], grads[3]], dim=-1)
        rows = torch.where((k[None, :] < kept[t0:t1, None])[..., None], rows, 0.0)
        out[slot_layout[idx[in_range]].long()] = rows[in_range]
    return out


def blend_backward(
    tile_start: torch.Tensor,  # [T] int32
    tile_count: torch.Tensor,  # [T] int32
    gaussian_idx: torch.Tensor,  # [I] int32 — owner per sorted position
    slot_layout: torch.Tensor,  # [I] int32 — pre-sort slot per sorted position
    mean2d: torch.Tensor,  # [N, 2]
    conic: torch.Tensor,  # [N, 3]
    opacity: torch.Tensor,  # [N]
    color: torch.Tensor,  # [N, C] (unclamped)
    t_final: torch.Tensor,  # [Hp, Wp] from the training forward
    last: torch.Tensor,  # [Hp, Wp] int32 from the training forward
    tile_neff: torch.Tensor,  # [T] int32 from the training forward
    d_image: torch.Tensor,  # [Hp, Wp, C] cotangent
    d_alpha: torch.Tensor,  # [Hp, Wp] cotangent
    *,
    grid_w: int,
    grid_h: int,
    tile_size: int,
) -> torch.Tensor:
    """Per-instance gradient rows [I, 6 + C] in PRE-SORT slot order:
    (d_mean2d x, y, d_conic a, b, c, d_opacity, d_colour...). Rows of slots
    that no counted contribution reaches, or that the tail trim drops, are
    0."""
    fn = "blend_backward"
    _check_inputs(fn, tile_start, tile_count, gaussian_idx, mean2d, conic, opacity, color,
                  grid_w, grid_h, tile_size)
    hp, wp, n_ch = grid_h * tile_size, grid_w * tile_size, color.shape[1]
    _check(fn, mean2d.device, {
        "slot_layout": (slot_layout, torch.int32, tuple(gaussian_idx.shape)),
        "t_final": (t_final, torch.float32, (hp, wp)),
        "last": (last, torch.int32, (hp, wp)),
        "tile_neff": (tile_neff, torch.int32, (grid_w * grid_h,)),
        "d_image": (d_image, torch.float32, (hp, wp, n_ch)),
        "d_alpha": (d_alpha, torch.float32, (hp, wp)),
    })
    kw = dict(grid_w=grid_w, grid_h=grid_h, tile_size=tile_size)
    args = (tile_start, tile_count, gaussian_idx, slot_layout, mean2d, conic, opacity, color,
            t_final, last, tile_neff, d_image, d_alpha)
    if _device_kind(fn, mean2d) == "cpu":
        return blend_backward_plain(*args, **kw)
    out = _launch_blend_backward(args, n_ch, grid_w, grid_h, tile_size)
    blend_backward.launches += 1
    return out


blend_backward.launches = 0  # kernel launches since the last reset


def _launch_blend_backward(args, n_ch, grid_w, grid_h, tile_size, stats=None) -> torch.Tensor:
    """Launch csrc/blend_backward.cu on checked CUDA tensors; with `stats`
    (int64 [4]) its counting instance."""
    (tile_start, tile_count, gaussian_idx, slot_layout, mean2d, conic, opacity, color,
     t_final, last, tile_neff, d_image, d_alpha) = args
    lib = _build.load_library()
    dev = tile_start.device
    # the kernel reads the four images in 16-byte vectors
    t_final, last, d_image, d_alpha = (t if t.data_ptr() % 16 == 0 else t.clone()
                                       for t in (t_final, last, d_image, d_alpha))
    out = torch.zeros((slot_layout.shape[0], 6 + n_ch), dtype=torch.float32, device=dev)
    order_scratch = torch.empty(grid_w * grid_h, dtype=torch.int32, device=dev)
    err = lib.lfs_blend_backward(
        *(t.data_ptr() for t in (tile_start, tile_count, gaussian_idx, slot_layout, mean2d, conic,
                                 opacity, color)),
        n_ch, grid_w, grid_h, tile_size,
        *(t.data_ptr() for t in (t_final, last, tile_neff, d_image, d_alpha)), out.data_ptr(),
        stats.data_ptr() if stats is not None else None, order_scratch.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "lfs_blend_backward")
    return out


def blend_backward_skip_stats(tile_start, tile_count, gaussian_idx, slot_layout, mean2d, conic,
                              opacity, color, t_final, last, tile_neff, d_image, d_alpha, *,
                              grid_w: int, grid_h: int, tile_size: int) -> dict:
    """blend_backward's arguments -> what its reach test and tail trim did
    on them, from the kernel's counting instance (a diagnostic, not on the
    training path): the (warp, instance) pairs walked, those skipped
    because the instance cannot reach the warp's patch, those that ended in
    a warp reduction, and those that the trim kept out of one (a pixel of
    the warp counts the instance, which lies past the trim); and from
    tile_neff the 128-instance windows and the instances of the tiles'
    ranges, with the shares the trim drops. For arguments that
    blend_backward took on a CUDA device."""
    if tile_start.device.type != "cuda":
        raise ValueError(f"blend_backward_skip_stats: the counts come from the kernel, got {tile_start.device}")
    stats = torch.zeros(4, dtype=torch.int64, device=tile_start.device)
    _launch_blend_backward((tile_start, tile_count, gaussian_idx, slot_layout, mean2d, conic,
                            opacity, color, t_final, last, tile_neff, d_image, d_alpha),
                           color.shape[1], grid_w, grid_h, tile_size, stats)
    walked, skipped, reduced, trimmed = stats.tolist()
    off = tile_start.long() % TRIM_WINDOW
    windows = (off + tile_count.long() + TRIM_WINDOW - 1) // TRIM_WINDOW
    kept = trim_extent(tile_start, tile_count, tile_neff)
    return {"warp_pairs": walked, "skipped": skipped, "reduced": reduced,
            "trimmed_pairs": trimmed,
            "windows": int(windows.sum()),
            "trimmed_windows": int((windows - torch.minimum(tile_neff.long(), windows)).sum()),
            "instances": int(tile_count.long().sum()),
            "trimmed_instances": int((tile_count.long() - kept).sum())}


# The reach of csrc/blend_common.cuh (reach_2d), its margins mirrored (for
# the tests and chip_smoke.py's bounds)
SIGMA_MARGIN, REACH_REL, REACH_ABS, MIN_CONDITION = 1e-3, 1.001, 1e-3, 1e-3


def _patch_pixels(ts: int, device) -> torch.Tensor:
    """[8, n] a tile's pixel indices of each warp's patch (csrc/blend_common.cuh)."""
    pw, ph = ts // 2, ts // 4
    ys, xs = torch.meshgrid(torch.arange(ph, device=device), torch.arange(pw, device=device),
                            indexing="ij")
    within = (ys * ts + xs).reshape(-1)
    return torch.stack([(w >> 1) * ph * ts + (w & 1) * pw + within for w in range(8)])


def reach_2d_plain(mean2d, conic, opacity) -> torch.Tensor:
    """[N, 4] the box (x lo, x hi, y lo, y hi) of the pixel centres where
    each gaussian can pass the alpha test, in plain PyTorch: the ellipse
    sigma <= log(255 op) with reach_2d's margins; unbounded where an input
    is not finite or the conic is ill-conditioned, empty where op < 1/255."""
    mx, my = mean2d.unbind(-1)
    a, b, c = conic.unbind(-1)
    inf = float("inf")
    finite = torch.isfinite(mx + my + a + b + c + opacity)
    smax = torch.where(opacity > 0.0, torch.log(opacity * 255.0) + SIGMA_MARGIN, -1.0)
    det = a * c - b * b
    conditioned = (a > 0.0) & (c > 0.0) & (det > MIN_CONDITION * a * c)
    s2 = 2.0 * torch.clamp(smax, min=0.0)
    rx = torch.sqrt(s2 * c / det) * REACH_REL + REACH_ABS
    ry = torch.sqrt(s2 * a / det) * REACH_REL + REACH_ABS
    box = torch.stack([mx - rx, mx + rx, my - ry, my + ry], dim=-1)
    unbounded = box.new_tensor([-inf, inf, -inf, inf])
    box = torch.where((finite & conditioned)[:, None], box, unbounded)
    return torch.where((finite & ~(smax >= 0.0))[:, None], box.new_tensor([inf, -inf, inf, -inf]),
                       box)


def patch_reach_skip_group(box, in_range, t0: int, t1: int, grid_w: int, ts: int):
    """bool [t, 8, K]: the warp patches of tiles t0..t1 (csrc/blend_common.cuh's
    Patch) that the reach box [t, K, 4] of each gathered instance misses."""
    tids = torch.arange(t0, t1, device=box.device)
    w = torch.arange(8, device=box.device)
    pw, ph = ts // 2, ts // 4
    x_lo = (((tids % grid_w) * ts)[:, None] + (w & 1) * pw + 0.5)[..., None]  # [t, 8, 1]
    y_lo = (((tids // grid_w) * ts)[:, None] + (w >> 1) * ph + 0.5)[..., None]
    b = box[:, None]  # [t, 1, K, 4]
    misses = ((b[..., 0] > x_lo + (pw - 1)) | (b[..., 1] < x_lo)
              | (b[..., 2] > y_lo + (ph - 1)) | (b[..., 3] < y_lo))
    return misses & in_range[:, None]


class _BlendFused(torch.autograd.Function):
    """Training blend: P2 (train=True) forward; P3 then P4 backward, to
    per-gaussian gradients."""

    @staticmethod
    def forward(ctx, mean2d, conic, opacity, color, tile_start, tile_count, gaussian_idx,
                slot_layout, segment_off, grid_w, grid_h, tile_size):
        kw = dict(grid_w=grid_w, grid_h=grid_h, tile_size=tile_size)
        image, alpha, t_final, last, tile_neff = blend_forward(
            tile_start, tile_count, gaussian_idx, mean2d, conic, opacity, color, train=True, **kw)
        ctx.save_for_backward(tile_start, tile_count, gaussian_idx, slot_layout, segment_off,
                              mean2d, conic, opacity, color, t_final, last, tile_neff)
        ctx.kw = kw
        return image, alpha

    @staticmethod
    def backward(ctx, d_image, d_alpha):
        (tile_start, tile_count, gaussian_idx, slot_layout, segment_off,
         mean2d, conic, opacity, color, t_final, last, tile_neff) = ctx.saved_tensors
        with stage("P3"):
            rows = blend_backward(
                tile_start, tile_count, gaussian_idx, slot_layout, mean2d, conic, opacity, color,
                t_final, last, tile_neff, d_image.contiguous(), d_alpha.contiguous(), **ctx.kw)
        with stage("P4"):
            grads = segment_reduce(rows, segment_off)  # [N, 6 + C]
        return (grads[:, 0:2], grads[:, 2:5], grads[:, 5], grads[:, 6:],
                None, None, None, None, None, None, None, None)


def blend_fused(
    mean2d: torch.Tensor,  # [N, 2]
    conic: torch.Tensor,  # [N, 3]
    opacity: torch.Tensor,  # [N]
    color: torch.Tensor,  # [N, C]
    assignment,  # ops.tiles.TileAssignment built with need_grad=True
    *,
    grid_w: int,
    grid_h: int,
    tile_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Differentiable training blend: (image [Hp, Wp, C], alpha [Hp, Wp]),
    with gradients to mean2d, conic, opacity and color."""
    if assignment.segment_off is None:
        raise ValueError("blend_fused needs a TileAssignment built with need_grad=True")
    return _BlendFused.apply(
        mean2d.contiguous(), conic.contiguous(), opacity.contiguous(), color.contiguous(),
        assignment.tile_start, assignment.tile_count, assignment.gaussian_idx,
        assignment.slot_layout, assignment.segment_off, grid_w, grid_h, tile_size,
    )
