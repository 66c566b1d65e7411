"""Kernels P5 (world-space blend forward) and P6 (its backward), their plain
versions, and `world_blend_fused`, the autograd Function that joins them
with P4 (counterpart of lichtfeld_studio_tpu/kernels/world_blend_pallas.py::
world_blend_pallas and its custom VJP `_world_blend_gathered2`).

The per-gaussian stream [N, 24] (global shutter) or [N, 32] (rolling
shutter) folds each gaussian's world-space evaluation into two 3x3
matrices. For a GLOBAL shutter every pixel ray shares the camera origin o,
so with M = diag(1/s) R^T and gro = M (o - mean), a pixel with direction d
has the squared min Mahalanobis distance

    dist = |C d|^2 / |M d|^2,   C = -skew(gro) M

and s = dist / (2 ln 2) - log2(op) is alpha's exponent in log2 units:
alpha = min(2^-s, 0.999). Rows (f32; the JAX package held the colours as
two bf16 pairs with a straight-through quantizer, dropped here):

    global   0-8 C' = C / sqrt(2 ln 2) (row-major), 9-17 M, 18 -log2(op),
             19-22 colour (r, g, b, aux = depth or 0), 23 zero
    rolling  0-8 C0', 9-17 C1', 18-26 M, 27 -log2(op), 28-31 colour

Rolling shutter: the origin moves affinely in the pixel's shutter time tau
(o(tau) = o_start + tau (o_end - o_start)), so C(tau) = C0 + tau C1; the
directions stay exact (per-scanline slerp, ops/world_blend.py), only the
origin path is chordal (exact for translation-only motion).

The stream is built by differentiable torch ops, so autograd carries
d(stream) back to means, scales, rotations, opacities and colours. CUDA
tensors launch csrc/world_blend_forward.cu (P5) and
csrc/world_blend_backward.cu (P6); CPU tensors take the plain versions:
the same stream-form math as dense per-tile blends in groups of tiles,
differentiated by autograd for the backward.
"""

from __future__ import annotations

import math

import torch

from lichtfeld_studio_tpu_torch.kernels import _build
from lichtfeld_studio_tpu_torch.kernels.blend import (
    TILE_SIZES,
    _check,
    _device_kind,
    _gather_group,
    _plain_groups,
    _tile,
    _untile,
)
from lichtfeld_studio_tpu_torch.kernels.segment_reduce import segment_reduce
from lichtfeld_studio_tpu_torch.ops.blend_ref import blend_weights
from lichtfeld_studio_tpu_torch.ops.gaussians import quat_to_rotmat
from lichtfeld_studio_tpu_torch.ops.projection import MAX_FRAGMENT_ALPHA
from lichtfeld_studio_tpu_torch.profiling import stage

STREAM_ROWS = 24
STREAM_ROWS_RS = 32
_INV_SQRT_2LN2 = 1.0 / math.sqrt(2.0 * math.log(2.0))
_LOG2_MAX_S = math.log2(255.0)  # keep alpha_raw >= 1/255 <=> s <= log2(255)


class _Layout:
    """Column offsets of a stream row (csrc/world_blend_common.cuh Layout)."""

    def __init__(self, rs: bool):
        self.rs = rs
        self.rows = STREAM_ROWS_RS if rs else STREAM_ROWS
        self.z = 18 if rs else 9
        self.nlog = 27 if rs else 18
        self.color = 28 if rs else 19


def _frame_matrix(log_scales, quats):
    """M = diag(1/s) R^T per gaussian, [N, 3, 3] (rows m_i = R[:, i] / s_i)."""
    qn = quats / torch.clamp(torch.linalg.norm(quats, dim=-1, keepdim=True), min=1e-12)
    return torch.exp(-log_scales)[:, :, None] * quat_to_rotmat(qn).transpose(-1, -2)


def _matvec(m, v):
    """[N, 3, 3] @ [N, 3] as explicit float32 sums."""
    return (m * v[:, None, :]).sum(-1)


def _cross_rows(g, m):
    """-skew(g) @ m, [N, 3, 3]: row k of the result dotted with d is
    (M d x g)_k, the cross product the per-pixel evaluation takes."""
    g0, g1, g2 = g[:, 0:1], g[:, 1:2], g[:, 2:3]
    m0, m1, m2 = m[:, 0], m[:, 1], m[:, 2]
    return torch.stack([g2 * m1 - g1 * m2, g0 * m2 - g2 * m0, g1 * m0 - g0 * m1], dim=1)


def _tail_columns(opacity, color, depth):
    n = opacity.shape[0]
    aux = depth if depth is not None else torch.zeros((n,), dtype=color.dtype, device=color.device)
    return [-torch.log2(torch.clamp(opacity, min=1e-12))[:, None], color[:, :3], aux[:, None]]


def pack_world_stream(
    means: torch.Tensor,  # [N, 3]
    log_scales: torch.Tensor,  # [N, 3]
    quats: torch.Tensor,  # [N, 4]
    opacity: torch.Tensor,  # [N] activated
    color: torch.Tensor,  # [N, 3]
    ray_o: torch.Tensor,  # [3] the camera origin (global shutter)
    depth: torch.Tensor | None = None,  # [N] for the depth channel
) -> torch.Tensor:
    """Per-gaussian stream [N, 24] (module docstring), differentiable."""
    m = _frame_matrix(log_scales, quats)
    gro = _matvec(m, ray_o[None, :] - means)
    c = _cross_rows(gro, m)
    n = means.shape[0]
    return torch.cat([c.reshape(n, 9) * _INV_SQRT_2LN2, m.reshape(n, 9),
                      *_tail_columns(opacity, color, depth), torch.zeros_like(opacity)[:, None]],
                     dim=-1).contiguous()


def pack_world_stream_rs(
    means: torch.Tensor,  # [N, 3]
    log_scales: torch.Tensor,  # [N, 3]
    quats: torch.Tensor,  # [N, 4]
    opacity: torch.Tensor,  # [N] activated
    color: torch.Tensor,  # [N, 3]
    o_start: torch.Tensor,  # [3] start-of-frame camera origin
    o_end: torch.Tensor,  # [3] end-of-frame camera origin
    depth: torch.Tensor | None = None,
) -> torch.Tensor:
    """Rolling-shutter stream [N, 32] (module docstring), differentiable."""
    m = _frame_matrix(log_scales, quats)
    gro0 = _matvec(m, o_start[None, :] - means)
    u = _matvec(m, (o_end - o_start)[None, :].expand_as(means))
    n = means.shape[0]
    return torch.cat([_cross_rows(gro0, m).reshape(n, 9) * _INV_SQRT_2LN2,
                      _cross_rows(u, m).reshape(n, 9) * _INV_SQRT_2LN2, m.reshape(n, 9),
                      *_tail_columns(opacity, color, depth)], dim=-1).contiguous()


def _layout_of(fn: str, stream: torch.Tensor, tau: torch.Tensor | None) -> _Layout:
    if stream.ndim != 2 or stream.shape[1] not in (STREAM_ROWS, STREAM_ROWS_RS):
        raise ValueError(f"{fn}: stream must be [N, {STREAM_ROWS} or {STREAM_ROWS_RS}], "
                         f"got {tuple(stream.shape)}")
    lay = _Layout(stream.shape[1] == STREAM_ROWS_RS)
    if (tau is not None) != lay.rs:
        raise ValueError(f"{fn}: tau is required with the {STREAM_ROWS_RS}-row rolling-shutter "
                         "stream and only with it")
    return lay


def _check_inputs(fn, stream, rays_d, tau, tile_start, tile_count, gaussian_idx, n_channels,
                  grid_w, grid_h, tile_size) -> _Layout:
    lay = _layout_of(fn, stream, tau)
    if tile_size not in TILE_SIZES:
        raise ValueError(f"{fn}: tiles are {TILE_SIZES} px, got {tile_size}")
    if n_channels not in (3, 4):
        raise ValueError(f"{fn}: 3 or 4 channels, got {n_channels}")
    n_pix = grid_w * grid_h * tile_size * tile_size
    expect = {
        "stream": (stream, torch.float32, tuple(stream.shape)),
        "rays_d": (rays_d, torch.float32, (n_pix, 3)),
        "tile_start": (tile_start, torch.int32, (grid_w * grid_h,)),
        "tile_count": (tile_count, torch.int32, (grid_w * grid_h,)),
        "gaussian_idx": (gaussian_idx, torch.int32, (gaussian_idx.shape[0],)),
    }
    if tau is not None:
        expect["tau"] = (tau, torch.float32, (n_pix,))
    _check(fn, stream.device, expect)
    return lay


# --- the plain versions: dense per-tile blends over groups of tiles ---------

def _stream_num_den(f, d, tau, lay: _Layout):
    """|y|^2 and |z|^2 [t, K, P] of gathered stream rows f [t, K, R] against
    the tile's directions d [t, P, 3] (and shutter times tau [t, P]), in
    the operation order of csrc/world_blend_common.cuh."""
    d0, d1, d2 = (d[:, None, :, j] for j in range(3))  # [t, 1, P]

    def lin(col):
        return (f[..., col, None] * d0 + f[..., col + 1, None] * d1) + f[..., col + 2, None] * d2

    y = [lin(3 * k) for k in range(3)]
    if lay.rs:
        y = [y[k] + tau[:, None, :] * lin(9 + 3 * k) for k in range(3)]
    z = [lin(lay.z + 3 * k) for k in range(3)]
    num = (y[0] * y[0] + y[1] * y[1]) + y[2] * y[2]
    den = (z[0] * z[0] + z[1] * z[1]) + z[2] * z[2]
    return num, den


def _stream_alphas(f, d, tau, in_range, lay: _Layout):
    """alpha [t, K, P] of gathered stream rows f [t, K, R] against the
    tile's directions d [t, P, 3] (and shutter times tau [t, P]), in the
    operation order of csrc/world_blend_common.cuh."""
    num, den = _stream_num_den(f, d, tau, lay)
    s = num / torch.clamp(den, min=1e-30) + f[..., lay.nlog, None]
    keep = (s <= _LOG2_MAX_S) & in_range[..., None]
    return torch.where(keep, torch.clamp(torch.exp2(-s), max=MAX_FRAGMENT_ALPHA), 0.0)


def _group_world_blend(f, d, tau, in_range, lay: _Layout, n_channels: int):
    """(colour [t, P, C], T_final [t, P], counted-and-not-skipped mask
    [t, K, P]) of one group's gathered rows."""
    alphas = _stream_alphas(f, d, tau, in_range, lay)
    w, counted = blend_weights(alphas, 0.0)
    col = f[..., lay.color:lay.color + n_channels]
    color_out = torch.einsum("tkp,tkc->tpc", w, torch.where(col > 0.0, col, 0.0))
    t_final = torch.where(counted, 1.0 - alphas, 1.0).prod(dim=-2)
    return color_out, t_final, counted & (alphas > 0.0)


def _tile_rays(rays_d, tau, grid_w, grid_h, ts):
    d = _tile(rays_d.reshape(grid_h * ts, grid_w * ts, 3), grid_w, grid_h, ts)
    t = _tile(tau.reshape(grid_h * ts, grid_w * ts), grid_w, grid_h, ts) if tau is not None else None
    return d, t


def world_blend_forward_plain(
    stream, rays_d, tau, tile_start, tile_count, gaussian_idx, *, n_channels: int,
    grid_w: int, grid_h: int, tile_size: int,
):
    """Dense per-tile blend of the stream in groups of tiles: what
    world_blend_forward returns."""
    lay = _Layout(stream.shape[1] == STREAM_ROWS_RS)
    ts = tile_size
    n_tiles, n_pix = grid_w * grid_h, ts * ts
    dev = stream.device
    d_t, tau_t = _tile_rays(rays_d, tau, grid_w, grid_h, ts)
    out_c = torch.empty((n_tiles, n_pix, n_channels), dtype=torch.float32, device=dev)
    out_t = torch.empty((n_tiles, n_pix), dtype=torch.float32, device=dev)
    out_l = torch.empty((n_tiles, n_pix), dtype=torch.int32, device=dev)
    for t0, t1, k_max in _plain_groups(tile_count, n_pix):
        _, in_range, g, k, _, _ = _gather_group(t0, t1, k_max, tile_start, tile_count,
                                                gaussian_idx, grid_w, ts)
        c, t_final, contrib = _group_world_blend(
            stream[g], d_t[t0:t1], tau_t[t0:t1] if tau_t is not None else None, in_range, lay,
            n_channels)
        out_c[t0:t1] = c
        out_t[t0:t1] = t_final
        out_l[t0:t1] = torch.where(contrib, k[None, :, None], -1).amax(dim=1).to(torch.int32)
    t_final = _untile(out_t, grid_w, grid_h, ts)
    return (_untile(out_c, grid_w, grid_h, ts), 1.0 - t_final, t_final,
            _untile(out_l, grid_w, grid_h, ts))


def world_blend_forward(
    stream: torch.Tensor,  # [N, 24 | 32] f32 per-gaussian stream
    rays_d: torch.Tensor,  # [Hp*Wp, 3] f32 world ray directions, row-major pixels
    tau: torch.Tensor | None,  # [Hp*Wp] f32 shutter times (rolling shutter only)
    tile_start: torch.Tensor,  # [T] int32
    tile_count: torch.Tensor,  # [T] int32
    gaussian_idx: torch.Tensor,  # [I] int32 — owner per sorted instance
    *,
    n_channels: int,
    grid_w: int,
    grid_h: int,
    tile_size: int,
):
    """(image [Hp, Wp, C], alpha [Hp, Wp], final transmittance [Hp, Wp]
    f32, each pixel's last counted index within its tile's range [Hp, Wp]
    int32 (-1 if none)); P6 reads the last two. Training and the forward
    frame composite alike (the done flag at 1e-4 only), so both call this."""
    fn = "world_blend_forward"
    lay = _check_inputs(fn, stream, rays_d, tau, tile_start, tile_count, gaussian_idx,
                        n_channels, grid_w, grid_h, tile_size)
    kw = dict(n_channels=n_channels, grid_w=grid_w, grid_h=grid_h, tile_size=tile_size)
    if _device_kind(fn, stream) == "cpu":
        return world_blend_forward_plain(stream, rays_d, tau, tile_start, tile_count,
                                         gaussian_idx, **kw)
    out = _launch_world_blend_forward((tile_start, tile_count, gaussian_idx, stream, rays_d, tau),
                                      lay, n_channels, grid_w, grid_h, tile_size)
    world_blend_forward.launches += 1
    return out


world_blend_forward.launches = 0  # kernel launches since the last reset


def _launch_world_blend_forward(args, lay: _Layout, n_ch, grid_w, grid_h, tile_size, stats=None):
    """Launch csrc/world_blend_forward.cu on checked CUDA tensors; with
    `stats` (int64 [3]) its counting instance. Returns (image, alpha,
    T_final, last)."""
    lib = _build.load_library()
    # the kernel reads the rays and times in 16-byte vectors
    args = args[:4] + tuple(t if t is None or t.data_ptr() % 16 == 0 else t.clone()
                            for t in args[4:])
    tile_start, tile_count, gaussian_idx, stream, rays_d, tau = args
    dev = stream.device
    hp, wp = grid_h * tile_size, grid_w * tile_size
    image = torch.empty((hp, wp, n_ch), dtype=torch.float32, device=dev)
    alpha = torch.empty((hp, wp), dtype=torch.float32, device=dev)
    t_final = torch.empty((hp, wp), dtype=torch.float32, device=dev)
    last = torch.empty((hp, wp), dtype=torch.int32, device=dev)
    ptrs = (tile_start.data_ptr(), tile_count.data_ptr(), gaussian_idx.data_ptr(),
            stream.data_ptr(), lay.rows, rays_d.data_ptr(), tau.data_ptr() if lay.rs else None,
            n_ch, grid_w, grid_h, tile_size, image.data_ptr(), alpha.data_ptr(),
            t_final.data_ptr(), last.data_ptr())
    order_scratch = torch.empty(grid_w * grid_h, dtype=torch.int32, device=dev)
    cuda_stream = torch.cuda.current_stream(dev).cuda_stream
    if stats is None:
        _build.check(lib.lfs_world_blend_forward(*ptrs, order_scratch.data_ptr(), cuda_stream),
                     "lfs_world_blend_forward")
    else:
        _build.check(lib.lfs_world_blend_forward_stats(*ptrs, stats.data_ptr(),
                                                       order_scratch.data_ptr(), cuda_stream),
                     "lfs_world_blend_forward_stats")
    return image, alpha, t_final, last


def world_blend_forward_skip_stats(*args, n_channels: int, grid_w: int, grid_h: int,
                                   tile_size: int) -> dict:
    """world_blend_forward's arguments -> what its ray-space skip did on
    them, from the kernel's counting instance (a diagnostic, not on any
    path): the (warp, instance) pairs walked, those skipped, and the pixels,
    not yet done, inside skipped pairs or dropped before z whose evaluation
    passes the keep test (0 unless a bound is not conservative). For CUDA
    tensors only."""
    stream, rays_d, tau, tile_start, tile_count, gaussian_idx = args
    if stream.device.type != "cuda":
        raise ValueError(f"world_blend_forward_skip_stats: the counts come from the kernel, got "
                         f"{stream.device}")
    lay = _check_inputs("world_blend_forward_skip_stats", stream, rays_d, tau, tile_start,
                        tile_count, gaussian_idx, n_channels, grid_w, grid_h, tile_size)
    stats = torch.zeros(3, dtype=torch.int64, device=stream.device)
    _launch_world_blend_forward((tile_start, tile_count, gaussian_idx, stream, rays_d, tau), lay,
                                n_channels, grid_w, grid_h, tile_size, stats)
    walked, skipped, lost = stats.tolist()
    return {"warp_pairs": walked, "skipped": skipped, "lost": lost}


def world_blend_backward_plain(
    stream, rays_d, tau, tile_start, tile_count, gaussian_idx, slot_layout, t_final, last,
    d_image, d_alpha, *, grid_w: int, grid_h: int, tile_size: int,
) -> torch.Tensor:
    """Recompute each group's dense blend under autograd, backprop its
    cotangent to the gathered stream rows, and write each instance's row to
    its pre-sort slot. (t_final and last are recomputed, so not read.)"""
    lay = _Layout(stream.shape[1] == STREAM_ROWS_RS)
    ts = tile_size
    n_pix, n_ch = ts * ts, d_image.shape[2]
    out = torch.zeros((slot_layout.shape[0], lay.rows), dtype=torch.float32, device=stream.device)
    d_t, tau_t = _tile_rays(rays_d, tau, grid_w, grid_h, ts)
    g_img = _tile(d_image, grid_w, grid_h, ts)
    g_t = -_tile(d_alpha, grid_w, grid_h, ts)  # alpha = 1 - T_final
    for t0, t1, k_max in _plain_groups(tile_count, n_pix):
        idx, in_range, g, _, _, _ = _gather_group(t0, t1, k_max, tile_start, tile_count,
                                                  gaussian_idx, grid_w, ts)
        f = stream[g].detach().requires_grad_(True)
        with torch.enable_grad():
            c, t_fin, _ = _group_world_blend(
                f, d_t[t0:t1], tau_t[t0:t1] if tau_t is not None else None, in_range, lay, n_ch)
            (rows,) = torch.autograd.grad((c, t_fin), (f,), (g_img[t0:t1], g_t[t0:t1]))
        out[slot_layout[idx[in_range]].long()] = rows[in_range]
    return out


def world_blend_backward(
    stream: torch.Tensor,  # [N, 24 | 32]
    rays_d: torch.Tensor,  # [Hp*Wp, 3]
    tau: torch.Tensor | None,  # [Hp*Wp] (rolling shutter only)
    tile_start: torch.Tensor,  # [T] int32
    tile_count: torch.Tensor,  # [T] int32
    gaussian_idx: torch.Tensor,  # [I] int32 — owner per sorted position
    slot_layout: torch.Tensor,  # [I] int32 — pre-sort slot per sorted position
    t_final: torch.Tensor,  # [Hp, Wp] from P5
    last: torch.Tensor,  # [Hp, Wp] int32 from P5
    d_image: torch.Tensor,  # [Hp, Wp, C] cotangent
    d_alpha: torch.Tensor,  # [Hp, Wp] cotangent
    *,
    grid_w: int,
    grid_h: int,
    tile_size: int,
) -> torch.Tensor:
    """Per-instance gradient rows [I, 24 | 32] in PRE-SORT slot order, in
    the stream's layout (d/d(-log2 op), not d/d(op)). Rows of slots that no
    counted contribution reaches are 0."""
    fn = "world_blend_backward"
    n_ch = d_image.shape[-1] if d_image.ndim == 3 else 0
    lay = _check_inputs(fn, stream, rays_d, tau, tile_start, tile_count, gaussian_idx, n_ch,
                        grid_w, grid_h, tile_size)
    hp, wp = grid_h * tile_size, grid_w * tile_size
    _check(fn, stream.device, {
        "slot_layout": (slot_layout, torch.int32, tuple(gaussian_idx.shape)),
        "t_final": (t_final, torch.float32, (hp, wp)),
        "last": (last, torch.int32, (hp, wp)),
        "d_image": (d_image, torch.float32, (hp, wp, n_ch)),
        "d_alpha": (d_alpha, torch.float32, (hp, wp)),
    })
    kw = dict(grid_w=grid_w, grid_h=grid_h, tile_size=tile_size)
    if _device_kind(fn, stream) == "cpu":
        return world_blend_backward_plain(stream, rays_d, tau, tile_start, tile_count,
                                          gaussian_idx, slot_layout, t_final, last, d_image,
                                          d_alpha, **kw)
    out = _launch_world_blend_backward(
        (tile_start, tile_count, gaussian_idx, slot_layout, stream, rays_d, tau, t_final, last,
         d_image, d_alpha), lay, n_ch, grid_w, grid_h, tile_size)
    world_blend_backward.launches += 1
    return out


world_blend_backward.launches = 0  # kernel launches since the last reset


def _launch_world_blend_backward(args, lay: _Layout, n_ch, grid_w, grid_h, tile_size,
                                 stats=None) -> torch.Tensor:
    """Launch csrc/world_blend_backward.cu on checked CUDA tensors; with
    `stats` (int64 [4]) its counting instance."""
    lib = _build.load_library()
    # the kernel reads the per-pixel inputs in 16-byte vectors
    args = args[:5] + tuple(t if t is None or t.data_ptr() % 16 == 0 else t.clone()
                            for t in args[5:])
    (tile_start, tile_count, gaussian_idx, slot_layout, stream, rays_d, tau, t_final, last,
     d_image, d_alpha) = args
    out = torch.zeros((slot_layout.shape[0], lay.rows), dtype=torch.float32, device=stream.device)
    ptrs = (tile_start.data_ptr(), tile_count.data_ptr(), gaussian_idx.data_ptr(),
            slot_layout.data_ptr(), stream.data_ptr(), lay.rows, rays_d.data_ptr(),
            tau.data_ptr() if lay.rs else None, n_ch, grid_w, grid_h, tile_size,
            t_final.data_ptr(), last.data_ptr(), d_image.data_ptr(), d_alpha.data_ptr(),
            out.data_ptr())
    order_scratch = torch.empty(grid_w * grid_h, dtype=torch.int32, device=stream.device)
    cuda_stream = torch.cuda.current_stream(stream.device).cuda_stream
    if stats is None:
        _build.check(lib.lfs_world_blend_backward(*ptrs, order_scratch.data_ptr(), cuda_stream),
                     "lfs_world_blend_backward")
    else:
        _build.check(lib.lfs_world_blend_backward_stats(*ptrs, stats.data_ptr(),
                                                        order_scratch.data_ptr(), cuda_stream),
                     "lfs_world_blend_backward_stats")
    return out


def world_blend_backward_skip_stats(*args, grid_w: int, grid_h: int, tile_size: int) -> dict:
    """world_blend_backward's arguments -> what its ray-space skip did on
    them, from the kernel's counting instance (a diagnostic, not on the
    training path): the (warp, instance) pairs walked, those skipped, the
    (pixel, instance) pairs inside skipped ones that P5 counted (0 unless
    the bound is not conservative), and the pairs that ended in a warp
    reduction. For CUDA tensors only."""
    (stream, rays_d, tau, tile_start, tile_count, gaussian_idx, slot_layout, t_final, last,
     d_image, d_alpha) = args
    if stream.device.type != "cuda":
        raise ValueError(f"world_blend_backward_skip_stats: the counts come from the kernel, got "
                         f"{stream.device}")
    stats = torch.zeros(4, dtype=torch.int64, device=stream.device)
    _launch_world_blend_backward(
        (tile_start, tile_count, gaussian_idx, slot_layout, stream, rays_d, tau, t_final, last,
         d_image, d_alpha), _layout_of("world_blend_backward_skip_stats", stream, tau),
        d_image.shape[-1], grid_w, grid_h, tile_size, stats)
    walked, skipped, lost, reduced = stats.tolist()
    return {"warp_pairs": walked, "skipped": skipped, "lost": lost, "reduced": reduced}


# The ray-space skip of P5 and P6 (csrc/world_blend_common.cuh's ray_bound),
# its margins mirrored (for the tests and chip_smoke.py's bounds)
RAY_REL, RAY_ABS, SKIP_MARGIN, MIN_DEN = 1.001, 1e-5, 1e-3, 1e-29


def patch_ray_skip_group(f, d, tau, in_range, lay: _Layout, patch_pix, with_den_hi=False):
    """bool [t, 8, K]: the patches of each tile (patch_pix [8, n], the
    pixels of each: kernels/blend.py::_patch_pixels) that the ray-space
    bound of P5 and P6 lets skip each gathered row of f [t, K, R], for the
    tile's rays d [t, P, 3]. With `with_den_hi` also the bound's ceiling of
    |z|^2 over each patch [t, 8, K] (inf where it is not trusted)."""
    dp = d[:, patch_pix]  # [t, 8, n, 3]
    c = dp.mean(dim=2)
    dmax = torch.linalg.norm(dp, dim=-1).amax(dim=2)
    eps = torch.linalg.norm(dp - c[:, :, None], dim=-1).amax(dim=2) * RAY_REL + RAY_ABS * dmax
    dmax = dmax * RAY_REL
    t, k = f.shape[:2]

    def mat(col):
        return f[..., col:col + 9].reshape(t, k, 3, 3)

    c0, m = mat(0), mat(lay.z)
    y = torch.einsum("tkrj,twj->twkr", c0, c)
    n0, nm = (torch.linalg.norm(x.reshape(t, k, 9), dim=-1)[:, None] for x in (c0, m))
    slack = n0 * eps[..., None]
    finite = torch.isfinite(c.sum(-1) + eps + dmax)
    if lay.rs:
        tp = tau[:, patch_pix]  # [t, 8, n]
        ct = tp.mean(dim=2)
        eps_t = (tp - ct[..., None]).abs().amax(dim=2) * RAY_REL + RAY_ABS
        c1 = mat(9)
        n1 = torch.linalg.norm(c1.reshape(t, k, 9), dim=-1)[:, None]
        y = y + ct[..., None, None] * torch.einsum("tkrj,twj->twkr", c1, c)
        slack = slack + ct.abs()[..., None] * n1 * eps[..., None] + n1 * (eps_t * dmax)[..., None]
        finite &= torch.isfinite(ct + eps_t)
    yl = torch.linalg.norm(y, dim=-1)
    zl = torch.linalg.norm(torch.einsum("tkrj,twj->twkr", m, c), dim=-1)
    lo = torch.clamp(yl - slack, min=0.0)
    den = (zl + nm * eps[..., None]) ** 2
    nlog = f[..., lay.nlog][:, None]
    trusted = finite[..., None] & torch.isfinite(yl + zl + slack + den + nlog) & (den >= MIN_DEN)
    skip = trusted & (lo * lo / den + nlog > _LOG2_MAX_S + SKIP_MARGIN) & in_range[:, None]
    if not with_den_hi:
        return skip
    return skip, torch.where(trusted, den, float("inf"))


def pixel_reject_group(f, d, tau, lay: _Layout, den_hi, patch_of):
    """bool [t, K, P]: the (pixel, instance) pairs that P5 drops on |y|^2
    alone (csrc/world_blend_common.cuh::reject_above: |y|^2 above what the
    patch's ceiling of |z|^2, den_hi [t, 8, K] from patch_ray_skip_group,
    allows), patch_of [P] each pixel's patch."""
    num, _ = _stream_num_den(f, d, tau, lay)
    m = (_LOG2_MAX_S - f[..., lay.nlog]) * (1.0 + 1e-6) + 1e-5  # [t, K]
    top = m[:, None] * den_hi * (1.0 + 1e-5)
    top = torch.where(torch.isfinite(den_hi) & ~torch.isnan(top), top, float("inf"))
    return num > top[:, patch_of].transpose(1, 2)


class _WorldBlendFused(torch.autograd.Function):
    """Training world blend: P5 forward; P6 then P4 backward,
    to d(stream) [N, rows]."""

    @staticmethod
    def forward(ctx, stream, rays_d, tau, tile_start, tile_count, gaussian_idx, slot_layout,
                segment_off, n_channels, grid_w, grid_h, tile_size):
        kw = dict(grid_w=grid_w, grid_h=grid_h, tile_size=tile_size)
        image, alpha, t_final, last = world_blend_forward(
            stream, rays_d, tau, tile_start, tile_count, gaussian_idx, n_channels=n_channels,
            **kw)
        ctx.save_for_backward(stream, rays_d, tau, tile_start, tile_count, gaussian_idx,
                              slot_layout, segment_off, t_final, last)
        ctx.kw = kw
        return image, alpha

    @staticmethod
    def backward(ctx, d_image, d_alpha):
        (stream, rays_d, tau, tile_start, tile_count, gaussian_idx, slot_layout, segment_off,
         t_final, last) = ctx.saved_tensors
        with stage("P6"):
            rows = world_blend_backward(
                stream, rays_d, tau, tile_start, tile_count, gaussian_idx, slot_layout, t_final,
                last, d_image.contiguous(), d_alpha.contiguous(), **ctx.kw)
        with stage("P4"):
            d_stream = segment_reduce(rows, segment_off)  # [N, rows]
        return (d_stream,) + (None,) * 11


def world_blend_fused(
    stream: torch.Tensor,  # [N, 24 | 32]
    rays_d: torch.Tensor,  # [Hp*Wp, 3]
    tau: torch.Tensor | None,  # [Hp*Wp] (rolling shutter only)
    assignment,  # ops.tiles.TileAssignment built with need_grad=True
    *,
    n_channels: int,
    grid_w: int,
    grid_h: int,
    tile_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Differentiable world blend: (image [Hp, Wp, C], alpha [Hp, Wp]), with
    gradients to the stream."""
    if assignment.segment_off is None:
        raise ValueError("world_blend_fused needs a TileAssignment built with need_grad=True")
    return _WorldBlendFused.apply(
        stream.contiguous(), rays_d.contiguous(), tau, assignment.tile_start,
        assignment.tile_count, assignment.gaussian_idx, assignment.slot_layout,
        assignment.segment_off, n_channels, grid_w, grid_h, tile_size,
    )
