"""Wrappers of the microbenchmark kernels T1a, T1b, T2 and T3 (counterparts
of the Pallas kernels of tools/microbench_bf16_vpu.py,
tools/microbench_dma_stream.py and tools/microbench_scan_orient.py).

Each asks the card about one mechanism the blend kernels could use:

* `alu_elementwise` (T1a, csrc/microbench_alu.cu): four dependent
  elementwise operations, float32 against packed bf16 pairs;
* `scan_prod` (T1b, csrc/microbench_alu.cu): a 128-deep log-step prefix
  product, by lane shuffles or by shared-memory shifts, float32 and bf16;
* `stream_ring` (T2, csrc/microbench_stream.cu): chunks streamed through a
  4-slot cp.async ring, as strided row segments or one contiguous block;
* `scan_orient` (T3, csrc/microbench_scan.cu): the blend's recurrence with
  the depth axis across a warp's lanes or serial inside a thread.

Each computes what its TPU original computes, so that its plain PyTorch
version (beside it here) can hold it. CUDA tensors launch the kernel or
raise; CPU tensors take the plain version. Each wrapper counts its
launches.
"""

from __future__ import annotations

import torch

from lichtfeld_studio_tpu_torch.kernels import _build

DEPTH = 128  # the scanned axis (the blends' chunk of instances)
WIDTH = 1024  # the other axis of a slab (the pixels of a 32-px tile)
REPS = 64
ELEMWISE_C = 1.0000001
SCAN_DECAY = 0.999999
_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _launch(x: torch.Tensor, what: str):
    """The library and the stream for a CUDA tensor; raises for any other
    device but the CPU (whose caller took the plain version already)."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    return _build.load_library(), torch.cuda.current_stream(x.device).cuda_stream


def _check_slabs(x: torch.Tensor, what: str, shape=(DEPTH, WIDTH)) -> None:
    if x.dtype != torch.float32 or x.ndim != 3 or tuple(x.shape[1:]) != shape or x.shape[0] < 1:
        raise ValueError(f"{what}: x must be float32 [G, {shape[0]}, {shape[1]}], "
                         f"got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous")


# --- T1a ---------------------------------------------------------------------
def alu_elementwise_plain(x: torch.Tensor, *, dtype: str = "f32", reps: int = REPS) -> torch.Tensor:
    t = _DTYPES[dtype]
    acc = x.to(t)
    c = torch.tensor(ELEMWISE_C, dtype=torch.float32).to(t).to(x.device)
    for _ in range(reps):  # 4 dependent operations, each rounded in `t`
        acc = acc * c
        acc = acc + acc
        acc = acc * 0.5
        acc = torch.clamp(acc, min=0.0)
    return acc.to(torch.float32)


def alu_elementwise(x: torch.Tensor, *, dtype: str = "f32", reps: int = REPS) -> torch.Tensor:
    """`reps` times (x * c, x + x, x * 0.5, max(x, 0)) in `dtype` ("f32" or
    "bf16") on x [G, 128, 1024] f32; f32 out of the same shape."""
    _check_slabs(x, "alu_elementwise")
    if dtype not in _DTYPES:
        raise ValueError(f"alu_elementwise: dtype must be 'f32' or 'bf16', got {dtype!r}")
    if x.device.type == "cpu":
        return alu_elementwise_plain(x, dtype=dtype, reps=reps)
    lib, stream = _launch(x, "alu_elementwise")
    out = torch.empty_like(x)
    err = lib.lfs_mb_alu_elementwise(x.data_ptr(), out.data_ptr(), x.shape[0], reps, ELEMWISE_C,
                                     int(dtype == "bf16"), stream)
    _build.check(err, "lfs_mb_alu_elementwise")
    alu_elementwise.launches += 1
    return out


alu_elementwise.launches = 0


# --- T1b ---------------------------------------------------------------------
def log_step_scan(x: torch.Tensor, op, pad: float, dim: int) -> torch.Tensor:
    """Hillis-Steele inclusive scan along `dim`: x[i] = op(x[i], x[i - s])
    for s = 1, 2, 4, ..., with `pad` where i < s (the shift-and-pad scan of
    the TPU originals, level by level)."""
    n = x.shape[dim]
    shift = 1
    while shift < n:
        head = torch.full_like(x.narrow(dim, 0, shift), pad)
        x = op(x, torch.cat([head, x.narrow(dim, 0, n - shift)], dim=dim))
        shift *= 2
    return x


def scan_prod_plain(x: torch.Tensor, *, dtype: str = "f32", reps: int = REPS) -> torch.Tensor:
    t = _DTYPES[dtype]
    acc = x.to(t)
    k = torch.tensor(SCAN_DECAY, dtype=torch.float32).to(t).to(x.device)
    for _ in range(reps):
        acc = log_step_scan(acc, torch.mul, 1.0, dim=-2) * k
    return acc.to(torch.float32)


def scan_prod(x: torch.Tensor, *, dtype: str = "f32", impl: str = "shfl",
              reps: int = REPS) -> torch.Tensor:
    """`reps` times the log-step inclusive prefix product along the
    128-deep axis of x [G, 128, 1024] f32, then * 0.999999, in `dtype`;
    `impl` is the shift mechanism, "shfl" (lane shuffles) or "smem"
    (shared memory). Both give the same values."""
    _check_slabs(x, "scan_prod")
    if dtype not in _DTYPES or impl not in ("shfl", "smem"):
        raise ValueError(f"scan_prod: dtype {dtype!r} / impl {impl!r} not known")
    if x.device.type == "cpu":
        return scan_prod_plain(x, dtype=dtype, reps=reps)
    lib, stream = _launch(x, "scan_prod")
    out = torch.empty_like(x)
    err = lib.lfs_mb_scan_prod(x.data_ptr(), out.data_ptr(), x.shape[0], reps, SCAN_DECAY,
                               int(dtype == "bf16"), int(impl == "smem"), stream)
    _build.check(err, "lfs_mb_scan_prod")
    scan_prod.launches += 1
    return out


scan_prod.launches = 0


# --- T2 ----------------------------------------------------------------------
def stream_ring_plain(x: torch.Tensor, *, width: int, blocks: int = 1) -> torch.Tensor:
    """Element [0, 0] of every chunk, summed over each block's range of
    chunks (in float64, rounded once: the kernel adds in float32, one chunk
    after the other)."""
    nb = x.shape[1] // width
    per = -(-nb // blocks)
    first = torch.zeros(blocks * per, dtype=torch.float64, device=x.device)
    first[:nb] = x[0, ::width].to(torch.float64)
    return first.view(blocks, per).sum(1).to(torch.float32)


def stream_ring(x: torch.Tensor, *, width: int, blocks: int = 1) -> torch.Tensor:
    """Stream the chunks x[:, i * width : (i + 1) * width] of x [rows,
    nb * width] f32 through the ring; [blocks] f32 partial sums of each
    chunk's element [0, 0], block b over chunks [b * per, (b + 1) * per),
    per = ceil(nb / blocks)."""
    if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"stream_ring: x must be contiguous float32 [rows, nb * width], "
                         f"got {x.dtype} {tuple(x.shape)}")
    rows, total = x.shape
    if width < 4 or width % 4 or total % width or total == 0:
        raise ValueError(f"stream_ring: width {width} must be a multiple of 4 that divides "
                         f"{total}")
    nb = total // width
    if not 1 <= blocks <= nb:
        raise ValueError(f"stream_ring: blocks must be in [1, {nb}], got {blocks}")
    if x.device.type == "cpu":
        return stream_ring_plain(x, width=width, blocks=blocks)
    lib, stream = _launch(x, "stream_ring")
    out = torch.empty(blocks, dtype=torch.float32, device=x.device)
    err = lib.lfs_mb_stream_ring(x.data_ptr(), rows, width, nb, blocks, out.data_ptr(), stream)
    _build.check(err, "lfs_mb_stream_ring")
    stream_ring.launches += 1
    return out


stream_ring.launches = 0


# --- T3 ----------------------------------------------------------------------
def scan_orient_plain(x: torch.Tensor, *, orient: str, reps: int = REPS
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """orient "lanes": x [G, P, 128], log-step scans along the last axis,
    out [G, 1, 128] the sums of the slab's last pixel. orient "thread":
    x [G, 128, P], torch.cumprod / cumsum along the depth axis (the serial
    order on the CPU), out [G, 1, P] each pixel's total product."""
    acc = torch.zeros_like(x[:, :1] if orient == "thread" else x[:, -1:])
    for _ in range(reps):
        a = 1.0 - 1e-4 * x
        if orient == "thread":
            p = torch.cumprod(a, dim=1)
            s = torch.cumsum(x * p, dim=1)
            acc = acc + p[:, -1:]
        else:
            p = log_step_scan(a, torch.mul, 1.0, dim=2)
            s = log_step_scan(x * p, torch.add, 0.0, dim=2)
            acc = acc + s[:, -1:]
        x = x * 0.9999 + 1e-7 * s
    return acc, x


def scan_orient(x: torch.Tensor, *, orient: str, reps: int = REPS
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """`reps` times: p = prefix product of 1 - 1e-4 x, s = prefix sum of
    x * p along the 128-deep axis, x = 0.9999 x + 1e-7 s. orient "lanes":
    x [G, P, 128], the depth across a warp's lanes; "thread": x [G, 128, P]
    (P a multiple of 128), the depth serial inside the thread that owns the
    pixel. Returns (out, the final x): out [G, 1, 128] or [G, 1, P] as
    `scan_orient_plain` says."""
    if orient not in ("lanes", "thread"):
        raise ValueError(f"scan_orient: orient must be 'lanes' or 'thread', got {orient!r}")
    depth_axis = 2 if orient == "lanes" else 1
    if (x.dtype != torch.float32 or x.ndim != 3 or x.shape[depth_axis] != DEPTH
            or not x.is_contiguous() or x.numel() == 0):
        raise ValueError(f"scan_orient: x must be contiguous float32 with {DEPTH} on axis "
                         f"{depth_axis}, got {x.dtype} {tuple(x.shape)}")
    if orient == "thread" and x.shape[2] % 128:
        raise ValueError(f"scan_orient: the pixel axis must be a multiple of 128, got {x.shape[2]}")
    if x.device.type == "cpu":
        return scan_orient_plain(x, orient=orient, reps=reps)
    lib, stream = _launch(x, "scan_orient")
    g = x.shape[0]
    x_out = torch.empty_like(x)
    if orient == "lanes":
        out = torch.empty((g, 1, DEPTH), dtype=torch.float32, device=x.device)
        err = lib.lfs_mb_scan_orient_lanes(x.data_ptr(), out.data_ptr(), x_out.data_ptr(), g,
                                           x.shape[1], reps, stream)
    else:
        out = torch.empty((g, 1, x.shape[2]), dtype=torch.float32, device=x.device)
        err = lib.lfs_mb_scan_orient_thread(x.data_ptr(), out.data_ptr(), x_out.data_ptr(), g,
                                            x.shape[2], reps, stream)
    _build.check(err, f"lfs_mb_scan_orient_{orient}")
    scan_orient.launches += 1
    return out, x_out


scan_orient.launches = 0
