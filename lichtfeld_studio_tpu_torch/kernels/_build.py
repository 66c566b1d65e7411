"""Build and load the hand-written CUDA kernels.

Every `csrc/*.cu` file is compiled by its own nvcc process, all started
together, for sm_90a, and the objects are linked into ONE shared library
with a plain C interface under `build/torch_kernels/` at the root of the
checkout, at first use, and again whenever the sources or flags change
(the file name carries their hash). The library is loaded with ctypes: no
PyTorch headers are compiled, so a build takes seconds.

Calling convention of every entry point: pointers and the CUDA stream are
`void*` (ctypes.c_void_p, so 64-bit addresses are never cut), sizes are
`int`, and the return value is `cudaGetLastError()` right after the launch;
`check()` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points and their argument types (see the .cu files)
SIGNATURES = {
    # ends, payload_t, n_gauss, cap, g, rank, pl_t, stream
    "lfs_expand_instances": (_P, _P, _I, _I, _P, _P, _P, _P),
    # tile_start, tile_count, gaussian_idx, mean2d, conic, opacity, color,
    # n_channels, grid_w, grid_h, tile_size, threshold (inference only),
    # image, alpha, t_final and last (both null for inference), stream
    "lfs_blend_forward": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _P, _P, _P, _P),
    # tile_start, tile_count, gaussian_idx, slot_layout, mean2d, conic,
    # opacity, color, n_channels, grid_w, grid_h, tile_size, t_final, last,
    # d_image, d_alpha, out, stream
    "lfs_blend_backward": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P),
    # rows, off, n_segments, n_columns, out, stream
    "lfs_segment_reduce": (_P, _P, _I, _I, _P, _P),
    # tile_start, tile_count, gaussian_idx, stream, n_rows, rays_d, tau
    # (rolling shutter only), n_channels, grid_w, grid_h, tile_size, image,
    # alpha, t_final and last (both null for inference), cuda stream
    "lfs_world_blend_forward": (_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P),
    # tile_start, tile_count, gaussian_idx, slot_layout, stream, n_rows,
    # rays_d, tau, n_channels, grid_w, grid_h, tile_size, t_final, last,
    # d_image, d_alpha, out, cuda stream
    "lfs_world_blend_backward": (_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P,
                                 _P, _P),
    # the microbenchmarks (kernels/microbench.py)
    # x, out, n_slabs, reps, c, bf16, stream
    "lfs_mb_alu_elementwise": (_P, _P, _I, _I, _F, _I, _P),
    # x, out, n_slabs, reps, decay, bf16, smem, stream
    "lfs_mb_scan_prod": (_P, _P, _I, _I, _F, _I, _I, _P),
    # x, rows, width, nb, n_blocks, out, stream
    "lfs_mb_stream_ring": (_P, _I, _I, _I, _I, _P, _P),
    # x, out, x_out, n_slabs, pixels_per_slab, reps, stream
    "lfs_mb_scan_orient_lanes": (_P, _P, _P, _I, _I, _I, _P),
    # x, out, x_out, n_slabs, width, reps, stream
    "lfs_mb_scan_orient_thread": (_P, _P, _P, _I, _I, _I, _P),
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
            "kernels of lichtfeld_studio_tpu_torch are built from source"
        )
    return found


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):  # the sources and their headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"liblfs_torch_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the library unless it is already built. Returns its path and
    the seconds the build took (0.0 when it was already there)."""
    lib = library_path()
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    objs = [lib.with_name(f"{lib.stem}.{src.stem}.{os.getpid()}.o") for src in sources()]
    t0 = time.perf_counter()
    cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources(), objs)]
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}{err}")
    link = [_nvcc(), *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            failed.append(f"{' '.join(link)}\n{proc.stdout}{proc.stderr}")
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, lib)
    return lib, time.perf_counter() - t0


@functools.cache
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.lfs_error_string.argtypes = [ctypes.c_int]
    lib.lfs_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = load_library().lfs_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")
