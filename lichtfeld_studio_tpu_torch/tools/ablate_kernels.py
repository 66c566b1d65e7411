"""What each part of the redesigned kernels is worth on one NVIDIA GPU: the
instance expansion (P1), the tile blend forward (P2, training and
inference), the blend backward (P3, and its tail trim), the world blend
forward (P5) and backward (P6), the segment reduce (P4), the elementwise
microbenchmark T1a and the register forms of the microbenchmarks T1b and
T3. Every variant
below is the kernel's source with one part put back to a simpler form,
built on its own and timed in turns with the source as it stands, at
chip_smoke.py's shapes, in one run on one card.

    python -m lichtfeld_studio_tpu_torch.tools.ablate_kernels [--rounds 3] [--only P1,T3]

A variant is a list of (old text, new text) pairs applied to the source
with its local headers written in (csrc/blend_common.cuh is shared, so a
pair may rewrite a part that lives there); a pair whose old text is not in
that text exactly once is an error (a CPU test applies them all), so the
variants cannot fall behind the kernels unnoticed. The kernels themselves
carry no switches. Each variant is held against the source as it stands:
P2 and P5 by their image (1e-4) and, training, the last counted index
(equal); P3 and P6 by their rows through P4, per column group, within 1e-4
of the largest gradient; P4 by its sums (1e-5 of the largest); P1 by its
owners, ranks and payloads (equal on every slot); T1b by its values
(equal), T3 by its output and final x (1e-5 of the largest). P1 runs at
the render shape and the train step's, P5 on the gut scene's fresh training
binning, T1a (f32 and bf16x2, equal bits) and T1b on their tool's 264
slabs, T3 on its tool's 528. P3's "no_trim" replays every counted
contribution (the trim put back to full replay) and is held to the source
at tile_neff = FULL_REPLAY (equal bits); P2's "no_trim_record" records no
trim and is held by its image and last counted index. The
first line is
the card's name and power limit, then one line a variant (median and least
device ms over the rounds), the last line one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

from lichtfeld_studio_tpu_torch.kernels import _build

P1, P2, P3, P4 = "expand.cu", "blend_forward.cu", "blend_backward.cu", "segment_reduce.cu"
P5, P6 = "world_blend_forward.cu", "world_blend_backward.cu"
T1B, T3 = "microbench_alu.cu", "microbench_scan.cu"
T1A = T1B  # one source holds both
KERNELS = {"P1": P1, "P2": P2, "P3": P3, "P4": P4, "P5": P5, "P6": P6, "T1a": T1A, "T1b": T1B,
           "T3": T3}
ENTRIES = {P1: "lfs_expand_instances", P2: "lfs_blend_forward", P3: "lfs_blend_backward",
           P4: "lfs_segment_reduce", P5: "lfs_world_blend_forward",
           P6: "lfs_world_blend_backward", T1B: "lfs_mb_scan_prod", T3: "lfs_mb_scan_orient_thread"}

_STRIP_PATCHES = [  # a warp owns whole tile rows (32 x 4 or 16 x 2 pixels), not a compact patch
    ("static constexpr int kPatchW = kTile / 2;", "static constexpr int kPatchW = kTile;"),
    ("static constexpr int kPatchH = kTile / 4;", "static constexpr int kPatchH = kTile / 8;"),
    ("wx = (tile % grid_w) * kTile + (warp & 1) * kPatchW;", "wx = (tile % grid_w) * kTile;"),
    ("wy = (tile / grid_w) * kTile + (warp >> 1) * kPatchH;",
     "wy = (tile / grid_w) * kTile + warp * kPatchH;"),
]
_NO_REACH_SKIP = [  # every warp evaluates every instance up to its last counted one
    ("if (patch.misses(box)) {", "if (false) {"),
    ("if (patch.misses(s_box[jj])) {", "if (false) {"),  # the trimmed tail's replay
]
_P2_NO_REACH_SKIP = [  # every warp evaluates every instance
    ("valid && !patch.misses(s_box[slot][q + lane])", "valid"),
]
_NO_SIGMA_LIMIT = [  # expf before the alpha test
    ("if (sigma < 0.0f || sigma > smax) continue;", "if (sigma < 0.0f) continue;"),
    ("if (sigma > smax || sigma < 0.0f) continue;", "if (sigma < 0.0f) continue;"),  # the tail's
]
_BUTTERFLY = [  # all ten sums through a 5-step butterfly (50 shuffles), lane 0 stores them
    ("""      warp_reduce_scatter<kMaxF, 16>(acc, lane);
      if (col_out >= 0) s_part[warp][jj][col_out] = acc[0];
""", """#pragma unroll
      for (int f = 0; f < kMaxF; ++f) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) acc[f] += __shfl_xor_sync(kFullMask, acc[f], o);
      }
      if (lane == 0) {
#pragma unroll
        for (int f = 0; f < kMaxF; ++f) s_part[warp][jj][f] = acc[f];
      }
"""),
]
_PER_PAIR_GEOMETRY = [  # six geometry sums for every counted pair, not three moments a thread
    ("""          const float ux = u * dx;
          m0 += u;
          m1 += ux;
          m2 += ux * dx;
""", """          acc[0] += u * (co.x * dx + co.y * dy);
          acc[1] += u * (co.z * dy + co.y * dx);
          acc[2] += 0.5f * u * dx * dx;
          acc[3] += u * dx * dy;
          acc[4] += 0.5f * u * dy * dy;
          acc[5] -= u * lim.y;
"""),
    ("""      const float m0y = dy * m0;  // sum u dy
      acc[0] = co.x * m1 + co.y * m0y;
      acc[1] = co.z * m0y + co.y * m1;
      acc[2] = 0.5f * m2;
      acc[3] = dy * m1;
      acc[4] = 0.5f * dy * m0y;
      acc[5] = -m0 * lim.y;
""", ""),
]
_TILE_ORDER = [  # block i takes tile i: no ranking kernel
    ("if (order == nullptr || n_tiles <= resident) return nullptr;", "return nullptr;"),
]
_P2_NO_SIGMA_LIMIT = [
    ("if (sigma < 0.0f || sigma > smax) {  // above smax", "if (sigma < 0.0f) {  // above smax"),
]
_P2_NO_WARP_EXIT = [  # a warp whose pixels are all done walks every batch the block gathers
    ("const bool warp_done = __all_sync(kFullMask, all_mine);", "const bool warp_done = false;"),
]
_P6_NO_RAY_SKIP = [  # every warp evaluates every instance up to its last counted one
    ("walks && ray_bound<kRS>(rp, reinterpret_cast<const float*>(&s_f[lane][0]), s_norm[lane]).skip",
     "false"),
]
_P6_BOUND_BY_WARP = [  # every lane bounds every instance (the warp's test, 32 times over)
    ("""    const unsigned skip_mask = __ballot_sync(
        kFullMask,
        walks && ray_bound<kRS>(rp, reinterpret_cast<const float*>(&s_f[lane][0]), s_norm[lane]).skip);""",
     """    unsigned skip_mask = 0u;
    for (int jj = 0; jj < nb; ++jj)
      if (((walk_mask >> jj) & 1u) &&
          ray_bound<kRS>(rp, reinterpret_cast<const float*>(&s_f[jj][0]), s_norm[jj]).skip)
        skip_mask |= 1u << jj;"""),
]
_P5_NO_RAY_SKIP = [  # every warp evaluates every instance until its pixels are done
    ("skip_mine = rb.skip;", "skip_mine = false;"),
]
_P5_NO_PIXEL_REJECT = [  # z, |z|^2 and the division for every evaluated pair
    ("if (num > num_max) {", "if (false) {"),
]
_P5_NO_WARP_EXIT = [  # a warp walks every batch the block gathers, done or not
    ("bool warp_done = __all_sync(kFullMask, all_mine);", "bool warp_done = false;"),
    ("warp_done = __all_sync(kFullMask, mine);", "(void)mine;"),
]
_P1_BINARY_SEARCH = [  # each slot its own binary search of ~20 dependent loads (the first port)
    ("""}  // namespace

extern "C" int lfs_expand_instances(""", """__global__ void search_kernel(const int* __restrict__ ends, const int* __restrict__ payload_t,
                              int n_gauss, int cap, int* __restrict__ g_out,
                              int* __restrict__ rank_out, int* __restrict__ pl_out) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= cap) return;
  int lo = 0, hi = n_gauss;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(ends + mid) <= s) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int g = lo < n_gauss ? lo : n_gauss - 1;
  const int off = g > 0 ? __ldg(ends + g - 1) : 0;
  g_out[s] = g;
  rank_out[s] = s - off;
#pragma unroll
  for (int w = 0; w < 4; ++w) pl_out[(size_t)w * cap + s] = __ldg(payload_t + (size_t)w * n_gauss + g);
}

}  // namespace

extern "C" int lfs_expand_instances("""),
    ("""  const long long items = static_cast<long long>(n_gauss) + cap;
  const int blocks = static_cast<int>((items + kPiece - 1) / kPiece);
  expand_kernel<<<""", """  const int blocks = (cap + kThreads - 1) / kThreads;
  search_kernel<<<"""),
]
_NO_STAGING = [  # a thread per (gaussian, column) reads device memory itself: no ring, no chunks
    ("""template <int kNF>
int launch_segment_reduce(""", """template <int kNF>
__global__ void segment_direct_kernel(const float* __restrict__ rows, const int* __restrict__ off,
                                      int n, int n_f_arg, float* __restrict__ out) {
  const int n_f = kNF > 0 ? kNF : n_f_arg;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * n_f) return;
  const int g = i / n_f, f = i % n_f;
  float acc = 0.0f;
  for (int s = off[g]; s < off[g + 1]; ++s) acc += rows[(size_t)s * n_f + f];
  out[i] = acc;
}

template <int kNF>
int launch_segment_reduce("""),
    ("""  segment_reduce_kernel<kNF><<<blocks, kThreads, smem, stream>>>(
      rows, off, n, n_f, n_rows, chunk_rows, slot_floats, out);
""", """  (void)blocks, (void)smem;
  segment_direct_kernel<kNF><<<(n * n_f + 255) / 256, 256, 0, stream>>>(rows, off, n, n_f, out);
"""),
]

_P3_NO_TRIM = [  # every counted contribution replayed: no row of the tail trimmed
    ("""  const int keep = static_cast<int>(min((static_cast<long long>(tile_neff[tile]) << kTrimShift) -
                                             (start & ((1 << kTrimShift) - 1)),
                                         static_cast<long long>(count)));""",
     """  const int keep = count;"""),
]
_P2_NO_TRIM_RECORD = [  # no window weights, no n_eff
    ("const bool trim = kTrain && eps > 0.0f;", "const bool trim = false;"),
]
_T1A_RUNTIME_REPS = [  # float32 too through the run-time loop (unrolled by 8), as bf16
    ("  if constexpr (!kBf16) {  // float32 at the tool's two counts: unrolled whole",
     "  if constexpr (false) {"),
]
_T1A_BEFORE = [  # the kernel before its redesign: a run-time loop, loads at a pass's start
    ("""template <bool kBf16>
void launch_alu(""", """template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
    alu_kernel_before(const float4* __restrict__ x, float4* __restrict__ out, int reps, float c) {
  const float4* xs = x + (size_t)blockIdx.x * kSlabVec;
  float4* os = out + (size_t)blockIdx.x * kSlabVec;
  for (int v = threadIdx.x; v < kSlabVec / 2; v += kThreads) {
    const float4 a = xs[v];
    const float4 b = xs[v + kSlabVec / 2];
    if constexpr (kBf16) {
      __nv_bfloat162 acc[4] = {__floats2bfloat162_rn(a.x, a.y), __floats2bfloat162_rn(a.z, a.w),
                               __floats2bfloat162_rn(b.x, b.y), __floats2bfloat162_rn(b.z, b.w)};
      const __nv_bfloat162 cc = __float2bfloat162_rn(c);
      const __nv_bfloat162 half = __float2bfloat162_rn(0.5f);
      const __nv_bfloat162 zero = __float2bfloat162_rn(0.0f);
      for (int r = 0; r < reps; ++r) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          acc[k] = __hmul2_rn(acc[k], cc);
          acc[k] = __hadd2_rn(acc[k], acc[k]);
          acc[k] = __hmul2_rn(acc[k], half);
          acc[k] = __hmax2(acc[k], zero);
        }
      }
      const float2 f0 = __bfloat1622float2(acc[0]), f1 = __bfloat1622float2(acc[1]);
      const float2 f2 = __bfloat1622float2(acc[2]), f3 = __bfloat1622float2(acc[3]);
      os[v] = make_float4(f0.x, f0.y, f1.x, f1.y);
      os[v + kSlabVec / 2] = make_float4(f2.x, f2.y, f3.x, f3.y);
    } else {
      float acc[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      for (int r = 0; r < reps; ++r) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          acc[k] = __fmul_rn(acc[k], c);
          acc[k] = __fadd_rn(acc[k], acc[k]);
          acc[k] = __fmul_rn(acc[k], 0.5f);
          acc[k] = fmaxf(acc[k], 0.0f);
        }
      }
      os[v] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      os[v + kSlabVec / 2] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
  }
}

template <bool kBf16>
void launch_alu("""),
    ("""  auto kernel = alu_kernel<kBf16, 0>;
  if constexpr (!kBf16) {  // float32 at the tool's two counts: unrolled whole
    if (reps == 64) kernel = alu_kernel<false, 64>;
    if (reps == 2) kernel = alu_kernel<false, 2>;
  }""", """  auto kernel = alu_kernel_before<kBf16>;"""),
]

_T3_ROUNDED_OPS = [  # the serial step as eight operations, each rounded (no FMA)
    ("""      p = __fmul_rn(p, __fmaf_rn(-1e-4f, xv, 1.0f));
      s = __fmaf_rn(xv, p, s);
      col[i] = __fmaf_rn(1e-7f, s, __fmul_rn(xv, 0.9999f));
""", """      p = __fmul_rn(p, decay_term(xv));
      s = __fadd_rn(s, __fmul_rn(xv, p));
      col[i] = next_x(xv, s);
"""),
]


def _constant(name: str, old: int, new: int) -> list[tuple[str, str]]:
    return [(f"constexpr int {name} = {old};", f"constexpr int {name} = {new};")]


# file -> variant -> (old, new) pairs; "as_it_stands" is the source unchanged
VARIANTS: dict[str, dict[str, list[tuple[str, str]]]] = {
    P2: {
        "as_it_stands": [],
        "strip_patches": _STRIP_PATCHES,
        "no_reach_skip": _P2_NO_REACH_SKIP,
        "no_sigma_limit": _P2_NO_SIGMA_LIMIT,
        "no_warp_exit": _P2_NO_WARP_EXIT,
        "in_tile_order": _TILE_ORDER,
        "all_four_back": _STRIP_PATCHES + _P2_NO_REACH_SKIP + _P2_NO_SIGMA_LIMIT + _TILE_ORDER,
        "no_trim_record": _P2_NO_TRIM_RECORD,
        "blocks_per_sm_3": _constant("kBlocksPerSm", 4, 3),
        "blocks_per_sm_2": _constant("kBlocksPerSm", 4, 2),
    },
    P3: {
        "as_it_stands": [],
        "strip_patches": _STRIP_PATCHES,
        "no_reach_skip": _NO_REACH_SKIP,
        "no_sigma_limit": _NO_SIGMA_LIMIT,
        "butterfly": _BUTTERFLY,
        "per_pair_geometry": _PER_PAIR_GEOMETRY,
        "all_four_back": _STRIP_PATCHES + _NO_REACH_SKIP + _BUTTERFLY + _PER_PAIR_GEOMETRY,
        "batch_64": _constant("kBatch", 96, 64),
        "batch_32": _constant("kBatch", 96, 32),
        "blocks_per_sm_2": _constant("kBlocksPerSm", 3, 2),
        "blocks_per_sm_4": _constant("kBlocksPerSm", 3, 4),
        "in_tile_order": _TILE_ORDER,
        "no_trim": _P3_NO_TRIM,
    },
    P6: {
        "as_it_stands": [],
        "strip_patches": _STRIP_PATCHES,
        "no_ray_skip": _P6_NO_RAY_SKIP,
        "bound_by_warp": _P6_BOUND_BY_WARP,
        "in_tile_order": _TILE_ORDER,
        "all_three_back": _STRIP_PATCHES + _P6_NO_RAY_SKIP + _TILE_ORDER,
        "batch_16": _constant("kBatch", 32, 16),
        "blocks_per_sm_2": _constant("kBlocksPerSm", 3, 2),
    },
    P5: {
        "as_it_stands": [],
        "strip_patches": _STRIP_PATCHES,
        "no_ray_skip": _P5_NO_RAY_SKIP,
        "no_warp_exit": _P5_NO_WARP_EXIT,
        "in_tile_order": _TILE_ORDER,
        "no_pixel_reject": _P5_NO_PIXEL_REJECT,
        "all_five_back": _STRIP_PATCHES + _P5_NO_RAY_SKIP + _P5_NO_PIXEL_REJECT
        + _P5_NO_WARP_EXIT + _TILE_ORDER,
        "blocks_per_sm_2": _constant("kBlocksPerSm", 3, 2),
        "blocks_per_sm_4": _constant("kBlocksPerSm", 3, 4),
    },
    P1: {
        "as_it_stands": [],
        "binary_search": _P1_BINARY_SEARCH,
        "items_2": _constant("kItems", 4, 2),
        "items_8": _constant("kItems", 4, 8),
        "blocks_per_sm_4": _constant("kBlocksPerSm", 8, 4),
    },
    T1B: {  # and T1a's, named t1a_*
        "as_it_stands": [],
        # at most 168 registers a thread, so that three blocks fit an SM
        "min_blocks_3": [("__global__ void __launch_bounds__(kRegThreads)",
                          "__global__ void __launch_bounds__(kRegThreads, 3)")],
        "t1a_runtime_reps": _T1A_RUNTIME_REPS,
        "t1a_before": _T1A_BEFORE,
    },
    T3: {
        "as_it_stands": [],
        "eight_rounded_ops": _T3_ROUNDED_OPS,
    },
    P4: {
        "as_it_stands": [],
        "no_staging": _NO_STAGING,
        "gaussians_128": _constant("kThreads", 256, 128),
        "gaussians_512": _constant("kThreads", 256, 512),
        "chunk_1024": _constant("kChunkFloats", 4096, 1024),
        "chunk_2048": _constant("kChunkFloats", 4096, 2048),
    },
}
P2_GATE, P3_GATE, P4_GATE, P5_GATE, P6_GATE = 1e-4, 1e-4, 1e-5, 1e-4, 1e-4  # chip_smoke.py's
T3_GATE = 1e-5  # tools/microbench_scan_orient.py's
P3_GROUPS = (slice(0, 2), slice(2, 5), slice(5, 6), slice(6, 9))
P6_GROUPS = (slice(0, 9), slice(9, 18), slice(18, 19), slice(19, 22))  # global shutter, 3 channels


def expanded_source(file: str) -> str:
    """csrc/<file> with each of its local headers (#include "...") written in."""
    def header(m):
        text = (_build.CSRC_DIR / m.group(1)).read_text()
        return text.replace("#pragma once\n", "")

    return re.sub(r'^#include "([^"]+)"$', header, (_build.CSRC_DIR / file).read_text(),
                  flags=re.MULTILINE)


def variant_source(file: str, name: str) -> str:
    """expanded_source(file) with the variant's pairs applied."""
    text = expanded_source(file)
    for old, new in VARIANTS[file][name]:
        if text.count(old) != 1:
            raise ValueError(f"{file}, variant {name}: the source holds {text.count(old)} times, "
                             f"not once:\n{old}")
        text = text.replace(old, new)
    return text


def build_variants(out_dir: Path, only=None) -> dict:
    """One nvcc a variant, all started together (or only those of `only`,
    (file, name) pairs) -> (file, name) -> the file's C entry."""
    return {(file, name): _entry(lib, ENTRIES[file])
            for (file, name), lib in build_variant_libraries(out_dir, only).items()}


def build_variant_libraries(out_dir: Path, only=None) -> dict:
    """build_variants' libraries: (file, name) -> the loaded library."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for file, variants in VARIANTS.items():
        for name in variants:
            if only is not None and (file, name) not in only:
                continue
            src = out_dir / f"{name}.{file}"
            src.write_text(variant_source(file, name))
            lib = src.with_suffix(".so")
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)]
            procs[file, name] = lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for (file, name), (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {file}, variant {name}:\n{out}")
        libs[file, name] = ctypes.CDLL(str(lib))
    return libs


def _entry(lib: ctypes.CDLL, entry: str):
    fn = getattr(lib, entry)
    fn.argtypes = list(_build.SIGNATURES[entry])
    fn.restype = ctypes.c_int
    return fn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3, help="timed turns through all variants")
    ap.add_argument("--build-dir", default=str(_build.BUILD_DIR.parent / "ablate_kernels"))
    ap.add_argument("--only", default=",".join(KERNELS),
                    help="the kernels whose variants are built and timed, e.g. P1,P5")
    ns = ap.parse_args(argv)
    chosen = ns.only.split(",")
    files = {KERNELS[k] for k in chosen}
    import torch

    if not torch.cuda.is_available():
        print("ablate_kernels needs an NVIDIA GPU (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    from lichtfeld_studio_tpu_torch.kernels import blend as kblend
    from lichtfeld_studio_tpu_torch.kernels import microbench as mb
    from lichtfeld_studio_tpu_torch.kernels import segment_reduce as kseg
    from lichtfeld_studio_tpu_torch.kernels.blend import INFERENCE_TERM_THRESHOLD
    from lichtfeld_studio_tpu_torch.profiling import device_ms
    from lichtfeld_studio_tpu_torch.tools import microbench_bf16_vpu as t1
    from lichtfeld_studio_tpu_torch.tools import microbench_scan_orient as t3
    from lichtfeld_studio_tpu_torch.tools import scenes
    from lichtfeld_studio_tpu_torch.tools.ab_kernels import (
        bench_kernel_inputs, expand_kernel_inputs, gut_kernel_inputs, render_kernel_inputs)

    card = scenes.card()
    print(card, flush=True)
    dev = torch.device("cuda")
    libs = build_variant_libraries(Path(ns.build_dir),
                                   only={(f, n) for f in files for n in VARIANTS[f]})

    def fn(file, name, entry=None):
        """a variant's C entry: the file's own, or `entry`"""
        return _entry(libs[file, name], entry or ENTRIES[file])
    a, bwd, kw = bench_kernel_inputs(dev)
    a_r, fwd_r, kw_r = render_kernel_inputs(dev)
    a_w, wbwd, kw_w = gut_kernel_inputs(dev)
    p1_inputs = {name: (torch.cumsum(nt, 0, dtype=torch.int32), payload, cap, nt.shape[0])
                 for name, (nt, payload, cap) in expand_kernel_inputs(dev).items()}
    x1 = t1.slabs(t1.GRIDS[-1], dev)
    x3 = t3.slabs(t3.GRIDS[-1], "thread", dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_ch = bwd[7].shape[1]

    def grid(k):
        return k["grid_w"], k["grid_h"], k["tile_size"]

    # room for each shape's tile ranking
    orders = {id(k): torch.empty(k["grid_w"] * k["grid_h"], dtype=torch.int32, device=dev)
              for k in (kw, kw_r, kw_w)}

    def scratch(k):
        return orders[id(k)].data_ptr()

    def p2(name, train):
        args, k = (bwd[:3] + bwd[4:8], kw) if train else (fwd_r, kw_r)
        hp, wp = k["grid_h"] * k["tile_size"], k["grid_w"] * k["tile_size"]
        image = torch.empty((hp, wp, args[6].shape[1]), dtype=torch.float32, device=dev)
        alpha = torch.empty((hp, wp), dtype=torch.float32, device=dev)
        t_final = torch.empty_like(alpha) if train else None
        last = torch.empty((hp, wp), dtype=torch.int32, device=dev) if train else None
        neff = torch.empty(k["grid_w"] * k["grid_h"], dtype=torch.int32, device=dev)
        err = fn(P2, name)(
            *(t.data_ptr() for t in args), args[6].shape[1], *grid(k), INFERENCE_TERM_THRESHOLD,
            kblend.GRAD_SKIP_EPS, image.data_ptr(), alpha.data_ptr(),
            *((t.data_ptr() for t in (t_final, last, neff)) if train else (None,) * 3),
            scratch(k), stream)
        _build.check(err, f"lfs_blend_forward ({name})")
        return (image, last) if train else (image,)

    def p3(name, args=bwd):
        out = torch.zeros((args[3].shape[0], 6 + n_ch), dtype=torch.float32, device=dev)
        err = fn(P3, name)(*(t.data_ptr() for t in args[:8]), n_ch, *grid(kw),
                                         *(t.data_ptr() for t in args[8:]), out.data_ptr(),
                                         None, scratch(kw), stream)
        _build.check(err, f"lfs_blend_backward ({name})")
        return out

    def p6(name):
        (st, rays_d, tau, t_start, t_count, gidx, slot, t_final, last, d_image, d_alpha) = wbwd
        out = torch.zeros((slot.shape[0], st.shape[1]), dtype=torch.float32, device=dev)
        err = fn(P6, name)(t_start.data_ptr(), t_count.data_ptr(), gidx.data_ptr(),
                            slot.data_ptr(), st.data_ptr(), st.shape[1], rays_d.data_ptr(),
                            tau.data_ptr() if tau is not None else None, d_image.shape[-1],
                            *grid(kw_w), t_final.data_ptr(), last.data_ptr(), d_image.data_ptr(),
                            d_alpha.data_ptr(), out.data_ptr(), scratch(kw_w), stream)
        _build.check(err, f"lfs_world_blend_backward ({name})")
        return out

    def p5(name):
        st, rays_d, tau, t_start, t_count, gidx = wbwd[:6]
        hp, wp = kw_w["grid_h"] * kw_w["tile_size"], kw_w["grid_w"] * kw_w["tile_size"]
        n_ch = wbwd[9].shape[-1]
        image = torch.empty((hp, wp, n_ch), dtype=torch.float32, device=dev)
        alpha = torch.empty((hp, wp), dtype=torch.float32, device=dev)
        t_final = torch.empty_like(alpha)
        last = torch.empty((hp, wp), dtype=torch.int32, device=dev)
        err = fn(P5, name)(t_start.data_ptr(), t_count.data_ptr(), gidx.data_ptr(), st.data_ptr(),
                            st.shape[1], rays_d.data_ptr(),
                            tau.data_ptr() if tau is not None else None, n_ch, *grid(kw_w),
                            image.data_ptr(), alpha.data_ptr(), t_final.data_ptr(),
                            last.data_ptr(), scratch(kw_w), stream)
        _build.check(err, f"lfs_world_blend_forward ({name})")
        return image, last

    def p1(name, shape):
        ends, payload, cap, n = p1_inputs[shape]
        out = torch.empty((6, cap), dtype=torch.int32, device=dev)  # g, rank, payload
        err = fn(P1, name)(ends.data_ptr(), payload.data_ptr(), n, cap, out[0].data_ptr(),
                            out[1].data_ptr(), out[2].data_ptr(), stream)
        _build.check(err, f"lfs_expand_instances ({name})")
        return out

    def p4(name, rows):
        off = a.segment_off
        out = torch.empty((off.shape[0] - 1, rows.shape[1]), dtype=torch.float32, device=dev)
        err = fn(P4, name)(rows.data_ptr(), off.data_ptr(), off.shape[0] - 1, rows.shape[1],
                            rows.shape[0], out.data_ptr(), stream)
        _build.check(err, f"lfs_segment_reduce ({name})")
        return out

    def t1b_reg(name, bf16):
        out = torch.empty_like(x1)
        err = fn(T1B, name)(x1.data_ptr(), out.data_ptr(), x1.shape[0], mb.REPS, mb.SCAN_DECAY,
                             bf16, mb.SCAN_IMPLS.index("reg"), stream)
        _build.check(err, f"lfs_mb_scan_prod ({name})")
        return out

    def t1a(name, bf16):
        out = torch.empty_like(x1)
        err = fn(T1A, name, "lfs_mb_alu_elementwise")(x1.data_ptr(), out.data_ptr(), x1.shape[0],
                                                        mb.REPS, mb.ELEMWISE_C, bf16, stream)
        _build.check(err, f"lfs_mb_alu_elementwise ({name})")
        return out

    def t3_serial(name):
        out = torch.empty((x3.shape[0], 1, x3.shape[2]), dtype=torch.float32, device=dev)
        x_out = torch.empty_like(x3)
        err = fn(T3, name)(x3.data_ptr(), out.data_ptr(), x_out.data_ptr(), x3.shape[0],
                            x3.shape[2], mb.REPS, stream)
        _build.check(err, f"lfs_mb_scan_orient_thread ({name})")
        return out, x_out

    def t3_diff(got, want):
        """the larger relative error of the output and of the final x"""
        return max(float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want))

    def rel(got, want, groups):
        return max(float((got[:, c] - want[:, c]).abs().max() / want[:, c].abs().max())
                   for c in groups)

    def equal_bits(got, want):
        return 0.0 if torch.equal(got, want) else float("inf")

    def p2_diff(got, want):
        """the image's max |diff|, or inf where the last counted index differs"""
        if len(got) == 2 and not torch.equal(got[1], want[1]):
            return float("inf")
        return float((got[0] - want[0]).abs().max())

    with torch.no_grad():
        rows9 = kblend.blend_backward(*bwd, **kw)  # the source as it stands
        gen = torch.Generator(device=dev).manual_seed(24)
        rows24 = torch.randn((rows9.shape[0], 24), generator=gen, device=dev)
        # the full replay: the source as it stands at tile_neff = FULL_REPLAY
        bwd_full = (*bwd[:10], torch.full_like(bwd[10], kblend.FULL_REPLAY), *bwd[11:])
        # label -> (the launch, how its output is held against the source's,
        # gate[, the launch it is held against if not the source as it stands])
        cases = {}
        for train, what in ((True, "training"), (False, "inference")):
            cases.update({f"P2 {what} {name}": (lambda name=name, train=train: p2(name, train),
                                               p2_diff, P2_GATE) for name in VARIANTS[P2]})
        cases.update({f"P3 {name}": (lambda name=name: p3(name),
                                     lambda got, want: rel(kseg.segment_reduce(got, a.segment_off),
                                                           kseg.segment_reduce(want, a.segment_off),
                                                           P3_GROUPS), P3_GATE)
                      for name in VARIANTS[P3] if name != "no_trim"})
        cases["P3 no_trim"] = (lambda: p3("no_trim"), equal_bits, 0.0,
                               lambda: p3("as_it_stands", bwd_full))
        cases.update({f"P5 {name}": (lambda name=name: p5(name), p2_diff, P5_GATE)
                      for name in VARIANTS[P5]})
        for shape in p1_inputs:
            cases.update({f"P1 {shape} {name}": (
                lambda name=name, shape=shape: p1(name, shape), equal_bits, 0.0)
                for name in VARIANTS[P1]})
        cases.update({f"P6 {name}": (lambda name=name: p6(name),
                                     lambda got, want: rel(kseg.segment_reduce(got, a_w.segment_off),
                                                           kseg.segment_reduce(want, a_w.segment_off),
                                                           P6_GROUPS), P6_GATE)
                      for name in VARIANTS[P6]})
        for cols, rows in ((9, rows9), (24, rows24)):
            cases.update({f"P4 {cols} columns {name}": (lambda name=name, rows=rows: p4(name, rows),
                                                       lambda got, want: rel(got, want, (slice(None),)),
                                                       P4_GATE)
                          for name in VARIANTS[P4]})
        t1a_names = [n for n in VARIANTS[T1A] if n == "as_it_stands" or n.startswith("t1a_")]
        for bf16, what in ((0, "f32"), (1, "bf16x2")):
            cases.update({f"T1a {what} {name}": (
                lambda name=name, bf16=bf16: t1a(name, bf16), equal_bits, 0.0)
                for name in t1a_names})
            cases.update({f"T1b {what} {name}": (
                lambda name=name, bf16=bf16: t1b_reg(name, bf16), equal_bits, 0.0)
                for name in VARIANTS[T1B] if not name.startswith("t1a_")})
        cases.update({f"T3 {name}": (lambda name=name: t3_serial(name), t3_diff, T3_GATE)
                      for name in VARIANTS[T3]})
        cases = {label: c for label, c in cases.items() if label.split()[0] in chosen}
        errs, times = {}, {label: [] for label in cases}
        for label, (launch, diff, gate, *held_to) in cases.items():
            stands = held_to[0] if held_to else cases[label.rsplit(" ", 1)[0] + " as_it_stands"][0]
            errs[label] = diff(launch(), stands())
            torch.cuda.synchronize()
            if not errs[label] <= gate:
                raise RuntimeError(f"{label}: {errs[label]} > {gate} against the source as it stands")
        for _ in range(ns.rounds):
            for label, (launch, *_) in cases.items():
                times[label].append(device_ms(launch))
    for label, ms in times.items():
        print(f"{label}: median {statistics.median(ms):.4f} ms, least {min(ms):.4f} ms over "
              f"{ns.rounds} rounds; max |diff| {errs[label]:.3g} | {card}", flush=True)
    print(json.dumps({"card": card, "instances": {"P2 training, P3": int(a.n_instances),
                                                  "P2 inference": int(a_r.n_instances),
                                                  "P5, P6": int(a_w.n_instances)},
                      "t1_slabs": int(x1.shape[0]), "t3_slabs": int(x3.shape[0]),
                      "p1_caps": {k: v[2] for k, v in p1_inputs.items()},
                      "rounds": ns.rounds, "ms": times, "rel_err": errs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
