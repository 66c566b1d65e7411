"""What each part of the blend backward's (P3) and the segment reduce's (P4)
design is worth on one NVIDIA GPU: every variant below is the kernel's
source with one part put back to a simpler form, built on its own and
timed in turns with the source as it stands, on bench.py's shape, in one
run on one card.

    python -m lichtfeld_studio_tpu_torch.tools.ablate_kernels [--rounds 3]

A variant is a list of (old text, new text) pairs applied to the source; a
pair whose old text is not in the source exactly once is an error (a CPU
test applies them all), so the variants cannot fall behind the kernels
unnoticed. The kernels themselves carry no switches. P3's variants are
held against the rows of the source as it stands (through P4, per column
group, 1e-4 of the largest gradient), P4's against its sums (1e-5 of the
largest sum). The first line is the card's name and power limit, then one
line a variant (median and least device ms over the rounds), the last line
one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

from lichtfeld_studio_tpu_torch.kernels import _build

P3, P4 = "blend_backward.cu", "segment_reduce.cu"

_STRIP_PATCHES = [  # a warp owns whole tile rows (32 x 4 or 16 x 2 pixels), not a compact patch
    ("constexpr int kPatchW = kTile / 2;", "constexpr int kPatchW = kTile;"),
    ("constexpr int kPatchH = kTile / 4;", "constexpr int kPatchH = kTile / 8;"),
    ("(warp & 1) * kPatchW;", "0;"),
    ("(warp >> 1) * kPatchH;", "warp * kPatchH;"),
]
_NO_REACH_SKIP = [  # every warp evaluates every instance up to its last counted one
    ("if (box.x > cx_hi || box.y < cx_lo || box.z > cy_hi || box.w < cy_lo) {", "if (false) {"),
]
_NO_SIGMA_LIMIT = [  # expf before the alpha test, as the forward does
    ("if (sigma < 0.0f || sigma > smax) continue;", "if (sigma < 0.0f) continue;"),
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
    ("const bool heaviest_first = n_tiles > n_sm * kBlocksPerSm;",
     "const bool heaviest_first = false;"),
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


def _constant(name: str, old: int, new: int) -> list[tuple[str, str]]:
    return [(f"constexpr int {name} = {old};", f"constexpr int {name} = {new};")]


# file -> variant -> (old, new) pairs; "as_it_stands" is the source unchanged
VARIANTS: dict[str, dict[str, list[tuple[str, str]]]] = {
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
P3_GATE, P4_GATE = 1e-4, 1e-5  # chip_smoke.py's P3_CHECK_REL and P4_CHECK_REL
P3_GROUPS = (slice(0, 2), slice(2, 5), slice(5, 6), slice(6, 9))


def variant_source(file: str, name: str) -> str:
    """csrc/<file> with the variant's pairs applied."""
    text = (_build.CSRC_DIR / file).read_text()
    for old, new in VARIANTS[file][name]:
        if text.count(old) != 1:
            raise ValueError(f"{file}, variant {name}: the source holds {text.count(old)} times, "
                             f"not once:\n{old}")
        text = text.replace(old, new)
    return text


def build_variants(out_dir: Path) -> dict:
    """One nvcc a variant, all started together -> (file, name) -> CDLL."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for file, variants in VARIANTS.items():
        for name in variants:
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
        entry = "lfs_blend_backward" if file == P3 else "lfs_segment_reduce"
        fn = getattr(ctypes.CDLL(str(lib)), entry)
        fn.argtypes = list(_build.SIGNATURES[entry])
        fn.restype = ctypes.c_int
        libs[file, name] = fn
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3, help="timed turns through all variants")
    ap.add_argument("--build-dir", default=str(_build.BUILD_DIR.parent / "ablate_kernels"))
    ns = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("ablate_kernels needs an NVIDIA GPU (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    from lichtfeld_studio_tpu_torch import bench_train
    from lichtfeld_studio_tpu_torch.kernels import segment_reduce as kseg
    from lichtfeld_studio_tpu_torch.profiling import device_ms
    from lichtfeld_studio_tpu_torch.tools.ab_kernels import bench_kernel_inputs

    card = bench_train.card()
    print(card, flush=True)
    dev = torch.device("cuda")
    fns = build_variants(Path(ns.build_dir))
    a, bwd, kw = bench_kernel_inputs(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_ch = bwd[7].shape[1]
    order_scratch = torch.empty_like(a.tile_count)

    def p3(name):
        out = torch.zeros((bwd[3].shape[0], 6 + n_ch), dtype=torch.float32, device=dev)
        err = fns[P3, name](*(t.data_ptr() for t in bwd[:8]), n_ch, kw["grid_w"], kw["grid_h"],
                            kw["tile_size"], *(t.data_ptr() for t in bwd[8:]), out.data_ptr(),
                            None, order_scratch.data_ptr(), stream)
        _build.check(err, f"lfs_blend_backward ({name})")
        return out

    def p4(name, rows):
        off = a.segment_off
        out = torch.empty((off.shape[0] - 1, rows.shape[1]), dtype=torch.float32, device=dev)
        err = fns[P4, name](rows.data_ptr(), off.data_ptr(), off.shape[0] - 1, rows.shape[1],
                            rows.shape[0], out.data_ptr(), stream)
        _build.check(err, f"lfs_segment_reduce ({name})")
        return out

    def rel(got, want, groups):
        return max(float((got[:, c] - want[:, c]).abs().max() / want[:, c].abs().max())
                   for c in groups)

    with torch.no_grad():
        rows9 = p3("as_it_stands")
        gen = torch.Generator(device=dev).manual_seed(24)
        rows24 = torch.randn((rows9.shape[0], 24), generator=gen, device=dev)
        # label -> (the launch, what its output is compared through, groups, gate)
        cases = {f"P3 {name}": (lambda name=name: p3(name),
                                lambda out: kseg.segment_reduce(out, a.segment_off), P3_GROUPS, P3_GATE)
                 for name in VARIANTS[P3]}
        for cols, rows in ((9, rows9), (24, rows24)):
            cases.update({f"P4 {cols} columns {name}": (lambda name=name, rows=rows: p4(name, rows),
                                                       lambda out: out, (slice(None),), P4_GATE)
                          for name in VARIANTS[P4]})
        errs, times = {}, {label: [] for label in cases}
        for label, (launch, through, groups, gate) in cases.items():
            stands = cases[label.rsplit(" ", 1)[0] + " as_it_stands"][0]
            errs[label] = rel(through(launch()), through(stands()), groups)
            torch.cuda.synchronize()
            if not errs[label] <= gate:
                raise RuntimeError(f"{label}: {errs[label]} > {gate} of the source as it stands")
        for _ in range(ns.rounds):
            for label, (launch, *_) in cases.items():
                times[label].append(device_ms(launch))
    for label, ms in times.items():
        print(f"{label}: median {statistics.median(ms):.4f} ms, least {min(ms):.4f} ms over "
              f"{ns.rounds} rounds; max |diff| {errs[label]:.3g} of the largest | {card}", flush=True)
    print(json.dumps({"card": card, "instances": int(a.n_instances), "rounds": ns.rounds,
                      "ms": times, "rel_err": errs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
