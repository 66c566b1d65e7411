"""Microbenchmark T1 on one NVIDIA GPU (counterpart of
tools/microbench_bf16_vpu.py): does packed bf16 double the elementwise
rate of the CUDA cores against float32, what does a 128-deep log-step
prefix product cost with its column in one thread's registers, by lane
shuffles and by shared-memory shifts, and what does bf16 buy the scan?

It decides whether the blend kernels' per-(instance, pixel) pipelines are
worth converting to bf16 pairs where the error budget allows, and which
shift mechanism a scan across the depth axis should use.

    python -m lichtfeld_studio_tpu_torch.tools.microbench_bf16_vpu

At G = 64 slabs of [128, 1024] (the original's grid: half the SMs) and at
G = 264 (two blocks on each of the 132 SMs) every kernel is first held
against its plain PyTorch version on the slabs it is timed on (float32 to
the bit, bf16 to the bit of each rounding, at 2 and at 64 repetitions),
then timed. The first line is the card's name and power limit.

    python -m lichtfeld_studio_tpu_torch.tools.microbench_bf16_vpu --sass

prints instead, as one JSON object, what the elementwise kernel (T1a)
compiles to (`alu_sass`: each instance's registers, stack and spills, and
its float instructions per value and repetition); it needs the CUDA
toolkit, not a GPU.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from lichtfeld_studio_tpu_torch.kernels import microbench as mb
from lichtfeld_studio_tpu_torch.profiling import device_ms

GRIDS = (64, 264)
VARIANTS = (
    ("elemwise f32 [128,1024] x4ops", "alu", dict(dtype="f32")),
    ("elemwise bf16x2 [128,1024] x4ops", "alu", dict(dtype="bf16")),
    ("scan f32 shared-memory shifts", "scan", dict(dtype="f32", impl="smem")),
    ("scan f32 lane shuffles", "scan", dict(dtype="f32", impl="shfl")),
    ("scan f32 registers", "scan", dict(dtype="f32", impl="reg")),
    ("scan bf16x2 shared-memory shifts", "scan", dict(dtype="bf16", impl="smem")),
    ("scan bf16x2 lane shuffles", "scan", dict(dtype="bf16", impl="shfl")),
    ("scan bf16x2 registers", "scan", dict(dtype="bf16", impl="reg")),
)


def variant(kind: str, dtype: str, impl: str | None = None) -> str:
    """The name in VARIANTS of a kind ("alu" or "scan"), dtype and impl."""
    return next(name for name, k, kw in VARIANTS
                if k == kind and kw["dtype"] == dtype and kw.get("impl") == impl)


def slabs(g: int, device) -> torch.Tensor:
    gen = torch.Generator().manual_seed(0)
    return (torch.rand((g, mb.DEPTH, mb.WIDTH), generator=gen) * 0.01 + 0.99).to(device)


CHECK_REPS = (2, mb.REPS)  # at 64 the scans have underflowed to 0: 2 carries their check


def check(device, g: int, reps_list=CHECK_REPS) -> dict[str, float]:
    """Every variant against its plain version on G slabs (the grids that
    are timed); returns each variant's largest |kernel - plain| (0.0: equal
    to the bit) and raises beyond it. A scan's values must still be above 0
    after 2 repetitions, so that its comparison is not zeros against zeros."""
    x = slabs(g, device)
    worst = {}
    for name, kind, kw in VARIANTS:
        worst[name] = 0.0
        for reps in reps_list:
            if kind == "alu":
                k, p = mb.alu_elementwise(x, reps=reps, **kw), mb.alu_elementwise_plain(
                    x, reps=reps, dtype=kw["dtype"])
            else:
                k, p = mb.scan_prod(x, reps=reps, **kw), mb.scan_prod_plain(
                    x, reps=reps, dtype=kw["dtype"])
            torch.cuda.synchronize()
            err = float((k - p).abs().max())
            if not (torch.isfinite(k).all() and err == 0.0):
                raise RuntimeError(f"G={g} {name}, {reps} reps: max |kernel - plain| {err} "
                                   f"(expected 0)")
            if kind == "scan" and reps <= 2 and not float(k.min()) > 0.0:
                raise RuntimeError(f"G={g} {name}, {reps} reps: the values underflowed, the "
                                   f"comparison checks nothing")
            worst[name] = max(worst[name], err)
    return worst


def measure(device, g: int, reps: int = mb.REPS) -> dict[str, float]:
    """Milliseconds of each variant on G slabs."""
    x = slabs(g, device)
    out = {}
    for name, kind, kw in VARIANTS:
        fn = mb.alu_elementwise if kind == "alu" else mb.scan_prod
        out[name] = device_ms(lambda: fn(x, reps=reps, **kw))
    return out


def report(ms: dict[str, float], g: int, log=print) -> dict[str, float]:
    for name, t in ms.items():
        log(f"G={g:<4d}{name:36s}: {t:8.4f} ms total, {t / (g * mb.REPS) * 1e6:9.1f} ns per rep-block")
    def scan(dtype, impl):
        return ms[variant("scan", dtype, impl)]

    ratios = {"bf16_elemwise_speedup": ms[variant("alu", "f32")] / ms[variant("alu", "bf16")],
              "shfl_vs_smem": scan("f32", "smem") / scan("f32", "shfl"),
              "reg_vs_shfl": scan("f32", "shfl") / scan("f32", "reg"),
              "reg_vs_shfl_bf16": scan("bf16", "shfl") / scan("bf16", "reg"),
              **{f"bf16_scan_speedup_{impl}": scan("f32", impl) / scan("bf16", impl)
                 for impl in mb.SCAN_IMPLS}}
    log(f"G={g:<4d}  bf16 elemwise speedup: {ratios['bf16_elemwise_speedup']:.2f}x   registers vs "
        f"shuffles: {ratios['reg_vs_shfl']:.2f}x (f32), {ratios['reg_vs_shfl_bf16']:.2f}x "
        f"(bf16x2)   shuffles vs shared memory: {ratios['shfl_vs_smem']:.2f}x   bf16 scan "
        f"speedup: {ratios['bf16_scan_speedup_reg']:.2f}x (registers), "
        f"{ratios['bf16_scan_speedup_shfl']:.2f}x (shuffles), "
        f"{ratios['bf16_scan_speedup_smem']:.2f}x (shared memory)")
    return ratios


# the float instructions of T1a's four operations in SASS
ALU_OPCODES = {"f32": ("FMUL", "FADD", "FMNMX"), "bf16": ("HMUL2", "HADD2", "HFMA2", "HMNMX2")}
RUNTIME_UNROLL = 8  # csrc/microbench_alu.cu::alu_reps: the run-time loop's unroll


def _innermost_loops(instrs: list[tuple[int, str, str]], labels: dict[str, int]) -> list:
    """(first, last) addresses of the loops of one function's SASS (a
    backward branch and its target) that hold no other loop."""
    loops = []
    for addr, op, text in instrs:
        if op != "BRA":
            continue
        m = re.search(r"`\((\.L_x_\d+)\)", text) or re.search(r"BRA\s+(0x[0-9a-f]+)", text)
        if not m:
            continue
        target = labels.get(m.group(1)) if m.group(1).startswith(".") else int(m.group(1), 16)
        if target is not None and target <= addr:
            loops.append((target, addr))
    return [lp for lp in loops
            if not any(o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]


def alu_sass() -> dict:
    """csrc/microbench_alu.cu compiled on its own as the library compiles
    it, plus -Xptxas -v and a cubin: for each instance of T1a's kernel
    ("f32 reps=64": unrolled whole; "bf16 reps=0": the run-time loop), its
    registers, stack frame and spill bytes, the count of each opcode of
    ALU_OPCODES in the whole function, and, from its innermost loop that
    holds the most of them (the loop over a thread's passes with 64
    repetitions unrolled, or the run-time loop's body of RUNTIME_UNROLL
    repetitions), those per value (per packed pair for bf16) and
    repetition ("per_chain_rep"). At 2 repetitions the compiler unrolls
    the passes as well, so no ratio is given there. Needs nvcc and
    cuobjdump (the CUDA toolkit), not a GPU."""
    from lichtfeld_studio_tpu_torch.kernels import _build

    nvcc = _build._nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / "alu.cubin"
        built = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-cubin", "-o",
                                str(cubin), str(_build.CSRC_DIR / "microbench_alu.cu")],
                               capture_output=True, text=True, check=True)
        sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass", str(cubin)],
                              capture_output=True, text=True, check=True).stdout

    def instance(mangled):  # alu_kernel<kBf16, kReps>
        m = re.search(r"alu_kernelILb([01])ELi(\d+)E", mangled)
        return f"{'bf16' if m.group(1) == '1' else 'f32'} reps={m.group(2)}" if m else None

    out = {}
    name = None
    for line in (built.stdout + built.stderr).splitlines():
        if "Compiling entry function" in line:
            name = instance(line)
        elif name and "Used" in line and "registers" in line:
            out.setdefault(name, {})["registers"] = int(re.search(r"Used (\d+) registers",
                                                                  line).group(1))
        elif name and "stack frame" in line:
            stack, stores, loads = map(int, re.findall(r"(\d+) bytes", line)[:3])
            out.setdefault(name, {}).update(stack=stack, spill_stores=stores, spill_loads=loads)
    code = {}  # instance -> ([(address, opcode, text)], {label: address})
    name = None
    pending = []
    for line in sass.splitlines():
        if "Function :" in line:
            name = instance(line)
            if name:
                code[name] = ([], {})
        elif name and re.match(r"\s*\.L_x_\d+:", line):
            pending.append(line.strip()[:-1])
        elif name:
            m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", line)
            if m:
                addr = int(m.group(1), 16)
                code[name][0].append((addr, m.group(2), line))
                code[name][1].update(dict.fromkeys(pending, addr))
                pending = []
    for name, (instrs, labels) in code.items():
        kind, reps = name.split()[0], int(name.split("=")[1])
        r = out.setdefault(name, {})
        ops = [op for _, op, _ in instrs if op in ALU_OPCODES[kind]]
        r["opcodes"] = {op: ops.count(op) for op in ALU_OPCODES[kind] if op in ops}
        if reps not in (0, mb.REPS):
            continue
        in_loop = [sum(1 for a, op, _ in instrs if lo <= a <= hi and op in ALU_OPCODES[kind])
                   for lo, hi in _innermost_loops(instrs, labels)]
        if in_loop:
            values = 8 if kind == "f32" else 4  # a thread's chains
            r["loop_float_ops"] = max(in_loop)
            r["per_chain_rep"] = max(in_loop) / (values * (reps or RUNTIME_UNROLL))
    return out


def main(argv=None) -> int:
    if "--sass" in (sys.argv[1:] if argv is None else argv):
        print(json.dumps(alu_sass()), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("microbench_bf16_vpu needs an NVIDIA GPU (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    from lichtfeld_studio_tpu_torch.tools.scenes import card

    print(f"card: {card()}", flush=True)
    dev = torch.device("cuda")
    for g in GRIDS:
        worst = max(check(dev, g).values())
        print(f"G={g}: every variant equals its plain version at {CHECK_REPS} repetitions "
              f"(max |diff| {worst})", flush=True)
        report(measure(dev, g), g)
    return 0


if __name__ == "__main__":
    sys.exit(main())
