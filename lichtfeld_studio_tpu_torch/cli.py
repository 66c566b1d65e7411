"""Command-line interface of the port (counterpart of
lichtfeld_studio_tpu/cli.py). Only the headless render is ported:

    python -m lichtfeld_studio_tpu_torch -v scene.ply --render-output view.png \
        [--render-size W H]

Every other flag of the JAX package's CLI fails with a "not ported yet"
message (ROADMAP.md lists the order in which they come).
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="lfs-torch",
        description="LichtFeld-Studio on PyTorch + CUDA: headless render",
    )
    p.add_argument("-v", "--view", type=str, default="",
                   help="render a splat .ply headlessly")
    p.add_argument("--render-output", type=str, default="render.png")
    p.add_argument(
        "--render-size", type=int, nargs=2, default=[1920, 1080],
        metavar=("W", "H"), help="headless render resolution",
    )
    return p


def main(argv: list[str] | None = None) -> int:
    args, unknown = build_parser().parse_known_args(argv)
    flags = [a for a in unknown if a.startswith("-")]
    if unknown:
        print(
            f"error: not ported yet to lichtfeld_studio_tpu_torch: {' '.join(flags or unknown)} "
            "(only -v/--view, --render-output and --render-size are; see ROADMAP.md)",
            file=sys.stderr,
        )
        return 2
    if not args.view:
        print(
            "error: training is not ported yet to lichtfeld_studio_tpu_torch; "
            "render a splat with -v scene.ply --render-output view.png",
            file=sys.stderr,
        )
        return 2
    if "," in args.view:
        print("error: multi-model scenes are not ported yet", file=sys.stderr)
        return 2
    if not str(args.render_output).endswith(".png"):
        print(
            f"error: --render-output {args.render_output}: only .png output is "
            "ported yet (the HTML viewer export is not)",
            file=sys.stderr,
        )
        return 2
    path = args.view.strip()
    if not os.path.exists(path):
        print(f"error: splat file not found: {path}", file=sys.stderr)
        return 2

    from lichtfeld_studio_tpu_torch.render.headless import (
        default_device,
        render_ply_orbit,
        splats_from_ply,
    )

    try:
        splats = splats_from_ply(path)
    except (OSError, ValueError, KeyError, IndexError) as e:  # corrupt / non-splat file
        print(f"error: could not load splat file {path}: {e}", file=sys.stderr)
        return 2
    # the device is checked after every argument: a bad argument returns 2
    # on any machine, and nothing renders without a GPU
    try:
        splats = splats.to(default_device())
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    Path(args.render_output).parent.mkdir(parents=True, exist_ok=True)
    render_ply_orbit(
        splats, args.render_output,
        width=args.render_size[0], height=args.render_size[1],
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
