"""Command-line interface of the port (counterpart of
lichtfeld_studio_tpu/cli.py; reference src/core/argument_parser.cpp: ~45
flags, three-stage config: CLI parse -> strategy JSON defaults -> CLI
overrides -> steps_scaler). Every flag of the JAX package's CLI parses, so
reference invocations port directly:

    python -m lichtfeld_studio_tpu_torch -d <dir> -o <dir> --headless --eval ...
    python -m lichtfeld_studio_tpu_torch -v scene.ply --render-output view.png
    python -m lichtfeld_studio_tpu_torch -v a.ply,b.sog --render-output view.png
    python -m lichtfeld_studio_tpu_torch -v scene.sog --render-output viewer.html
    python -m lichtfeld_studio_tpu_torch -d <dir> --live-viewer 8080 ...
    python -m lichtfeld_studio_tpu_torch --live-viewer 8080   (the studio lobby)

Training and rendering run on the first GPU; without one the CLI exits 1.
The .html viewer export computes on the host and needs no GPU. A flag
whose feature is not ported yet (--devices > 1) exits 2 with "not ported
yet: <flag> (ROADMAP queue 1, item N)", after parsing.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
import zipfile
from pathlib import Path

from lichtfeld_studio_tpu_torch.config.parameters import (
    DatasetConfig,
    TrainingParameters,
    apply_step_scaling,
    load_optim_params_from_json,
    preset_for_strategy,
)

RENDER_MODES = {"RGB", "D", "ED", "RGB_D", "RGB_ED"}
POSE_MODES = {"none", "direct", "mlp"}
STRATEGIES = {"mcmc", "default"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="lfs-torch",
        description="LichtFeld-Studio on PyTorch + CUDA: 3D Gaussian Splatting on one NVIDIA GPU",
    )
    # dataset
    p.add_argument("-d", "--data-path", type=str, default="")
    p.add_argument("-o", "--output-path", type=str, default="output")
    p.add_argument("--project-path", type=str, default="")
    p.add_argument("--images", type=str, default="images")
    p.add_argument("-r", "--resize-factor", type=int, default=-1)
    p.add_argument("--max-width", type=int, default=3840)
    p.add_argument("--test-every", type=int, default=8)
    p.add_argument("--timelapse-every", type=int, default=50)
    p.add_argument("--timelapse-images", type=str, nargs="*", default=[])
    # core training
    p.add_argument("-i", "--iterations", type=int, default=None)
    p.add_argument("--strategy", type=str, default="mcmc", choices=sorted(STRATEGIES))
    p.add_argument("--config", type=str, default="", help="JSON optimization params")
    p.add_argument("--sh-degree", type=int, default=None)
    p.add_argument("--max-cap", type=int, default=None)
    p.add_argument("--min-opacity", type=float, default=None)
    p.add_argument("--refine-every", type=int, default=None)
    p.add_argument("--start-refine", type=int, default=None)
    p.add_argument("--stop-refine", type=int, default=None)
    p.add_argument("--grad-threshold", type=float, default=None)
    p.add_argument("--opacity-reg", type=float, default=None)
    p.add_argument("--scale-reg", type=float, default=None)
    p.add_argument("--steps-scaler", type=float, default=None)
    # ADC (default strategy) parameters
    p.add_argument("--prune-opacity", type=float, default=None)
    p.add_argument("--grow-scale3d", type=float, default=None)
    p.add_argument("--grow-scale2d", type=float, default=None)
    p.add_argument("--prune-scale3d", type=float, default=None)
    p.add_argument("--prune-scale2d", type=float, default=None)
    p.add_argument("--reset-every", type=int, default=None)
    p.add_argument("--pause-refine-after-reset", type=int, default=None)
    p.add_argument("--revised-opacity", action="store_true")
    p.add_argument("--sh-degree-interval", type=int, default=None,
                   help="iterations between SH degree increments")
    p.add_argument("--save-depth", action="store_true",
                   help="save eval depth colormaps (forces a depth channel)")
    p.add_argument("--eval", action="store_true", help="enable evaluation")
    p.add_argument("--headless", action="store_true")
    p.add_argument("--render-mode", type=str, default=None, choices=sorted(RENDER_MODES))
    p.add_argument("--pose-optimization", type=str, default=None, choices=sorted(POSE_MODES))
    p.add_argument("--preload-to-ram", action="store_true")
    p.add_argument("--bg-modulation", action="store_true")
    p.add_argument("--antialiasing", action="store_true")
    p.add_argument("--gut", action="store_true")
    p.add_argument("--gut-exact", action="store_true", dest="gut_exact",
                   help="per-pixel world-space GUT blend (exact, slower)")
    p.add_argument("--num-workers", type=int, default=None)
    p.add_argument("--skip-intermediate", action="store_true")
    p.add_argument("--save-eval-images", action="store_true", default=None)
    p.add_argument("--eval-steps", type=int, nargs="*", default=None)
    p.add_argument("--save-steps", type=int, nargs="*", default=None)
    # bilateral grid
    p.add_argument("--bilateral-grid", action="store_true")
    p.add_argument("--bilateral-grid-x", type=int, default=None)
    p.add_argument("--bilateral-grid-y", type=int, default=None)
    p.add_argument("--bilateral-grid-w", type=int, default=None)
    p.add_argument("--tv-loss-weight", type=float, default=None)
    # init
    p.add_argument("--init-ply", type=str, default=None)
    p.add_argument("--random", action="store_true", dest="random_init")
    p.add_argument("--init-num-pts", type=int, default=None)
    p.add_argument("--init-extent", type=float, default=None)
    # sparsity
    p.add_argument("--sparsity", action="store_true", dest="enable_sparsity")
    p.add_argument("--sparsify-steps", type=int, default=None)
    p.add_argument("--prune-ratio", type=float, default=None)
    p.add_argument("--init-rho", type=float, default=None)
    # export
    p.add_argument("--sog", action="store_true", dest="save_sog")
    p.add_argument("--sog-iterations", type=int, default=None)
    # metrics / resume
    p.add_argument("--lpips-weights", type=str, default=None,
                   help="VGG-LPIPS weights npz (enables the lpips column)")
    p.add_argument("--save-state-every", type=int, default=None,
                   help="snapshot full training state every N iters")
    p.add_argument("--resume", type=str, default="",
                   help="resume from a state snapshot directory")
    # viewer / render
    p.add_argument("-v", "--view", type=str, default="",
                   help="render splat file(s) headlessly; comma-separate "
                        "multiple .ply/.sog for a multi-model scene "
                        "(composite render / viewer with visibility toggles)")
    p.add_argument("--render-output", type=str, default="render.png")
    p.add_argument(
        "--render-size", type=int, nargs=2, default=[1920, 1080],
        metavar=("W", "H"), help="headless render resolution",
    )
    p.add_argument("--viewer-max-points", type=int, default=1_000_000,
                   help="embed size cap for the HTML viewer export")
    p.add_argument("--live-viewer", type=int, default=None, metavar="PORT",
                   help="serve a live training viewer with pause/resume/"
                        "save/stop controls on this port (0 = ephemeral)")
    # static capacities and dispatch
    p.add_argument("--instance-cap", type=int, default=None)
    p.add_argument("--dispatch-steps", type=int, default=None,
                   help="steps per dispatch between host-visible boundaries")
    p.add_argument("--devices", type=int, default=None,
                   help="camera-batch data parallelism over N devices")
    p.add_argument("--log-level", type=str, default="info")
    return p


_OVERRIDE_MAP = {
    # argparse dest -> OptimizationParameters field
    "iterations": "iterations",
    "sh_degree": "sh_degree",
    "sh_degree_interval": "sh_degree_interval",
    "max_cap": "max_cap",
    "min_opacity": "min_opacity",
    "refine_every": "refine_every",
    "start_refine": "start_refine",
    "stop_refine": "stop_refine",
    "grad_threshold": "grad_threshold",
    "opacity_reg": "opacity_reg",
    "scale_reg": "scale_reg",
    "steps_scaler": "steps_scaler",
    "render_mode": "render_mode",
    "pose_optimization": "pose_optimization",
    "num_workers": "num_workers",
    "eval_steps": "eval_steps",
    "save_steps": "save_steps",
    "bilateral_grid_x": "bilateral_grid_X",
    "bilateral_grid_y": "bilateral_grid_Y",
    "bilateral_grid_w": "bilateral_grid_W",
    "tv_loss_weight": "tv_loss_weight",
    "init_num_pts": "init_num_pts",
    "init_extent": "init_extent",
    "sparsify_steps": "sparsify_steps",
    "prune_ratio": "prune_ratio",
    "init_rho": "init_rho",
    "sog_iterations": "sog_iterations",
    "instance_cap": "instance_cap",
    "dispatch_steps": "dispatch_steps",
    "devices": "devices",
    "lpips_weights": "lpips_weights",
    "save_state_every": "save_state_every",
    "save_eval_images": "enable_save_eval_images",
    "prune_opacity": "prune_opacity",
    "grow_scale3d": "grow_scale3d",
    "grow_scale2d": "grow_scale2d",
    "prune_scale3d": "prune_scale3d",
    "prune_scale2d": "prune_scale2d",
    "reset_every": "reset_every",
    "pause_refine_after_reset": "pause_refine_after_reset",
}
_FLAG_MAP = {
    "eval": "enable_eval",
    "headless": "headless",
    "preload_to_ram": "preload_to_ram",
    "bg_modulation": "bg_modulation",
    "antialiasing": "antialiasing",
    "gut": "gut",
    "gut_exact": "gut_exact",
    "skip_intermediate": "skip_intermediate_saving",
    "bilateral_grid": "use_bilateral_grid",
    "random_init": "random_init",
    "enable_sparsity": "enable_sparsity",
    "save_sog": "save_sog",
    "revised_opacity": "revised_opacity",
    "save_depth": "save_depth",
}


def parse_args_and_params(argv: list[str] | None = None) -> TrainingParameters:
    """Three-stage config resolution
    (reference argument_parser.cpp:447-492 + apply_cmd_overrides :322-413)."""
    args = build_parser().parse_args(argv)

    # 1. strategy-selected JSON defaults (or explicit --config)
    if args.config:
        opt = load_optim_params_from_json(args.config)
    else:
        opt = preset_for_strategy(args.strategy)
    opt = dataclasses.replace(opt, strategy=args.strategy)

    # 2. CLI overrides on top of JSON
    upd = {}
    for dest, fieldname in _OVERRIDE_MAP.items():
        v = getattr(args, dest, None)
        if v is not None:
            upd[fieldname] = v
    for dest, fieldname in _FLAG_MAP.items():
        if getattr(args, dest, False):
            upd[fieldname] = True
    opt = dataclasses.replace(opt, **upd)

    # 3. steps_scaler rescaling
    opt = apply_step_scaling(opt)

    ds = DatasetConfig(
        data_path=args.data_path,
        output_path=args.output_path,
        project_path=args.project_path,
        images=args.images,
        resize_factor=args.resize_factor,
        test_every=args.test_every,
        timelapse_images=args.timelapse_images,
        timelapse_every=args.timelapse_every,
        max_width=args.max_width,
    )
    return TrainingParameters(
        dataset=ds, optimization=opt, ply_path=args.view, init_ply=args.init_ply,
        resume=args.resume,
    )


def _view(args: argparse.Namespace, spec: str) -> int:
    """-v: render the model(s) to a PNG on the GPU, or export the HTML
    viewer on the host. Comma-separated paths are a multi-model scene (the
    reference SceneManager's multi-PLY scene graph,
    src/visualizer/scene/scene_manager.cpp)."""
    from lichtfeld_studio_tpu_torch.render import headless

    paths = [p.strip() for p in spec.split(",") if p.strip()]
    for p in paths:
        if not os.path.exists(p):
            print(f"error: splat file not found: {p}", file=sys.stderr)
            return 2
    named = []
    for p in paths:
        try:
            named.append((Path(p).stem, headless.splats_from_ply(p)))
        except (OSError, ValueError, KeyError, IndexError, zipfile.BadZipFile) as e:
            # a corrupt or non-splat file
            print(f"error: could not load splat file {p}: {e}", file=sys.stderr)
            return 2
    out = Path(args.render_output)
    out.parent.mkdir(parents=True, exist_ok=True)
    if out.suffix == ".html":
        # the WebGL export is host numpy: the models stay on the CPU
        from lichtfeld_studio_tpu_torch.render.web_viewer import export_html

        export_html(named if len(named) > 1 else named[0][1], out,
                    max_points=args.viewer_max_points)
        print(f"interactive viewer written to {out} — open in any browser")
        return 0
    # the device is checked after every argument: a bad argument returns 2
    # on any machine, and nothing renders without a GPU
    try:
        device = headless.default_device()
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    splats = headless.concat_splats([s for _, s in named]).to(device)
    headless.render_ply_orbit(
        splats, str(out), width=args.render_size[0], height=args.render_size[1],
    )
    return 0


def _studio(args: argparse.Namespace, device) -> int:
    """The studio lobby (reference run_gui_app with no data,
    application.cpp:56-138): open datasets and models, start runs, crop,
    transform and save, all from the browser, until interrupted."""
    from lichtfeld_studio_tpu_torch.render.live_server import LiveTrainingServer
    from lichtfeld_studio_tpu_torch.render.studio import StudioSession

    server = LiveTrainingServer(StudioSession(out_dir=args.output_path, device=device),
                                port=args.live_viewer).start()
    print("studio session — open a dataset or model from the browser", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


def main(argv: list[str] | None = None) -> int:
    params = parse_args_and_params(argv)
    args = build_parser().parse_args(argv)

    from lichtfeld_studio_tpu_torch.core.logging import setup_logging

    setup_logging(args.log_level)

    from lichtfeld_studio_tpu_torch.train.trainer import unported_features

    missing = unported_features(params)
    if missing:
        print("error: not ported yet: " + "; ".join(missing), file=sys.stderr)
        return 2

    if params.ply_path:  # headless render / interactive viewer export
        return _view(args, str(params.ply_path))

    from lichtfeld_studio_tpu_torch.render import headless

    studio = not params.dataset.data_path and args.live_viewer is not None
    if not params.dataset.data_path and not studio:
        print("error: --data-path required for training", file=sys.stderr)
        return 2
    if not studio and not os.path.exists(params.dataset.data_path):
        print(f"error: dataset not found: {params.dataset.data_path}", file=sys.stderr)
        return 2

    # nothing trains or renders without a GPU (the tests ask for the CPU
    # themselves)
    try:
        device = headless.default_device()
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if studio:
        return _studio(args, device)

    from lichtfeld_studio_tpu_torch.train.trainer import Trainer

    try:
        trainer = Trainer.setup(params, device)
    except ValueError as e:  # unrecognised dataset, shrinking resume
        print(f"error: {e}", file=sys.stderr)
        return 2

    def progress(it, loss, n):
        print(f"iter {it:>6}  loss {loss:.5f}  gaussians {n}", flush=True)

    trainer.progress_callback = progress
    server = None
    if args.live_viewer is not None:
        from lichtfeld_studio_tpu_torch.render.live_server import LiveTrainingServer

        # mark training active BEFORE the server accepts requests: a render
        # arriving before train() sets the flag would run on the HTTP thread
        # and race the first dispatch's in-place writes
        trainer.training_active = True
        server = LiveTrainingServer(trainer, port=args.live_viewer).start()
        trainer.control = server.control
    try:
        stats = trainer.train()
    finally:
        if server is not None:
            server.stop()
    print(
        f"done: {stats['elapsed_s']:.1f}s ({stats['iters_per_s']:.2f} it/s), "
        f"{stats['num_gaussians']} gaussians, final loss {stats['final_loss']:.5f}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
