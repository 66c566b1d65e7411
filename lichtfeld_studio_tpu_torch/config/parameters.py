"""Training / dataset configuration.

Field set and defaults mirror the reference's parameter structs
(reference: include/core/parameters.hpp:16-113) so configs and CLI flags are
interchangeable, but this is a plain-Python dataclass layer with JSON load
plus `steps_scaler` rescaling semantics
(reference: src/core/argument_parser.cpp:422-439).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional


@dataclass
class OptimizationParameters:
    iterations: int = 30_000
    sh_degree_interval: int = 1_000
    means_lr: float = 1.6e-4
    shs_lr: float = 2.5e-3
    opacity_lr: float = 0.05
    scaling_lr: float = 5e-3
    rotation_lr: float = 1e-3
    lambda_dssim: float = 0.2
    min_opacity: float = 0.005
    refine_every: int = 100
    start_refine: int = 500
    stop_refine: int = 25_000
    grad_threshold: float = 2e-4
    sh_degree: int = 3
    opacity_reg: float = 0.01
    scale_reg: float = 0.01
    init_opacity: float = 0.5
    init_scaling: float = 0.1
    num_workers: int = 4
    max_cap: int = 1_000_000
    eval_steps: list[int] = field(default_factory=lambda: [7_000, 30_000])
    save_steps: list[int] = field(default_factory=lambda: [7_000, 30_000])
    skip_intermediate_saving: bool = False
    bg_modulation: bool = False
    enable_eval: bool = False
    rc: bool = False
    enable_save_eval_images: bool = True
    headless: bool = True
    render_mode: str = "RGB"  # RGB, D, ED, RGB_D, RGB_ED
    strategy: str = "mcmc"  # mcmc | default
    preload_to_ram: bool = False
    pose_optimization: str = "none"  # none | direct | mlp

    # Bilateral grid parameters
    use_bilateral_grid: bool = False
    bilateral_grid_X: int = 16
    bilateral_grid_Y: int = 16
    bilateral_grid_W: int = 8
    bilateral_grid_lr: float = 2e-3
    tv_loss_weight: float = 10.0

    # Default (ADC) strategy specific parameters
    prune_opacity: float = 0.005
    grow_scale3d: float = 0.01
    grow_scale2d: float = 0.05
    prune_scale3d: float = 0.1
    prune_scale2d: float = 0.15
    reset_every: int = 3_000
    pause_refine_after_reset: int = 0
    revised_opacity: bool = False
    gut: bool = False
    # exact per-pixel world-space GUT blend (reference K13/K14) instead of
    # the UT-conic approximation through the shared tile blend; exact but
    # slower (dense per-tile evaluation)
    gut_exact: bool = False
    steps_scaler: float = 0.0
    antialiasing: bool = False

    # Random initialization parameters
    random_init: bool = False
    init_num_pts: int = 100_000
    init_extent: float = 3.0

    # SOG format parameters
    save_sog: bool = False
    sog_iterations: int = 10

    # Sparsity optimization parameters
    enable_sparsity: bool = False
    sparsify_steps: int = 15_000
    init_rho: float = 5e-4
    prune_ratio: float = 0.6

    # Save eval depth-colormap dumps even in RGB render mode (reference
    # --save-depth, argument_parser.cpp:149; depth dump loop
    # metrics.cpp:454-480): forces the eval renders to carry a depth channel
    save_depth: bool = False
    # LPIPS VGG weights (npz, see ops/lpips.py); "" disables LPIPS like the
    # reference's missing weights/lpips_vgg.pt (metrics.cpp:125-128)
    lpips_weights: str = ""
    # Periodic full training-state snapshots for --resume (0 = disabled;
    # capability beyond the reference, whose checkpoints are exports only)
    save_state_every: int = 0

    config_file: str = ""

    # ------------------------------------------------------------------
    # Knobs with no reference equivalent (static capacities, dispatch)
    # ------------------------------------------------------------------
    # Total capacity of the per-frame instance buffer (tile x gaussian pairs).
    # The sort has this fixed shape; overflow is detected and reported.
    instance_cap: int = 2**21
    # Tile edge in pixels. The reference rasterizer uses 16; 32-px tiles
    # halve the instance count (fewer tiles per gaussian footprint) and with
    # it every binning, sort, gather and gradient-reduction stage.
    tile_size: int = 32
    # Train steps grouped into one dispatch between host-visible boundaries
    # (a loop here; the grouping decides where the host reads the metrics).
    dispatch_steps: int = 8
    # Camera-batch data parallelism over N ranks (parallel/data_parallel.py).
    # One DP step consumes N cameras and counts as ONE iteration with
    # 1/N-averaged gradients. 1 = single device (reference semantics).
    devices: int = 1

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, data: dict) -> "OptimizationParameters":
        # accept reference-style aliases
        aliases = {
            "random": "random_init",
            "skip_intermediate": "skip_intermediate_saving",
        }
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in data.items():
            k = aliases.get(k, k)
            if k in known:
                kwargs[k] = v
        return cls(**kwargs)


@dataclass
class DatasetConfig:
    data_path: str = ""
    output_path: str = ""
    project_path: str = ""
    images: str = "images"
    resize_factor: int = -1
    test_every: int = 8
    timelapse_images: list[str] = field(default_factory=list)
    timelapse_every: int = 50
    max_width: int = 3840


@dataclass
class TrainingParameters:
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    optimization: OptimizationParameters = field(default_factory=OptimizationParameters)
    ply_path: str = ""
    init_ply: Optional[str] = None
    resume: str = ""  # training-state snapshot (train/checkpoint.py) to resume from

    def to_json(self) -> dict:
        return {
            "dataset": dataclasses.asdict(self.dataset),
            "optimization": self.optimization.to_json(),
            "ply_path": self.ply_path,
            "init_ply": self.init_ply,
        }


_STEP_FIELDS = (
    "iterations",
    "start_refine",
    "stop_refine",
    "refine_every",
    "reset_every",
    "sh_degree_interval",
)


def apply_step_scaling(opt: OptimizationParameters) -> OptimizationParameters:
    """Rescale schedule constants by `steps_scaler` when > 0.

    Semantics of reference src/core/argument_parser.cpp:422-439: every step
    schedule (including eval/save lists) is multiplied by the scaler.
    """
    s = opt.steps_scaler
    if s <= 0:
        return opt
    upd = {name: int(getattr(opt, name) * s) for name in _STEP_FIELDS}
    upd["eval_steps"] = [int(v * s) for v in opt.eval_steps]
    upd["save_steps"] = [int(v * s) for v in opt.save_steps]
    return dataclasses.replace(opt, **upd)


_PRESET_DIR = Path(__file__).parent / "presets"


def load_optim_params_from_json(path: str | Path) -> OptimizationParameters:
    with open(path) as f:
        return OptimizationParameters.from_json(json.load(f))


def preset_for_strategy(strategy: str) -> OptimizationParameters:
    """Load the shipped preset for a strategy, mirroring the reference's
    parameter/{strategy}_optimization_params.json selection."""
    path = _PRESET_DIR / f"{strategy}_optimization_params.json"
    if path.exists():
        return load_optim_params_from_json(path)
    return OptimizationParameters(strategy=strategy)


def save_training_parameters_to_json(params: TrainingParameters, path: str | Path) -> None:
    with open(path, "w") as f:
        json.dump(params.to_json(), f, indent=2)
