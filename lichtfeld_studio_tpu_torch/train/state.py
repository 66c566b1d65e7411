"""Training state and the train step (counterpart of
lichtfeld_studio_tpu/train/state.py; reference Trainer::train_step,
src/training/trainer.cpp:579-858).

One step: render -> L1+SSIM loss (+ scale and opacity regs) -> backward
-> the strategy's post_backward -> Adam -> ExponentialLR on the means group. Eager
PyTorch: the metrics stay tensors on the device, so a step makes no host
round trip. `train_steps_scanned` is the JAX lax.scan as a loop. The loss,
MCMC and Adam run inside profiler ranges (profiling.stage), as the
render's stages do.

Both strategies are ported, MCMC and ADC (`strategy="default"`), on every
projection: EWA, UT (`--gut`) and the exact world-space blend
(`projection="ut", gut_exact=True`, the `--gut-exact` flag). ADC reads
d loss / d mean2d of the render (RenderOutput.mean2d, an extra input of the
one autograd pass) into its densification statistics. Pose optimisation,
the bilateral grid, background modulation and sparsity raise
NotImplementedError with their ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from lichtfeld_studio_tpu_torch.core.camera import CameraParams
from lichtfeld_studio_tpu_torch.core.splat_data import SplatData
from lichtfeld_studio_tpu_torch.ops.adam import AdamState, adam_step, init_adam, scale_lrs
from lichtfeld_studio_tpu_torch.ops.losses import (
    opacity_reg_loss,
    photometric_loss,
    scale_reg_loss,
)
from lichtfeld_studio_tpu_torch.ops.mcmc_ops import make_binoms
from lichtfeld_studio_tpu_torch.ops.rasterize import RenderOutput, rasterize
from lichtfeld_studio_tpu_torch.profiling import stage
from lichtfeld_studio_tpu_torch.train.strategies import adc as adc_strategy
from lichtfeld_studio_tpu_torch.train.strategies import mcmc as mcmc_strategy
from lichtfeld_studio_tpu_torch.train.strategies.mcmc import MCMCConfig


@dataclass(frozen=True)
class TrainConfig:
    """Training configuration: the JAX package's fields that the ported
    path reads, and the switches of the features it does not port yet
    (they raise)."""

    iterations: int = 30_000
    lambda_dssim: float = 0.2
    scale_reg: float = 0.01
    opacity_reg: float = 0.01
    raster_mode: str = "cuda"  # cuda | oracle
    tile_size: int = 32
    instance_cap: int = 2**20
    projection: str = "auto"  # auto | ewa | ut (--gut forces "ut")
    antialiasing: bool = False  # Mip-Splatting opacity compensation
    gut_exact: bool = False  # exact per-pixel world-space blend (--gut-exact)
    strategy: str = "mcmc"  # mcmc | default (ADC)
    mcmc: MCMCConfig = MCMCConfig()
    lr_gamma: float = 0.01 ** (1.0 / 30_000)  # ExponentialLR (mcmc.cpp:497)
    # ADC (default strategy) parameters, read when strategy == "default"
    grad_threshold: float = 2e-4
    prune_opacity: float = 0.005
    grow_scale3d: float = 0.01
    grow_scale2d: float = 0.05
    prune_scale3d: float = 0.1
    prune_scale2d: float = 0.15
    reset_every: int = 3_000
    pause_refine_after_reset: int = 0
    revised_opacity: bool = False
    pose_mode: str = "none"
    use_bilateral_grid: bool = False
    bg_modulation: bool = False
    enable_sparsity: bool = False

    def __post_init__(self):
        not_ported = {
            "pose optimisation, ROADMAP.md queue 1, item 6": self.pose_mode != "none",
            "the bilateral grid, ROADMAP.md queue 1, item 6": self.use_bilateral_grid,
            "background modulation, ROADMAP.md queue 1, item 6": self.bg_modulation,
            "sparsity, ROADMAP.md queue 1, item 6": self.enable_sparsity,
        }
        for what, requested in not_ported.items():
            if requested:
                raise NotImplementedError(f"not ported yet: {what}")
        if self.strategy not in ("mcmc", "default"):
            raise ValueError(f"unknown strategy {self.strategy}")
        if self.raster_mode not in ("cuda", "oracle"):
            raise ValueError(f"raster_mode must be 'cuda' or 'oracle', got {self.raster_mode!r}")


@dataclass(frozen=True)
class StepFlags:
    """Per-step schedule flags, known on the host in advance (the JAX
    package's static step variants; its sparsity flags belong to a feature
    not ported yet)."""

    refine: bool = False
    sh_step: bool = False
    reset: bool = False  # ADC opacity reset
    shn_frozen: bool = False  # shN frozen for iter <= 1000 (fused_adam.cpp:69-71)


def step_flags(cfg: TrainConfig, iteration: int) -> StepFlags:
    """Flags for a (1-based) iteration: is_refining (mcmc.cpp:500-505,
    default_strategy.cpp:31-35), the SH cadence, the ADC opacity reset and
    the shN freeze."""
    m = cfg.mcmc
    refine = m.start_refine < iteration < m.stop_refine and iteration % m.refine_every == 0
    reset = False
    if cfg.strategy != "mcmc":
        refine = refine and iteration % cfg.reset_every >= cfg.pause_refine_after_reset
        # the opacity resets ONLY inside the refinement window: the
        # reference's post_backward returns before the reset once
        # iter >= stop_refine (default_strategy.cpp:304-318); a reset on or
        # after stop_refine would never recover, no refinement follows it
        reset = iteration % cfg.reset_every == 0 and 0 < iteration < m.stop_refine
    return StepFlags(
        refine=refine,
        sh_step=iteration % m.sh_degree_interval == 0,
        reset=reset,
        shn_frozen=iteration <= 1000,
    )


@dataclass
class TrainState:
    splats: SplatData
    adam: AdamState
    generator: torch.Generator  # every random draw of the step, on the device
    iteration: int  # completed steps
    binoms: torch.Tensor  # [51, 51] MCMC binomial table
    # ADC densification statistics (reference _densification_info [2, N],
    # splat_data.hpp:97): visible count and pixel-scaled mean2d
    # gradient-norm sums
    densify_count: torch.Tensor  # [C]
    densify_grad: torch.Tensor  # [C]


def make_lrs(opt_means_lr: float, shs_lr: float, scaling_lr: float,
             rotation_lr: float, opacity_lr: float, scene_scale: float) -> dict[str, float]:
    """Per-group LRs (reference mcmc.cpp:487-492): the means lr is scaled by
    the scene scale; shN uses shs_lr / 20."""
    return {
        "means": opt_means_lr * scene_scale,
        "sh0": shs_lr,
        "shN": shs_lr / 20.0,
        "scaling": scaling_lr,
        "rotation": rotation_lr,
        "opacity": opacity_lr,
    }


def init_train_state(splats: SplatData, lrs: dict[str, float], seed: int = 0) -> TrainState:
    dev = splats.means.device
    return TrainState(
        splats=splats,
        adam=init_adam({k: p.detach() for k, p in splats.trainable_dict().items()}, lrs),
        generator=torch.Generator(device=dev).manual_seed(seed),
        iteration=0,
        binoms=make_binoms(device=dev),
        densify_count=torch.zeros(splats.capacity, dtype=torch.float32, device=dev),
        densify_grad=torch.zeros(splats.capacity, dtype=torch.float32, device=dev),
    )


def compute_grads(
    state: TrainState,
    camera: CameraParams,
    gt_image: torch.Tensor,  # [H, W, 3]
    bg_color: torch.Tensor,  # [3]
    cfg: TrainConfig,
) -> tuple[torch.Tensor, RenderOutput, dict[str, torch.Tensor]]:
    """Render + loss + backward for one camera: (loss, render output,
    per-group gradients). Nothing is written to .grad. With the ADC
    strategy the gradients carry "_mean2d", d loss / d mean2d [C, 2], from
    the same backward pass (the JAX package's zero dummy,
    rasterize.py:200-203); it is zero where the blend does not read the
    projected means (the exact world-space blend)."""
    s = state.splats
    out = rasterize(s, camera, bg_color, mode=cfg.raster_mode, tile_size=cfg.tile_size,
                    instance_cap=cfg.instance_cap, projection=cfg.projection,
                    gut_exact=cfg.gut_exact, antialiasing=cfg.antialiasing)
    with stage("loss"):
        loss = photometric_loss(out.image, gt_image, cfg.lambda_dssim)
        loss = loss + scale_reg_loss(s, cfg.scale_reg) + opacity_reg_loss(s, cfg.opacity_reg)
    params = s.trainable_dict()
    need_m2d = cfg.strategy == "default"
    inputs = list(params.values()) + ([out.mean2d] if need_m2d else [])
    grads = torch.autograd.grad(loss, inputs, allow_unused=need_m2d)
    named = dict(zip(params, grads))
    if need_m2d:
        named["_mean2d"] = grads[-1] if grads[-1] is not None else torch.zeros_like(out.mean2d)
    out.image = out.image.detach()
    out.alpha = out.alpha.detach()
    out.mean2d = out.mean2d.detach()
    return loss.detach(), out, named


@torch.no_grad()
def apply_update(
    state: TrainState,
    grads: dict[str, torch.Tensor],
    cfg: TrainConfig,
    loss: torch.Tensor,
    out: RenderOutput,
    flags: StepFlags = StepFlags(),
    draws: dict[str, torch.Tensor] | None = None,
) -> tuple[TrainState, dict[str, torch.Tensor]]:
    """The strategy's post_backward, then Adam on the (possibly relocated)
    parameters with this step's gradients, then ExponentialLR on the means
    group (the reference's order, trainer.cpp:745-758). `state` is updated
    in place and returned. `draws` replaces the generator's draws (see
    mcmc.post_backward and adc.post_backward)."""
    grads = dict(grads)
    dmean2d = grads.pop("_mean2d", None)
    if cfg.strategy == "mcmc":
        with stage("MCMC"):
            splats, adam = mcmc_strategy.post_backward(
                state.generator, state.splats, state.adam, state.binoms, cfg.mcmc,
                refine=flags.refine, sh_step=flags.sh_step, draws=draws,
            )
    else:
        with stage("ADC"):
            # this step's densification statistics: pixel-scaled mean2d
            # gradient norms of the visible gaussians
            # (kernels_backward.cuh:233-235)
            half = torch.tensor([0.5 * out.width, 0.5 * out.height], dtype=torch.float32,
                                device=dmean2d.device)
            gnorm = torch.linalg.norm(dmean2d * half[None, :], dim=-1)
            state.densify_count = state.densify_count + out.visibility.to(torch.float32)
            state.densify_grad = state.densify_grad + torch.where(out.visibility, gnorm, 0.0)
            splats, adam, state.densify_count, state.densify_grad = adc_strategy.post_backward(
                state.generator, state.iteration + 1, state.splats, state.adam,
                state.densify_count, state.densify_grad, cfg,
                refine=flags.refine, sh_step=flags.sh_step, reset=flags.reset, draws=draws,
            )
    with stage("Adam"):
        params, adam = adam_step(
            {k: p.detach() for k, p in splats.trainable_dict().items()}, grads, adam,
            static_skip=("shN",) if flags.shn_frozen else (),
        )
        splats.replace_trainable(params)
        state.adam = scale_lrs(adam, cfg.lr_gamma, ("means",))  # ExponentialLR, group 0
    state.iteration += 1
    metrics = {
        "loss": loss,
        "n_active": splats.n_active.clone(),
        "n_instances": out.n_instances,
        # health sentinel: non-finite parameter entries
        "n_nonfinite": (~torch.isfinite(splats.means)).sum() + (~torch.isfinite(splats.scaling)).sum(),
    }
    return state, metrics


def train_step(
    state: TrainState,
    camera: CameraParams,
    gt_image: torch.Tensor,
    bg_color: torch.Tensor,
    cfg: TrainConfig,
    flags: StepFlags = StepFlags(),
) -> tuple[TrainState, dict[str, torch.Tensor]]:
    """One camera per step, like the reference (batch size 1)."""
    loss, out, grads = compute_grads(state, camera, gt_image, bg_color, cfg)
    return apply_update(state, grads, cfg, loss, out, flags)


def train_steps_scanned(
    state: TrainState,
    cameras: CameraParams,  # w2c [K, 4, 4], cam_position [K, 3], K [K, 4], w2c_end [K, 4, 4]
    gt_images: torch.Tensor,  # [K, H, W, 3]
    bg_color: torch.Tensor,
    cfg: TrainConfig,
    flags: StepFlags = StepFlags(),
) -> tuple[TrainState, dict[str, torch.Tensor]]:
    """K train steps over stacked cameras, all with `flags`; metrics
    stacked [K]. The same math as K calls of train_step. The camera model,
    distortion and shutter are shared by the K views; the poses (and the
    end-of-frame poses of a rolling shutter) are stacked."""
    steps = []
    for k in range(gt_images.shape[0]):
        cam = dataclasses.replace(
            cameras, w2c=cameras.w2c[k], cam_position=cameras.cam_position[k], K=cameras.K[k],
            w2c_end=cameras.w2c_end[k] if cameras.w2c_end is not None else None)
        state, metrics = train_step(state, cam, gt_images[k], bg_color, cfg, flags)
        steps.append(metrics)
    return state, {k: torch.stack([m[k] for m in steps]) for k in steps[0]}
