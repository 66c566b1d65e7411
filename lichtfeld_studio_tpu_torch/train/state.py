"""Training state and the MCMC train step (counterpart of
lichtfeld_studio_tpu/train/state.py; reference Trainer::train_step,
src/training/trainer.cpp:579-858).

One step: render -> L1+SSIM loss (+ scale and opacity regs) -> backward
-> MCMC post_backward -> Adam -> ExponentialLR on the means group. Eager
PyTorch: the metrics stay tensors on the device, so a step makes no host
round trip. `train_steps_scanned` is the JAX lax.scan as a loop. The loss,
MCMC and Adam run inside profiler ranges (profiling.stage), as the
render's stages do.

The MCMC strategy is ported, on every projection: EWA, UT (`--gut`) and
the exact world-space blend (`projection="ut", gut_exact=True`, the
`--gut-exact` flag). The ADC strategy, pose optimisation, the bilateral
grid, background modulation and sparsity raise NotImplementedError with
their ROADMAP.md item.
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
from lichtfeld_studio_tpu_torch.train.strategies import mcmc as mcmc_strategy
from lichtfeld_studio_tpu_torch.train.strategies.mcmc import MCMCConfig


@dataclass(frozen=True)
class TrainConfig:
    """Training configuration: the JAX package's fields that the ported
    path reads, and the switches of the features it does not port yet
    (they raise)."""

    lambda_dssim: float = 0.2
    scale_reg: float = 0.01
    opacity_reg: float = 0.01
    raster_mode: str = "cuda"  # cuda | oracle
    tile_size: int = 32
    instance_cap: int = 2**20
    projection: str = "auto"  # auto | ewa | ut (--gut forces "ut")
    gut_exact: bool = False  # exact per-pixel world-space blend (--gut-exact)
    strategy: str = "mcmc"
    mcmc: MCMCConfig = MCMCConfig()
    lr_gamma: float = 0.01 ** (1.0 / 30_000)  # ExponentialLR (mcmc.cpp:497)
    pose_mode: str = "none"
    use_bilateral_grid: bool = False
    bg_modulation: bool = False
    enable_sparsity: bool = False

    def __post_init__(self):
        not_ported = {
            "strategy='default' (ADC), ROADMAP.md queue 1, item 4": self.strategy != "mcmc",
            "pose optimisation, ROADMAP.md queue 1, item 6": self.pose_mode != "none",
            "the bilateral grid, ROADMAP.md queue 1, item 6": self.use_bilateral_grid,
            "background modulation, ROADMAP.md queue 1, item 6": self.bg_modulation,
            "sparsity, ROADMAP.md queue 1, item 6": self.enable_sparsity,
        }
        for what, requested in not_ported.items():
            if requested:
                raise NotImplementedError(f"not ported yet: {what}")
        if self.raster_mode not in ("cuda", "oracle"):
            raise ValueError(f"raster_mode must be 'cuda' or 'oracle', got {self.raster_mode!r}")


@dataclass(frozen=True)
class StepFlags:
    """Per-step schedule flags, known on the host in advance (the JAX
    package's static step variants; its ADC and sparsity flags belong to
    features not ported yet)."""

    refine: bool = False
    sh_step: bool = False
    shn_frozen: bool = False  # shN frozen for iter <= 1000 (fused_adam.cpp:69-71)


def step_flags(cfg: TrainConfig, iteration: int) -> StepFlags:
    """Flags for a (1-based) iteration: is_refining (mcmc.cpp:500-505), the
    SH cadence and the shN freeze."""
    m = cfg.mcmc
    return StepFlags(
        refine=m.start_refine < iteration < m.stop_refine and iteration % m.refine_every == 0,
        sh_step=iteration % m.sh_degree_interval == 0,
        shn_frozen=iteration <= 1000,
    )


@dataclass
class TrainState:
    splats: SplatData
    adam: AdamState
    generator: torch.Generator  # every random draw of the step, on the device
    iteration: int  # completed steps
    binoms: torch.Tensor  # [51, 51] MCMC binomial table


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
    )


def compute_grads(
    state: TrainState,
    camera: CameraParams,
    gt_image: torch.Tensor,  # [H, W, 3]
    bg_color: torch.Tensor,  # [3]
    cfg: TrainConfig,
) -> tuple[torch.Tensor, RenderOutput, dict[str, torch.Tensor]]:
    """Render + loss + backward for one camera: (loss, render output,
    per-group gradients). Nothing is written to .grad."""
    s = state.splats
    out = rasterize(s, camera, bg_color, mode=cfg.raster_mode, tile_size=cfg.tile_size,
                    instance_cap=cfg.instance_cap, projection=cfg.projection,
                    gut_exact=cfg.gut_exact)
    with stage("loss"):
        loss = photometric_loss(out.image, gt_image, cfg.lambda_dssim)
        loss = loss + scale_reg_loss(s, cfg.scale_reg) + opacity_reg_loss(s, cfg.opacity_reg)
    params = s.trainable_dict()
    grads = torch.autograd.grad(loss, list(params.values()))
    out.image = out.image.detach()
    out.alpha = out.alpha.detach()
    return loss.detach(), out, dict(zip(params, grads))


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
    """MCMC post_backward, then Adam on the (possibly relocated) parameters
    with this step's gradients, then ExponentialLR on the means group (the
    reference's order, trainer.cpp:745-758). `state` is updated in place
    and returned. `draws` replaces the generator's draws (see
    mcmc.post_backward)."""
    with stage("MCMC"):
        splats, adam = mcmc_strategy.post_backward(
            state.generator, state.splats, state.adam, state.binoms, cfg.mcmc,
            refine=flags.refine, sh_step=flags.sh_step, draws=draws,
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
