"""Training state and the train step (counterpart of
lichtfeld_studio_tpu/train/state.py; reference Trainer::train_step,
src/training/trainer.cpp:579-858).

One step: render -> L1+SSIM loss (+ scale and opacity regs) -> backward
-> the strategy's post_backward -> Adam -> ExponentialLR on the means group. Eager
PyTorch: the metrics stay tensors on the device, so a step makes no host
round trip. `train_steps_scanned` is the JAX lax.scan as a loop. The loss,
MCMC and Adam run inside profiler ranges (profiling.stage), as the
render's stages do, and so do the optional components (bg, pose,
bilateral, sparsity).

Both strategies are ported, MCMC and ADC (`strategy="default"`), on every
projection: EWA, UT (`--gut`) and the exact world-space blend
(`projection="ut", gut_exact=True`, the `--gut-exact` flag). ADC reads
d loss / d mean2d of the render (RenderOutput.mean2d, an extra input of the
one autograd pass) into its densification statistics.

The optional components (train/components/): the step's background
modulation, pose optimisation (the adjusted camera keeps its model,
distortion and shutter; the same delta goes onto the end-of-frame pose of
a rolling shutter), the bilateral grid on the rendered image with its TV
term, and the ADMM sparsity phase after `base_iterations`. Pose and grid
parameters train with a second Adam over `aux_params`, a flat dict
("pose.embeddings", "pose.w0", ..., "bilateral").
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
from lichtfeld_studio_tpu_torch.train.components import sparsity
from lichtfeld_studio_tpu_torch.train.components.background import background_for_step
from lichtfeld_studio_tpu_torch.train.components.bilateral_grid import (
    apply_bilateral_grid,
    identity_grids,
    tv_loss,
    warmup_exponential_lr,
)
from lichtfeld_studio_tpu_torch.train.components.poseopt import init_pose_params, pose_delta
from lichtfeld_studio_tpu_torch.train.strategies import adc as adc_strategy
from lichtfeld_studio_tpu_torch.train.strategies import mcmc as mcmc_strategy
from lichtfeld_studio_tpu_torch.train.strategies.mcmc import MCMCConfig


@dataclass(frozen=True)
class TrainConfig:
    """Training configuration (the JAX package's fields)."""

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
    # optional training components
    pose_mode: str = "none"  # none | direct | mlp (trainer.cpp:384-386)
    pose_lr: float = 1e-5
    pose_mlp_depth: int = 2
    use_bilateral_grid: bool = False
    bilateral_dims: tuple[int, int, int] = (16, 16, 8)  # (X, Y, W) grid dims
    bilateral_lr: float = 2e-3
    tv_loss_weight: float = 10.0
    bg_modulation: bool = False  # sinusoidal background mixing (trainer.cpp:497-577)
    enable_sparsity: bool = False  # ADMM opacity sparsification phase
    sparsify_steps: int = 15_000
    sparsity_rho: float = 5e-4
    sparsity_prune_ratio: float = 0.6

    def __post_init__(self):
        if self.pose_mode not in ("none", "direct", "mlp"):
            raise ValueError(f"unknown pose optimization mode {self.pose_mode}")
        if self.strategy not in ("mcmc", "default"):
            raise ValueError(f"unknown strategy {self.strategy}")
        if self.raster_mode not in ("cuda", "oracle"):
            raise ValueError(f"raster_mode must be 'cuda' or 'oracle', got {self.raster_mode!r}")

    @property
    def base_iterations(self) -> int:
        """Iterations before the sparsification phase (trainer.cpp:622-646)."""
        return self.iterations - self.sparsify_steps if self.enable_sparsity else self.iterations


@dataclass(frozen=True)
class StepFlags:
    """Per-step schedule flags, known on the host in advance (the JAX
    package's static step variants)."""

    refine: bool = False
    sh_step: bool = False
    reset: bool = False  # ADC opacity reset
    sparsity_phase: bool = False  # past base_iterations: no refine, no reset
    admm_init: bool = False  # the first step of the sparsity phase
    admm_update: bool = False  # every 50th step inside it
    shn_frozen: bool = False  # shN frozen for iter <= 1000 (fused_adam.cpp:69-71)


def step_flags(cfg: TrainConfig, iteration: int) -> StepFlags:
    """Flags for a (1-based) iteration: is_refining (mcmc.cpp:500-505,
    default_strategy.cpp:31-35), the SH cadence, the ADC opacity reset, the
    sparsity phase and its ADMM steps, and the shN freeze."""
    m = cfg.mcmc
    in_sparsity = cfg.enable_sparsity and iteration > cfg.base_iterations
    refine = (not in_sparsity and m.start_refine < iteration < m.stop_refine
              and iteration % m.refine_every == 0)
    reset = False
    if cfg.strategy != "mcmc":
        refine = refine and iteration % cfg.reset_every >= cfg.pause_refine_after_reset
        # the opacity resets ONLY inside the refinement window: the
        # reference's post_backward returns before the reset once
        # iter >= stop_refine (default_strategy.cpp:304-318); a reset on or
        # after stop_refine would never recover, no refinement follows it
        reset = (not in_sparsity and iteration % cfg.reset_every == 0
                 and 0 < iteration < m.stop_refine)
    return StepFlags(
        refine=refine,
        sh_step=iteration % m.sh_degree_interval == 0,
        reset=reset,
        sparsity_phase=in_sparsity,
        admm_init=cfg.enable_sparsity and iteration == cfg.base_iterations + 1,
        admm_update=in_sparsity and iteration % sparsity.UPDATE_EVERY == 0,
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
    # the components' trainables, flat: "pose.<name>" and "bilateral"
    # ([N, 12, L, H, W]); empty without pose optimisation and grid
    aux_params: dict[str, torch.Tensor]
    aux_adam: AdamState
    # ADMM sparsity duals [C] (zeros outside the sparsity phase)
    admm_u: torch.Tensor
    admm_z: torch.Tensor


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


def _aux_params(cfg: TrainConfig | None, num_cameras: int, seed: int,
                    device) -> tuple[dict[str, torch.Tensor], dict[str, float]]:
    """The components' parameters (flat keys) and their LRs: the pose
    parameters (the mlp's hidden layers drawn from a CPU generator seeded
    seed + 7, as the JAX package's key) and identity grids, one per
    camera."""
    params, lrs = {}, {}
    if cfg is not None and cfg.pose_mode != "none":
        pose = init_pose_params(cfg.pose_mode, num_cameras, depth=cfg.pose_mlp_depth,
                                generator=torch.Generator().manual_seed(seed + 7), device=device)
        for k, v in pose.items():
            params[f"pose.{k}"], lrs[f"pose.{k}"] = v, cfg.pose_lr
    if cfg is not None and cfg.use_bilateral_grid:
        x, y, w = cfg.bilateral_dims
        params["bilateral"] = identity_grids(num_cameras, grid_w=x, grid_h=y, grid_l=w,
                                             device=device)
        lrs["bilateral"] = cfg.bilateral_lr
    return params, lrs


def init_train_state(splats: SplatData, lrs: dict[str, float], seed: int = 0,
                     cfg: TrainConfig | None = None, num_cameras: int = 0) -> TrainState:
    """A fresh state; `cfg` and `num_cameras` size the components'
    parameters (none without `cfg`)."""
    dev = splats.means.device
    aux_params, aux_lrs = _aux_params(cfg, num_cameras, seed, dev)
    zeros = torch.zeros(splats.capacity, dtype=torch.float32, device=dev)
    return TrainState(
        splats=splats,
        adam=init_adam({k: p.detach() for k, p in splats.trainable_dict().items()}, lrs),
        generator=torch.Generator(device=dev).manual_seed(seed),
        iteration=0,
        binoms=make_binoms(device=dev),
        densify_count=zeros,
        densify_grad=zeros.clone(),
        aux_params=aux_params,
        aux_adam=init_adam(aux_params, aux_lrs),
        admm_u=zeros.clone(),
        admm_z=zeros.clone(),
    )


def posed_camera(camera: CameraParams, cfg: TrainConfig,
                 pose: dict[str, torch.Tensor]) -> CameraParams:
    """`camera` with the pose correction of its uid right-multiplied onto
    w2c (and onto w2c_end where it is set) and cam_position recomputed from
    the adjusted w2c. Unlike the JAX package (state.py:260-263), the camera
    model, distortion and shutter stay."""
    delta = pose_delta(cfg.pose_mode, pose, camera.uid, cfg.pose_mlp_depth)
    w2c = camera.w2c @ delta
    return dataclasses.replace(
        camera, w2c=w2c, cam_position=-(w2c[:3, :3].T @ w2c[:3, 3]),
        w2c_end=camera.w2c_end @ delta if camera.w2c_end is not None else None)


def compute_grads(
    state: TrainState,
    camera: CameraParams,
    gt_image: torch.Tensor,  # [H, W, 3]
    bg_color: torch.Tensor,  # [3]
    cfg: TrainConfig,
    flags: StepFlags = StepFlags(),
    draws: dict[str, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, RenderOutput, dict[str, torch.Tensor]]:
    """Render + loss + backward for one camera: (loss, render output,
    per-group gradients). Nothing is written to .grad. With the ADC
    strategy the gradients carry "_mean2d", d loss / d mean2d [C, 2], from
    the same backward pass (the JAX package's zero dummy,
    rasterize.py:200-203); it is zero where the blend does not read the
    projected means (the exact world-space blend). The components'
    gradients, where there are any, are under "_aux", keyed as
    `state.aux_params`. With background modulation the step's jitter is
    draws["bg"] ([3] U[0, 1)) where given, else drawn from the state's
    generator."""
    s = state.splats
    if cfg.bg_modulation:
        with stage("bg"):
            jitter = draws["bg"] if draws and "bg" in draws else torch.rand(
                3, generator=state.generator, device=bg_color.device)
            bg_color = background_for_step(bg_color, state.iteration + 1, cfg.iterations, jitter)
    aux = {k: v.detach().requires_grad_(True) for k, v in state.aux_params.items()}
    if cfg.pose_mode != "none":
        with stage("pose"):
            camera = posed_camera(camera, cfg, {k[5:]: v for k, v in aux.items()
                                                if k.startswith("pose.")})
    out = rasterize(s, camera, bg_color, mode=cfg.raster_mode, tile_size=cfg.tile_size,
                    instance_cap=cfg.instance_cap, projection=cfg.projection,
                    gut_exact=cfg.gut_exact, antialiasing=cfg.antialiasing,
                    cam_grad=cfg.pose_mode != "none")
    image = out.image
    if cfg.use_bilateral_grid:
        with stage("bilateral"):
            image = apply_bilateral_grid(aux["bilateral"], image, camera.uid)
    with stage("loss"):
        loss = photometric_loss(image, gt_image, cfg.lambda_dssim)
        loss = loss + scale_reg_loss(s, cfg.scale_reg) + opacity_reg_loss(s, cfg.opacity_reg)
        if cfg.use_bilateral_grid:
            loss = loss + cfg.tv_loss_weight * tv_loss(aux["bilateral"])
    if cfg.enable_sparsity and flags.sparsity_phase:
        with stage("sparsity"):
            loss = loss + sparsity.sparsity_loss(
                s.opacity, s.active_mask(), sparsity.ADMMState(u=state.admm_u, z=state.admm_z),
                cfg.sparsity_rho)
    params = s.trainable_dict()
    need_m2d = cfg.strategy == "default"
    inputs = list(params.values()) + list(aux.values()) + ([out.mean2d] if need_m2d else [])
    grads = torch.autograd.grad(loss, inputs, allow_unused=need_m2d)
    named = dict(zip(params, grads))
    if aux:
        named["_aux"] = dict(zip(aux, grads[len(params):len(params) + len(aux)]))
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
    """The strategy's post_backward (skipped in the sparsity phase), the
    ADMM dual steps, then Adam on the (possibly relocated) parameters with
    this step's gradients, ExponentialLR on the means group (the
    reference's order, trainer.cpp:745-758), and the components' Adam with
    the grid's warmup-exponential LR. `state` is updated in place and
    returned. `draws` replaces the generator's draws (see
    mcmc.post_backward and adc.post_backward)."""
    grads = dict(grads)
    dmean2d = grads.pop("_mean2d", None)
    aux_grads = grads.pop("_aux", {})
    iteration = state.iteration + 1
    splats, adam = state.splats, state.adam
    if cfg.strategy == "mcmc":
        if not flags.sparsity_phase:
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
            if not flags.sparsity_phase:
                splats, adam, state.densify_count, state.densify_grad = adc_strategy.post_backward(
                    state.generator, iteration, state.splats, state.adam,
                    state.densify_count, state.densify_grad, cfg,
                    refine=flags.refine, sh_step=flags.sh_step, reset=flags.reset, draws=draws,
                )
    if flags.admm_init or flags.admm_update:
        # the ADMM dual steps (sparsity_optimizer.cpp:85-91; trainer.cpp:744-754)
        with stage("sparsity"):
            active = splats.active_mask()
            if flags.admm_init:
                admm = sparsity.init_admm(splats.opacity, active, splats.n_active,
                                          cfg.sparsity_prune_ratio)
            else:
                admm = sparsity.update_admm(
                    splats.opacity, active, splats.n_active,
                    sparsity.ADMMState(u=state.admm_u, z=state.admm_z), cfg.sparsity_prune_ratio)
            state.admm_u, state.admm_z = admm.u, admm.z
    with stage("Adam"):
        params, adam = adam_step(
            {k: p.detach() for k, p in splats.trainable_dict().items()}, grads, adam,
            static_skip=("shN",) if flags.shn_frozen else (),
        )
        splats.replace_trainable(params)
        state.adam = scale_lrs(adam, cfg.lr_gamma, ("means",))  # ExponentialLR, group 0
        if state.aux_params:
            if cfg.use_bilateral_grid:
                lr = warmup_exponential_lr(cfg.bilateral_lr, iteration, cfg.iterations)
                # a fill kernel: no host-to-device copy in the step
                state.aux_adam = dataclasses.replace(state.aux_adam, lr={
                    **state.aux_adam.lr, "bilateral": torch.full(
                        (), lr, dtype=torch.float32, device=state.aux_params["bilateral"].device)})
            state.aux_params, state.aux_adam = adam_step(state.aux_params, aux_grads,
                                                         state.aux_adam)
    state.iteration = iteration
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
    loss, out, grads = compute_grads(state, camera, gt_image, bg_color, cfg, flags)
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
