"""Host-side training orchestration (counterpart of
lichtfeld_studio_tpu/train/trainer.py; reference
src/training/trainer.{cpp,hpp} and training_setup.cpp).

All device work lives in train_step (train/state.py). This class feeds the
prefetched cameras (the host image goes to the device through a pinned
buffer, non_blocking, on the current stream), reads each dispatch's
metrics in ONE device-to-host copy (with the loss of the dispatch before
it), grows the instance buffer and the gaussian capacity, triggers eval,
saves and timelapse at their scheduled steps, polls the live-control
object between dispatches, and writes the PLY exports, the training-state
snapshots and the .lfs project.

A dispatch is `dispatch_steps` steps between host-visible boundaries (a
loop here): eval, saves, timelapse and the end land on exact iterations,
and scheduled steps (refine, reset, SH, the sparsity phase and its ADMM
steps) run as dispatches of one. With --sparsity the lowest-opacity
fraction is pruned before the last PLY. Every PLY save also writes
viewer_live.html (render/web_viewer.py, the first 64 training cameras) and,
with --sog, splat_<it>.sog.

With --devices N the trainer is one of N ranks (`ranks`, a
parallel.RankContext; the CLI spawns them): every rank takes its share of
the camera stream and runs the data-parallel step (parallel/
data_parallel.py), one camera a rank and one iteration a step, in
dispatches of one. The ranks start from rank 0's state (after setup and
after a resume, which rank 0 reads) and stay bit-identical; the growth of
the instance cap and of the capacity reads the reduced metrics, so it
happens at the same iteration everywhere. Rank 0 alone writes (progress,
eval, metrics.csv, PLY/SOG/viewer, snapshots, the project, the timelapse)
and serves the live control: when it has one, it broadcasts stop, pause
and save to the others once a dispatch, and while paused a few times a
second.
"""

from __future__ import annotations

import dataclasses
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from lichtfeld_studio_tpu_torch.config.parameters import TrainingParameters
from lichtfeld_studio_tpu_torch.core.events import (
    CheckpointSaved,
    EvaluationCompleted,
    TrainingCompleted,
    TrainingPaused,
    TrainingProgress,
    TrainingResumed,
    TrainingStopped,
    bus,
)
from lichtfeld_studio_tpu_torch.core.project import Project
from lichtfeld_studio_tpu_torch.core.splat_data import SplatData
from lichtfeld_studio_tpu_torch.io.dataset import CameraDataset, InfiniteRandomLoader, load_dataset
from lichtfeld_studio_tpu_torch.io.image import save_image
from lichtfeld_studio_tpu_torch.io.ply import read_ply, write_ply
from lichtfeld_studio_tpu_torch.io.sog import write_sog
from lichtfeld_studio_tpu_torch.ops.rasterize import rasterize
from lichtfeld_studio_tpu_torch.parallel.data_parallel import (
    RankContext,
    broadcast_state,
    dp_train_step,
)
from lichtfeld_studio_tpu_torch.profiling import stage
from lichtfeld_studio_tpu_torch.render.web_viewer import export_html
from lichtfeld_studio_tpu_torch.train.capacity import grow_capacity, initial_capacity
from lichtfeld_studio_tpu_torch.train.checkpoint import (
    load_checkpoint,
    peek_capacity,
    save_checkpoint,
)
from lichtfeld_studio_tpu_torch.train.components.sparsity import prune_mask
from lichtfeld_studio_tpu_torch.train.metrics import MetricsEvaluator
from lichtfeld_studio_tpu_torch.train.state import (
    StepFlags,
    TrainConfig,
    TrainState,
    init_train_state,
    make_lrs,
    step_flags,
    train_step,
)
from lichtfeld_studio_tpu_torch.train.strategies.adc import prune_gs
from lichtfeld_studio_tpu_torch.train.strategies.mcmc import MCMCConfig


@dataclass
class Trainer:
    params: TrainingParameters
    train_set: CameraDataset
    val_set: CameraDataset
    state: TrainState
    cfg: TrainConfig
    output_dir: Path
    device: torch.device
    evaluator: Optional[MetricsEvaluator] = None
    progress_callback: Optional[Callable[[int, float, int], None]] = None
    project: Optional[Project] = None  # the .lfs registry
    # live-control surface: an object with paused, stop_requested,
    # consume_save_request() and run_pending(trainer), polled between
    # dispatches (reference trainer.hpp:199-210)
    control: Optional[object] = None
    last_progress: tuple = (0, None, 0)
    training_active: bool = False  # True while train() runs
    _loader: Optional[InfiniteRandomLoader] = None
    _pinned: Optional[list] = None  # ring of (pinned buffer, copy-done event)
    # per-view camera tensors, uploaded once: a pageable host-to-device copy
    # makes the host wait for the stream, which would end the overlap of a
    # dispatch's steps
    _cam_params: dict = field(default_factory=dict)
    # with --devices N: this rank's place, and whether rank 0 has a live
    # control whose flags the other ranks follow (train() decides it)
    ranks: Optional[RankContext] = None
    _shared_control: bool = False

    @property
    def rank(self) -> int:
        return self.ranks.rank if self.ranks is not None else 0

    @staticmethod
    def setup(params: TrainingParameters, device: str | torch.device | None = None,
              ranks: RankContext | None = None) -> "Trainer":
        """Dataset -> SplatData init -> strategy and optimizer -> Trainer
        (reference training_setup.cpp:14-129). `device` defaults to the
        first GPU and is never replaced by the CPU: a caller that wants the
        CPU's plain versions (the tests) passes "cpu". With --devices N,
        `ranks` is this rank's context in a group of N (the CLI and the
        studio spawn the ranks): the state becomes rank 0's, and only rank 0
        creates the output directory, the evaluator and the project."""
        if device is None:
            from lichtfeld_studio_tpu_torch.render.headless import default_device

            device = default_device()
        device = torch.device(device)
        opt = params.optimization
        world = ranks.world if ranks is not None else 1
        if opt.devices != world:
            raise ValueError(
                f"--devices {opt.devices} trains on {opt.devices} ranks, this process group has "
                f"{world}: the CLI and the studio spawn the ranks (parallel.start_ranks)")
        writer = ranks is None or ranks.rank == 0

        ds = params.dataset
        cameras, pcd, scene_center = load_dataset(
            ds.data_path, ds.images, ds.resize_factor, ds.max_width
        )
        train_set = CameraDataset(cameras, "train", ds.test_every if opt.enable_eval else 0)
        val_set = CameraDataset(cameras, "val", ds.test_every)

        # gaussian-capacity bucketing: start with a snug power-of-two bucket
        # and grow toward max_cap as densification fills it (train/capacity.py)
        if opt.random_init:
            n_init = opt.init_num_pts
        elif params.init_ply:
            n_init = None  # resolved after reading the file
        else:
            n_init = min(pcd.size, opt.max_cap // 2)
        capacity = initial_capacity(n_init, opt.max_cap) if n_init else opt.max_cap
        if params.init_ply:  # warm start (training_setup.cpp:50-71)
            pc = read_ply(params.init_ply)
            capacity = initial_capacity(pc.size, opt.max_cap)
            splats = SplatData.from_arrays(
                pc.means, pc.sh0, pc.shN, pc.scaling, pc.rotation, pc.opacity,
                capacity=capacity, device=device,
            )
        elif opt.random_init:
            splats = SplatData.random_init(
                torch.Generator().manual_seed(0),
                num_points=opt.init_num_pts,
                extent=opt.init_extent,
                capacity=capacity,
                max_sh_degree=opt.sh_degree,
                init_opacity=opt.init_opacity,
                init_scaling=opt.init_scaling,
                device=device,
            )
        else:
            means = pcd.means
            colors = pcd.colors if pcd.colors is not None else np.full_like(means, 127.0)
            if means.shape[0] > capacity:
                # static capacity: subsample the SfM cloud (the reference has
                # no cap; growth headroom matters more than extra seeds)
                sel = np.random.default_rng(0).choice(
                    means.shape[0], capacity // 2, replace=False
                )
                means, colors = means[sel], colors[sel]
            splats = SplatData.from_point_cloud(
                means,
                colors / 255.0,
                scene_center,
                capacity=capacity,
                max_sh_degree=opt.sh_degree,
                init_opacity=opt.init_opacity,
                init_scaling=opt.init_scaling,
                device=device,
            )

        lrs = make_lrs(
            opt.means_lr, opt.shs_lr, opt.scaling_lr, opt.rotation_lr,
            opt.opacity_lr, splats.scene_scale,
        )

        cfg = TrainConfig(
            iterations=opt.iterations,
            lambda_dssim=opt.lambda_dssim,
            scale_reg=opt.scale_reg,
            opacity_reg=opt.opacity_reg,
            raster_mode="cuda",  # the kernel path; plain versions only for CPU tensors
            tile_size=opt.tile_size,
            # start with a small instance buffer; the train loop grows it
            # when the scene crowds it: every binning cost scales with it
            instance_cap=min(2**20, opt.instance_cap),
            # --gut forces the 3DGUT unscented projection even for pinhole
            # cameras (reference trainer.cpp:654-659 dispatch)
            projection="ut" if (opt.gut or opt.gut_exact) else "auto",
            antialiasing=opt.antialiasing,
            gut_exact=opt.gut_exact,
            strategy=opt.strategy,
            mcmc=MCMCConfig(
                max_cap=capacity,  # the current bucket; grown toward opt.max_cap
                min_opacity=opt.min_opacity,
                start_refine=opt.start_refine,
                stop_refine=opt.stop_refine,
                refine_every=opt.refine_every,
                sh_degree_interval=opt.sh_degree_interval,
            ),
            lr_gamma=0.01 ** (1.0 / opt.iterations),
            grad_threshold=opt.grad_threshold,
            prune_opacity=opt.prune_opacity,
            grow_scale3d=opt.grow_scale3d,
            grow_scale2d=opt.grow_scale2d,
            prune_scale3d=opt.prune_scale3d,
            prune_scale2d=opt.prune_scale2d,
            reset_every=opt.reset_every,
            pause_refine_after_reset=opt.pause_refine_after_reset,
            revised_opacity=opt.revised_opacity,
            pose_mode=opt.pose_optimization,
            use_bilateral_grid=opt.use_bilateral_grid,
            bilateral_dims=(opt.bilateral_grid_X, opt.bilateral_grid_Y, opt.bilateral_grid_W),
            bilateral_lr=opt.bilateral_grid_lr,
            tv_loss_weight=opt.tv_loss_weight,
            bg_modulation=opt.bg_modulation,
            enable_sparsity=opt.enable_sparsity,
            sparsify_steps=opt.sparsify_steps,
            sparsity_rho=opt.init_rho,
            sparsity_prune_ratio=opt.prune_ratio,
        )

        state = init_train_state(splats, lrs, cfg=cfg, num_cameras=len(cameras))
        if ranks is not None:
            broadcast_state(state, ranks)

        output_dir = Path(ds.output_path or "output")
        evaluator = project = None
        if writer:
            output_dir.mkdir(parents=True, exist_ok=True)
        if writer and opt.enable_eval:
            evaluator = MetricsEvaluator(
                val_set,
                output_dir,
                save_images=opt.enable_save_eval_images,
                raster_mode=cfg.raster_mode,
                instance_cap=opt.instance_cap,
                lpips_weights=opt.lpips_weights or None,
                render_mode=opt.render_mode,
                save_depth=opt.save_depth,
                projection=cfg.projection,
                antialiasing=cfg.antialiasing,
            )

        # .lfs project registry (reference application.cpp:25 creates one on
        # every run; outputs registered via addPly, trainer.cpp:1021-1028)
        if writer:
            proj_dir = Path(ds.project_path) if ds.project_path else output_dir / "project.lfs"
            project = Project.create(proj_dir, project_name=Path(ds.data_path).name or "scene")
            project.set_params(params.to_json())
            project.save()

        trainer = Trainer(
            params=params,
            train_set=train_set,
            val_set=val_set,
            state=state,
            cfg=cfg,
            output_dir=output_dir,
            device=device,
            evaluator=evaluator,
            project=project,
            ranks=ranks,
        )
        if params.resume:
            trainer.restore(params.resume)
        return trainer

    # ------------------------------------------------------------------
    def _set_capacity(self, new_capacity: int) -> None:
        self.state = grow_capacity(self.state, new_capacity)
        self.cfg = dataclasses.replace(
            self.cfg, mcmc=dataclasses.replace(self.cfg.mcmc, max_cap=new_capacity)
        )

    def restore(self, path: str) -> None:
        """Resume from a training-state snapshot (train/checkpoint.py; the
        reference has none, SURVEY §5.4). Adopts the snapshot's gaussian
        capacity before restoring. With several ranks rank 0 reads the
        snapshot and broadcasts its capacity, then the restored state."""
        cap = peek_capacity(path) if self.rank == 0 else None
        if self.ranks is not None:
            box = [cap]
            dist.broadcast_object_list(box, 0, group=self.ranks.cpu_group)
            cap = box[0]
        if cap is not None and cap != self.state.splats.capacity:
            if cap < self.state.splats.capacity:
                raise ValueError(
                    f"checkpoint capacity {cap} < current {self.state.splats.capacity}; "
                    "shrinking is not supported"
                )
            self._set_capacity(cap)
        if self.rank == 0:
            self.state = load_checkpoint(path, self.state)
        if self.ranks is not None:
            broadcast_state(self.state, self.ranks)
        self._say(
            f"[resume] restored iteration {int(self.state.iteration)} "
            f"({int(self.state.splats.n_active)} gaussians) from {path}"
        )

    def _say(self, msg: str) -> None:
        """Print on rank 0 (the only rank when there is one)."""
        if self.rank == 0:
            print(msg, flush=True)

    # ------------------------------------------------------------------
    def _to_device(self, img: np.ndarray) -> torch.Tensor:
        """The host image on the device. On a GPU: through a ring of two
        pinned buffers, non_blocking, on the current stream. A buffer is
        written again only after the copy that last read it has run: the
        host waits for that copy's event, recorded two images ago, so the
        wait is over before it starts unless the device is far behind."""
        src = torch.from_numpy(np.ascontiguousarray(img, np.float32))
        if self.device.type != "cuda":
            return src.to(self.device)
        if not self._pinned or self._pinned[0][0].shape != src.shape:
            self._pinned = [(torch.empty(src.shape, dtype=torch.float32, pin_memory=True),
                             torch.cuda.Event()) for _ in range(2)]
        buf, done = self._pinned[0]
        self._pinned.reverse()
        done.synchronize()  # returns at once for an event never recorded
        buf.copy_(src)
        out = buf.to(self.device, non_blocking=True)
        done.record()
        return out

    # ------------------------------------------------------------------
    def start_loader(self) -> None:
        """Start the prefetch threads (train() does; stop with stop_loader)."""
        opt = self.params.optimization
        self._loader = InfiniteRandomLoader(
            self.train_set,
            num_workers=opt.num_workers,
            seed=1,
            preload=opt.preload_to_ram,
            rank=self.rank,
            world=self.ranks.world if self.ranks is not None else 1,
        )

    def stop_loader(self) -> None:
        if self._loader is not None:
            self._loader.stop()

    def run_dispatch(self, k: int, flags: StepFlags, bg: torch.Tensor) -> dict:
        """One dispatch: `k` train steps, all with `flags`, on the loader's
        next k cameras (with several ranks: data-parallel steps, one camera
        of this rank's share each). Returns the last step's metrics, still
        on the device (the caller reads them). Host spans (profiling.stage):
        `dispatch`, a `step` an iteration, `loader_wait` and `h2d` in it."""
        with stage("dispatch", self.state.iteration + 1):
            for _ in range(k):
                with stage("step", self.state.iteration + 1):
                    with stage("loader_wait"):
                        cam, img = next(self._loader)
                    params = self._cam_params.get(cam.uid)
                    if params is None:
                        params = self._cam_params[cam.uid] = cam.device_params(self.device)
                    with stage("h2d"):
                        gt = self._to_device(img)
                    if self.ranks is None:
                        self.state, metrics = train_step(self.state, params, gt, bg, self.cfg,
                                                         flags)
                    else:
                        self.state, metrics = dp_train_step(self.state, params, gt, bg, self.cfg,
                                                            flags, self.ranks.group)
        return metrics

    def _control_flags(self) -> tuple[bool, bool, bool]:
        """(stop, paused, save) of the live control, after its queued jobs
        ran (a save request is consumed). With several ranks these are rank
        0's, broadcast to the others on the host (gloo) group when rank 0
        has a live control, and all False without one."""
        flags = [False, False, False]
        if self.control is not None and self.rank == 0:
            self.control.run_pending(self)
            flags = [self.control.stop_requested, self.control.paused,
                     self.control.consume_save_request()]
        if self._shared_control:
            dist.broadcast_object_list(flags, 0, group=self.ranks.cpu_group)
        return tuple(flags)

    # ------------------------------------------------------------------
    def train(self) -> dict:
        """Main loop (reference trainer.cpp:860-987)."""
        opt = self.params.optimization
        if self.ranks is not None:
            # once a run: does rank 0 have a live control? Without one the
            # other ranks know its flags, and no dispatch broadcasts them
            box = [self.control is not None]
            dist.broadcast_object_list(box, 0, group=self.ranks.cpu_group)
            self._shared_control = box[0]
        self.start_loader()
        bg = torch.zeros(3, device=self.device)
        eval_steps = set(opt.eval_steps) if opt.enable_eval else set()
        save_steps = set(opt.save_steps) if not opt.skip_intermediate_saving else set()

        # timelapse camera set (reference trainer.cpp:812-846)
        timelapse_cams = [
            c for c in self.train_set.cameras
            if c.image_name in set(self.params.dataset.timelapse_images)
        ]
        timelapse_every = self.params.dataset.timelapse_every

        pbar = None
        if self.rank == 0:
            try:
                from tqdm import tqdm

                pbar = tqdm(total=opt.iterations, desc="train", unit="it", smoothing=0.05)
            except ImportError:
                pass

        dispatch_k = max(1, opt.dispatch_steps)
        state_steps = (
            set(range(opt.save_state_every, opt.iterations + 1, opt.save_state_every))
            if opt.save_state_every > 0 else set()
        )
        boundaries = sorted(
            set(eval_steps) | set(save_steps) | state_steps
            | ({s for s in range(timelapse_every, opt.iterations + 1, timelapse_every)}
               if timelapse_cams else set())
            | {opt.iterations}
        )
        default_flags = StepFlags()

        pending_loss = None
        t_start = time.time()
        losses = []
        self.training_active = True
        try:
            it = int(self.state.iteration)  # > 0 after --resume
            it0 = it  # starting iteration (throughput accounting excludes it)
            if pbar is not None and it:
                pbar.update(it)
            while it < opt.iterations:
                next_boundary = next((b for b in boundaries if b > it), opt.iterations)
                # only full-length stretches of default-flag steps run as one
                # dispatch of dispatch_k; scheduled steps (refine, reset, SH)
                # run as a dispatch of their own
                flags_next = step_flags(self.cfg, it + 1)
                uniform = (
                    flags_next == default_flags
                    and next_boundary - it >= dispatch_k
                    and all(
                        step_flags(self.cfg, it + j) == default_flags
                        for j in range(2, dispatch_k + 1)
                    )
                )
                # a data-parallel step is a dispatch of one (the JAX loop's k = 1)
                k = dispatch_k if (uniform and dispatch_k > 1 and self.ranks is None) else 1
                metrics = self.run_dispatch(k, flags_next, bg)
                it += k

                # ONE device-to-host copy per dispatch: the health count,
                # the instance count, the live count and the loss of the
                # dispatch BEFORE this one (the deferred loss read: the
                # progress line runs one dispatch behind). The very first
                # dispatch has no earlier loss and reads its own rather
                # than report a meaningless nan.
                row = [metrics["n_nonfinite"], metrics["n_instances"], metrics["n_active"]]
                first = not losses and pending_loss is None
                if first or pending_loss is not None:
                    row.append(metrics["loss"] if first else pending_loss)
                with stage("readback"):
                    host = torch.stack([v.to(torch.float64) for v in row]).tolist()
                n_bad, n_inst, n_active = int(host[0]), int(host[1]), int(host[2])
                if len(host) > 3:
                    losses.append(host[3])
                pending_loss = None if first else metrics["loss"]

                if n_bad:
                    self._say(
                        f"[health] {n_bad} non-finite parameter entries at iter {it}: "
                        "numerical fault"
                    )

                # adaptive instance-buffer bucketing: grow the cap when the
                # scene's instance count crowds it (capped by the configured
                # instance_cap), in snug x1.25 steps (128-aligned): every
                # binning, gather and blend stage scales with the cap
                if (
                    n_inst > 0.85 * self.cfg.instance_cap
                    and self.cfg.instance_cap < opt.instance_cap
                ):
                    need = max(
                        int(self.cfg.instance_cap * 1.25), int(n_inst * 1.15)
                    )
                    new_cap = min(-(-need // 128) * 128, opt.instance_cap)
                    self._say(
                        f"[instance-cap] {n_inst} instances crowd "
                        f"{self.cfg.instance_cap}; growing to {new_cap}"
                    )
                    self.cfg = dataclasses.replace(self.cfg, instance_cap=new_cap)

                # gaussian-capacity bucketing (train/capacity.py): densification
                # approaches the current bucket -> pad the state, raise the cap
                cur_cap = self.state.splats.capacity
                if n_active > 0.85 * cur_cap and cur_cap < opt.max_cap:
                    new_gcap = min(cur_cap * 2, opt.max_cap)
                    self._say(
                        f"[capacity] {n_active} gaussians crowd {cur_cap}; growing to {new_gcap}"
                    )
                    self._set_capacity(new_gcap)

                if pbar is not None:
                    pbar.update(k)
                    pbar.set_postfix(loss=f"{losses[-1]:.4f}", gaussians=n_active)
                if self.progress_callback:
                    self.progress_callback(it, losses[-1], n_active)
                bus().emit(TrainingProgress(
                    iteration=it,
                    loss=losses[-1],
                    num_gaussians=n_active,
                    is_refining=flags_next.refine,
                ))
                if timelapse_cams and it % timelapse_every == 0 and self.rank == 0:
                    self._save_timelapse(timelapse_cams, it)
                if it in eval_steps and self.evaluator is not None:
                    m = self.evaluator.evaluate(self.state.splats, it)
                    print(
                        f"[eval] iter {it}: PSNR {m.psnr:.3f} SSIM {m.ssim:.4f} "
                        f"LPIPS {m.lpips:.4f} gaussians {m.num_gaussians}",
                        flush=True,
                    )
                    bus().emit(EvaluationCompleted(
                        iteration=it, psnr=m.psnr, ssim=m.ssim, lpips=m.lpips
                    ))
                if it in save_steps and it != opt.iterations:
                    self.save_ply(it)
                if it in state_steps:
                    self.save_state(it)

                # --- live control (pause, save, stop between dispatches;
                # reference trainer.cpp handle_control_requests) ---
                self.last_progress = (it, losses[-1], n_active)
                stop, paused, save = self._control_flags()
                if save:
                    self.save_ply(it)
                if paused and not stop:
                    bus().emit(TrainingPaused(iteration=it))
                    while paused and not stop:
                        time.sleep(0.05)
                        stop, paused, save = self._control_flags()
                        if save:
                            self.save_ply(it)
                    bus().emit(TrainingResumed(iteration=it))
                if stop:
                    bus().emit(TrainingStopped(iteration=it))
                    self._say(f"[control] stop requested at iter {it}")
                    break
            if pending_loss is not None:
                losses.append(float(pending_loss))
        finally:
            self.training_active = False
            if self.control is not None:
                self.control.run_pending(self)  # drain queued jobs
            self.stop_loader()
            if pbar is not None:
                pbar.close()

        if opt.enable_sparsity:
            self._final_sparsity_prune()
        # `it` is the ACTUAL final iteration: a stop may have ended the run
        # early, and --resume started it above zero; label the artifact and
        # compute the throughput from what actually ran
        self.save_ply(it)
        if self.evaluator is not None:
            self.evaluator.write_report()
        elapsed = time.time() - t_start
        bus().emit(TrainingCompleted(
            iterations=it, elapsed_s=elapsed,
            final_loss=losses[-1] if losses else float("nan"),
        ))
        return {
            "elapsed_s": elapsed,
            "iters_per_s": max(it - it0, 0) / max(elapsed, 1e-9),
            "final_loss": losses[-1] if losses else float("nan"),
            "num_gaussians": int(self.state.splats.n_active),
            "losses": losses,
        }

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _save_timelapse(self, cams, iteration: int) -> None:
        """Render named cameras every N iterations (reference
        trainer.cpp:812-846)."""
        for cam in cams:
            out = rasterize(
                self.state.splats, cam.device_params(self.device),
                torch.zeros(3, device=self.device),
                mode=self.cfg.raster_mode, instance_cap=self.cfg.instance_cap,
                projection=self.cfg.projection, antialiasing=self.cfg.antialiasing,
                inference=True,
            )
            d = self.output_dir / "timelapse" / Path(cam.image_name).stem
            d.mkdir(parents=True, exist_ok=True)
            save_image(str(d / f"{iteration:06d}.png"),
                       torch.clamp(out.image, 0, 1).cpu().numpy())

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _final_sparsity_prune(self) -> None:
        """Prune the lowest-opacity `prune_ratio` fraction after the ADMM
        phase (reference trainer.cpp final pruning + remove_gaussians):
        the pruned slots get a dead opacity and ADC's compaction removes
        them."""
        splats = self.state.splats
        mask = prune_mask(splats.opacity, splats.active_mask(), splats.n_active,
                          self.cfg.sparsity_prune_ratio)
        dead_op = torch.where(mask[:, None], -20.0, splats.opacity)
        splats.replace_trainable({"opacity": dead_op})
        splats, self.state.adam = prune_gs(0, splats, self.state.adam, self.cfg)
        self._say(f"[sparsity] pruned to {int(splats.n_active)} gaussians")

    # ------------------------------------------------------------------
    def save_ply(self, iteration: int) -> Path | None:
        """Export the model (reference trainer.cpp:1008-1028 +
        splat_data.cpp:113-170): the reference's on-disk layout; the output
        is registered in the .lfs project (trainer.cpp:1021-1028). Beside
        it: viewer_live.html, a standalone web viewer refreshed at every
        save (TrainerManager analogue, training_manager.cpp:121-165), and
        with --sog the SOG bundle, its k-means on the trainer's device.
        Rank 0 alone writes: other ranks return None."""
        if self.rank != 0:
            return None
        out = self.output_dir / f"splat_{iteration}.ply"
        pc = self.state.splats.to_point_cloud()
        write_ply(pc, out)
        try:
            export_html(pc, self.output_dir / "viewer_live.html",
                        cameras=self.train_set.cameras[:64])
        except Exception as e:  # the viewer export must never end a run
            print(f"[viewer] live export failed: {e!r}", flush=True)
            traceback.print_exc()
        opt = self.params.optimization
        if opt.save_sog:
            write_sog(pc, self.output_dir / f"splat_{iteration}.sog",
                      kmeans_iterations=opt.sog_iterations, device=self.device)
        if self.project is not None:
            self.project.add_ply(out.stem, out, iteration=iteration)
            self.project.save()
        bus().emit(CheckpointSaved(iteration=iteration, path=str(out)))
        return out

    # ------------------------------------------------------------------
    def save_state(self, iteration: int) -> Path | None:
        """Periodic full training-state snapshot for --resume
        (train/checkpoint.py; no reference equivalent, SURVEY §5.4). Rank 0
        alone writes: other ranks return None."""
        if self.rank != 0:
            return None
        out = self.output_dir / f"state_{iteration}"
        save_checkpoint(self.state, out)
        print(f"[state] snapshot at iter {iteration} -> {out}", flush=True)
        return out
