"""Camera-batch data parallelism over ranks (counterpart of
lichtfeld_studio_tpu/parallel/data_parallel.py).

The model (N x 59 floats) fits on every card, so every rank holds the whole
state and a step of B ranks renders B cameras, one each. Each rank runs the
single-rank step's pieces (train/state.py): `compute_grads` on its camera,
then ONE `all_reduce(SUM)` of a flat float32 bucket that carries its
gradients and its ADC statistics, then `apply_update` on the averaged
gradients and the summed statistics. A B-camera step is the one-camera
step on the mean of the B gradients (B-step gradient accumulation with the
learning rates divided by B), and it adds to the ADC statistics exactly
what B one-camera steps would add. The loss and the instance count travel
in one small collective of their own (the mean loss, the largest count).

The ranks stay bit-identical: they start from rank 0's state
(`broadcast_state`), reduce to the same bucket, and draw from replicated
generators, so the strategy's relocations, additions, noise and prunes and
the capacity and instance-cap growth are the same everywhere.

The JAX package drives N devices from one process through `shard_map`.
Here every rank is a process (`spawn_ranks`): rank r runs on
cuda:(r % device_count) or on the CPU. The backend follows the placement:
NCCL where every rank has a card of its own; gloo where ranks share a card
(gloo reduces CUDA tensors through the host) or run on the CPU. Ranks that
share one card are a correctness path (the analogue of the JAX tests'
virtual devices), not a fast one.
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
import os
import pickle
import shutil
import tempfile
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp
from torch.multiprocessing.spawn import ProcessException, ProcessRaisedException

from lichtfeld_studio_tpu_torch.core.camera import CameraParams
from lichtfeld_studio_tpu_torch.train.state import (
    StepFlags,
    TrainConfig,
    TrainState,
    adc_stats,
    apply_update,
    compute_grads,
)


@dataclass(frozen=True)
class RankContext:
    """One rank's place in the run: its index, the world size, its device,
    the process group of its collectives and a gloo group for the small
    host-side broadcasts (the live control), which is `group` itself under
    gloo."""

    rank: int
    world: int
    device: torch.device
    group: object
    cpu_group: object
    backend: str


# ---------------------------------------------------------------------------
# placement and spawning


def rank_devices(world: int, device: str | torch.device = "cuda") -> list[torch.device]:
    """Rank r's device: cuda:(r % device_count), or the CPU for every rank
    when `device` is the CPU."""
    if torch.device(device).type != "cuda":
        return [torch.device("cpu")] * world
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no NVIDIA GPU found: ranks on the GPU need one")
    return [torch.device("cuda", r % n) for r in range(world)]


def choose_backend(devices: list[torch.device]) -> str:
    """NCCL when every rank has a card of its own, else gloo (ranks that
    share a card, or ranks on the CPU). Decided by the placement alone: a
    failed NCCL initialisation is an error, never a switch to gloo."""
    own_cards = all(d.type == "cuda" for d in devices) and len(set(devices)) == len(devices)
    return "nccl" if own_cards else "gloo"


def init_rank(rank: int, world: int, device: torch.device, backend: str, store_path: str,
              timeout: datetime.timedelta | None = None) -> RankContext:
    """Join the process group through a FileStore at `store_path` (no TCP
    port to collide with another run) and return this rank's context."""
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, **kw)
    group = dist.group.WORLD
    cpu_group = group if backend == "gloo" else dist.new_group(backend="gloo", **kw)
    return RankContext(rank, world, device, group, cpu_group, backend)


def _rank_main(index, first, world, fn, args, devices, backend, root, timeout, threads):
    """The body of spawned rank first + index: join, run fn(ctx, *args),
    write its return value for the parent, leave the group."""
    rank = first + index
    if threads is not None:
        torch.set_num_threads(threads)
    ctx = init_rank(rank, world, devices[rank], backend, os.path.join(root, "store"), timeout)
    try:
        result = fn(ctx, *args)
        with open(os.path.join(root, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def start_ranks(fn, world: int, root: str, devices: list[torch.device], *, args: tuple = (),
                timeout: datetime.timedelta | None = None, first: int = 0):
    """Start ranks first..world-1 of fn(ctx: RankContext, *args), each a
    process of its own (the `spawn` start method: CUDA cannot fork), and
    return at once with their torch.multiprocessing ProcessContext. The
    ranks meet through a FileStore in the directory `root` (ranks below
    `first` join it from elsewhere, such as rank 0 of the studio in its own
    process) and each writes its return value there for join_ranks. The
    backend follows the placement (choose_backend). Ranks on the CPU share
    its cores: each takes an equal share of this process's threads."""
    backend = choose_backend(devices)
    where = ", ".join(f"rank {r} -> {d}" for r, d in enumerate(devices))
    print(f"[dp] {world} ranks, backend {backend}: {where}", flush=True)
    threads = max(1, torch.get_num_threads() // world) if devices[0].type == "cpu" else None
    return tmp.start_processes(
        _rank_main, args=(first, world, fn, args, devices, backend, root, timeout, threads),
        nprocs=world - first, join=False, start_method="spawn")


def join_ranks(procs, root: str, *, first: int = 0, deadline: float | None = None) -> list:
    """Wait for the ranks of start_ranks and return their values in rank
    order. Past `deadline` seconds (none when None) the ranks still alive
    are killed and TimeoutError is raised. If a rank raises, the others are
    stopped and ProcessRaisedException carries the traceback of every rank
    that raised (the first to fail is often a peer that lost its connection
    to it), or else the exit code of every rank that died (a negative code
    is the signal that killed it)."""
    t0 = time.monotonic()
    try:
        while not procs.join(timeout=0.25):
            if deadline is not None and time.monotonic() - t0 > deadline:
                stop_ranks(procs)
                raise TimeoutError(f"ranks {first}..{first + len(procs.processes) - 1} did not "
                                   f"finish within {deadline} s")
    except ProcessException as e:
        errors = []
        for i, path in enumerate(procs.error_files):
            if os.path.exists(path):
                with open(path, "rb") as f:
                    errors.append(f"-- rank {first + i} raised:\n{pickle.load(f)}")
        if not errors:  # killed, or exited without a Python exception
            errors = [f"-- rank {first + i} exited with code {p.exitcode}"
                      for i, p in enumerate(procs.processes) if p.exitcode not in (0, None)]
        if not errors:
            raise
        raise ProcessRaisedException("\n".join(errors), e.error_index, e.error_pid) from e
    results = []
    for r in range(first, first + len(procs.processes)):
        with open(os.path.join(root, f"result_{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def stop_ranks(procs, root: str | None = None) -> None:
    """Kill the ranks of start_ranks that are still alive, wait for them,
    and remove their error files and the directory `root`."""
    for p in procs.processes:
        if p.is_alive():
            p.kill()
    for p in procs.processes:
        p.join(10.0)
    for path in procs.error_files:
        if os.path.exists(path):
            os.remove(path)
    if root is not None:
        shutil.rmtree(root, ignore_errors=True)


def spawn_ranks(fn, world: int, *, args: tuple = (), device: str | torch.device = "cuda",
                store_dir: str | None = None, timeout: datetime.timedelta | None = None,
                deadline: float | None = None) -> list:
    """Run fn(ctx: RankContext, *args) on `world` ranks, each a process of
    its own (start_ranks), and return the ranks' return values in rank
    order. `fn` must be importable by module name. The ranks meet through a
    FileStore in a fresh directory under `store_dir` (the system's
    temporary directory by default), removed at the end. `timeout` bounds
    every collective (torch's default when None); `deadline` bounds the
    whole run in seconds (none when None): past it the ranks are killed
    and TimeoutError is raised. A rank that raises fails the run with
    ProcessRaisedException (join_ranks)."""
    root = tempfile.mkdtemp(prefix="lfs-dp-", dir=store_dir)
    procs = None
    try:
        procs = start_ranks(fn, world, root, rank_devices(world, device), args=args,
                            timeout=timeout)
        return join_ranks(procs, root, deadline=deadline)
    finally:
        if procs is None:
            shutil.rmtree(root, ignore_errors=True)
        else:
            stop_ranks(procs, root)


# ---------------------------------------------------------------------------
# the camera batch


def make_camera_batch(cams, images, device) -> tuple[dict, torch.Tensor]:
    """Host cameras and images -> stacked tensors on `device`: w2c [B,4,4],
    cam_position [B,3], K [B,4] (fx, fy, cx, cy), uid [B] and gt [B,H,W,3],
    the values of the JAX package's make_camera_batch."""

    def f32(x):
        return torch.from_numpy(np.ascontiguousarray(np.stack(x), np.float32)).to(device)

    batch = {
        "w2c": f32([c.w2c for c in cams]),
        "cam_position": f32([c.cam_position for c in cams]),
        "K": f32([[c.fx, c.fy, c.cx, c.cy] for c in cams]),
        "uid": torch.tensor([c.uid for c in cams], dtype=torch.int32, device=device),
    }
    return batch, f32([np.asarray(i) for i in images])


def batch_camera(batch: dict, r: int, width: int, height: int) -> CameraParams:
    """Row r of a camera batch as a pinhole CameraParams (the JAX DP step's
    per-chip camera)."""
    return CameraParams(w2c=batch["w2c"][r], cam_position=batch["cam_position"][r],
                        K=batch["K"][r], uid=int(batch["uid"][r]), width=width, height=height)


# ---------------------------------------------------------------------------
# the collectives


def _grad_parts(grads: dict) -> list[tuple[str, torch.Tensor]]:
    """The gradient groups in the bucket's fixed order: the six splat
    groups (compute_grads' order), then the components' (sorted by key)."""
    parts = [(k, g) for k, g in grads.items() if not k.startswith("_")]
    aux = grads.get("_aux", {})
    return parts + [(f"_aux.{k}", aux[k]) for k in sorted(aux)]


def reduce_grads(grads: dict, group, stats: tuple | None = None) -> tuple[dict, tuple | None]:
    """One rank's gradients (and ADC statistics) -> the ranks' mean
    gradients (and summed statistics), through ONE all_reduce(SUM) of a flat
    float32 bucket: the splat groups, the components' gradients, then the
    statistics. The gradient part is divided by the world size, the
    statistics part is not. The returned tensors are views of the bucket."""
    world = dist.get_world_size(group)
    parts = _grad_parts(grads)
    tensors = [g for _, g in parts] + list(stats or ())
    bucket = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(bucket, op=dist.ReduceOp.SUM, group=group)
    bucket[:sum(g.numel() for _, g in parts)].div_(world)
    views = [v.view(t.shape) for v, t in zip(bucket.split([t.numel() for t in tensors]), tensors)]
    out = {}
    for (k, _), v in zip(parts, views):
        if k.startswith("_aux."):
            out.setdefault("_aux", {})[k[5:]] = v
        else:
            out[k] = v
    return out, (tuple(views[len(parts):]) if stats is not None else None)


def reduce_metrics(loss: torch.Tensor, n_instances: torch.Tensor, group):
    """(mean loss over the ranks, largest instance count): the JAX step's
    pmean and pmax in one small collective, an all-gather of [loss,
    n_instances] written as an all_reduce(SUM) of a zero table in which
    each rank fills its own row (adding zeros is exact; every backend
    reduces CUDA tensors)."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    table = torch.zeros((world, 2), dtype=torch.float64, device=loss.device)
    table[rank, 0] = loss
    table[rank, 1] = n_instances
    dist.all_reduce(table, op=dist.ReduceOp.SUM, group=group)
    return (table[:, 0].sum() / world).to(torch.float32), table[:, 1].max().to(torch.int32)


def dp_train_step(state: TrainState, camera: CameraParams, gt: torch.Tensor, bg: torch.Tensor,
                  cfg: TrainConfig, flags: StepFlags, group, draws: dict | None = None):
    """One data-parallel train step over `group` (the JAX package's
    make_dp_train_step): compute_grads on this rank's `camera` and `gt`
    [H,W,3] -> reduce_grads -> apply_update, returning (state, metrics)
    as train_step does. `draws` goes to both (the background jitter, the
    MCMC draws), as in the single-rank parity tests. The metrics are the
    ranks' mean loss and largest instance count."""
    loss, out, grads = compute_grads(state, camera, gt, bg, cfg, flags, draws)
    dmean2d = grads.pop("_mean2d", None)
    stats = adc_stats(dmean2d, out) if dmean2d is not None else None
    grads, stats = reduce_grads(grads, group, stats)
    loss, n_instances = reduce_metrics(loss, out.n_instances, group)
    state, metrics = apply_update(state, grads, cfg, loss, out, flags, draws, stats=stats)
    metrics["n_instances"] = n_instances
    return state, metrics


# ---------------------------------------------------------------------------
# replication


def _adam_tensors(prefix: str, adam) -> list[tuple[str, torch.Tensor]]:
    return [(f"{prefix}.{f.name}.{k}", v) for f in dataclasses.fields(adam)
            for k, v in sorted(getattr(adam, f.name).items())]


def state_tensors(state: TrainState) -> list[tuple[str, torch.Tensor]]:
    """Every tensor of the training state, named, in a fixed order: the
    parameters, the live count and SH degree, Adam's moments, step counts
    and learning rates, the binomial table, the ADC statistics, the
    components' parameters and their Adam state, the ADMM duals."""
    s = state.splats
    out = [(k, p.data) for k, p in s.trainable_dict().items()]
    out += [("n_active", s.n_active), ("active_sh_degree", s.active_sh_degree)]
    out += _adam_tensors("adam", state.adam)
    out += [("binoms", state.binoms), ("densify_count", state.densify_count),
            ("densify_grad", state.densify_grad)]
    out += [(f"aux.{k}", v) for k, v in sorted(state.aux_params.items())]
    out += _adam_tensors("aux_adam", state.aux_adam)
    return out + [("admm_u", state.admm_u), ("admm_z", state.admm_z)]


@torch.no_grad()
def broadcast_state(state: TrainState, ctx: RankContext, src: int = 0) -> TrainState:
    """Make every rank's state `src`'s, in place: every tensor of
    state_tensors, the generator's state, the iteration and the model's
    scene scale and SH degree bound. The ranks' states must have the same
    shapes (the same capacity and components)."""
    for _, t in state_tensors(state):
        dist.broadcast(t, src, group=ctx.group)
    gen = state.generator.get_state().to(ctx.device)
    dist.broadcast(gen, src, group=ctx.group)
    state.generator.set_state(gen.cpu())
    s = state.splats
    meta = torch.tensor([state.iteration, s.scene_scale, s.max_sh_degree], dtype=torch.float64,
                        device=ctx.device)
    dist.broadcast(meta, src, group=ctx.group)
    it, s.scene_scale, max_sh = meta.tolist()
    state.iteration, s.max_sh_degree = int(it), int(max_sh)
    s.mark_changed()
    return state


def state_digest(state: TrainState) -> str:
    """sha256 of every tensor of the state (state_tensors), the generator's
    state and the iteration: equal digests are equal bits."""
    h = hashlib.sha256()
    for name, t in state_tensors(state):
        h.update(name.encode())
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    h.update(state.generator.get_state().numpy().tobytes())
    h.update(str(state.iteration).encode())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# the multi-rank dry run


def _dryrun_rank(ctx: RankContext) -> dict:
    from lichtfeld_studio_tpu_torch.core.camera import look_at_camera
    from lichtfeld_studio_tpu_torch.core.splat_data import SplatData
    from lichtfeld_studio_tpu_torch.train.state import init_train_state, make_lrs, step_flags
    from lichtfeld_studio_tpu_torch.train.strategies.mcmc import MCMCConfig

    n, w = ctx.world, 32
    rng = np.random.default_rng(0)
    pos = rng.uniform(-2, 2, (48, 3)).astype(np.float32)
    col = rng.uniform(0, 1, (48, 3)).astype(np.float32)
    splats = SplatData.from_point_cloud(pos, col, np.zeros(3, np.float32), capacity=64,
                                        max_sh_degree=3, device=ctx.device)
    splats.active_sh_degree.fill_(3)
    logit = torch.from_numpy(rng.uniform(-1.0, 2.0, (48, 1)).astype(np.float32))
    op = splats.opacity.detach().clone()
    op[:48] = logit.to(ctx.device)
    splats.replace_trainable({"opacity": op})
    state = init_train_state(
        splats, make_lrs(1.6e-4, 2.5e-3, 5e-3, 1e-3, 0.05, splats.scene_scale), seed=0)
    broadcast_state(state, ctx)
    cfg = TrainConfig(iterations=10, raster_mode="cuda", instance_cap=2048, lr_gamma=1.0,
                      mcmc=MCMCConfig(max_cap=64, start_refine=0, stop_refine=10, refine_every=1))
    cams = []
    rng = np.random.default_rng(1)
    for i in range(n):
        theta = 2 * np.pi * i / n
        eye = 5.0 * np.array([np.sin(theta), 0.1, -np.cos(theta)])
        cams.append(look_at_camera(eye, np.zeros(3), np.array([0.0, -1.0, 0.0]), fx=40.0,
                                   fy=40.0, width=w, height=w, uid=i))
    images = [rng.uniform(0, 1, (w, w, 3)).astype(np.float32) for _ in cams]
    batch, gt = make_camera_batch(cams, images, ctx.device)
    state, metrics = dp_train_step(state, batch_camera(batch, ctx.rank, w, w), gt[ctx.rank],
                                   torch.zeros(3, device=ctx.device), cfg, step_flags(cfg, 1),
                                   ctx.group)
    return {"loss": float(metrics["loss"]), "iteration": state.iteration,
            "n_active": int(state.splats.n_active), "digest": state_digest(state)}


def dryrun_multichip(n_devices: int, device: str | torch.device | None = None) -> float:
    """One data-parallel MCMC step (a refining one) of the JAX package's
    dry-run scene (48 gaussians in a capacity of 64, 32x32 cameras on a
    ring) over `n_devices` ranks, placed by the placement rule on the GPU
    (the default) or on the CPU when `device` is the CPU. Raises unless
    the loss is finite, the iteration is 1 and every rank holds the same
    state; returns the loss."""
    if device is None:
        from lichtfeld_studio_tpu_torch.render.headless import default_device

        device = default_device()
    res = spawn_ranks(_dryrun_rank, n_devices, device=device,
                      timeout=datetime.timedelta(seconds=120), deadline=600.0)
    loss = res[0]["loss"]
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite DP loss: {loss}")
    if any(r["iteration"] != 1 for r in res) or len({r["digest"] for r in res}) != 1:
        raise RuntimeError(f"the ranks disagree after one step: {res}")
    print(f"dryrun_multichip({n_devices}): OK, loss={loss:.5f}, "
          f"{res[0]['n_active']} gaussians after the refine", flush=True)
    return loss
