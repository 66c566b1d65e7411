"""Training traffic: the trainer as a user runs it, `Trainer.setup` and
`Trainer.train` (the CLI's `-d` path), on the configuration's dataset with
its warm-start PLY (`--init-ply`).

Set-up (counted in setup_s): the dataset from the seed, the CLI's
parameters, `Trainer.setup`; the state is placed at the configuration's
start iteration (what a `--resume` there gives, with fresh Adam moments)
and the noise generator is seeded from the run's seed; then the first
`check_steps` steps run through the trainer's own dispatch and loader
(`run_dispatch`), and what they leave is kept for the correctness check;
then the trainer's dispatches run on through one refine and
`warmup_dispatches_after_refine` more. The window is one `Trainer.train()`
call: it opens at the trainer's first control poll (after its first
dispatch), where the trainer's thread gets a core of its own and its
other threads the rest (harness.py::pin_host_threads), and the control
asks the trainer to stop at the first poll `seconds` later (or, in a
traced run, once its stretches are done); train() then writes its PLY,
outside the window.

Correctness (port_bench/reference/, after the window, the trainer
freed): the reference runs the same first steps from the same PLY, on the
same views (the ones the loader handed out) and JPEGs, with the same
noise generator, and the result compares each step's loss, the first
gradient (recovered from Adam's first moment after step one: m =
(1 - beta1) g), and the parameters' change over the steps. The warm-up's
first refine is judged from the program's state before it
(reference/mcmc.py): where each relocated slot's uniform falls against
the source the program copied into it, and the parameters and Adam
moments after the refine and the step's noise.
"""

from __future__ import annotations

import gc
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from port_bench.reference import mcmc, raster
from port_bench.harness import Check, Result, memory_peak, pin_host_threads, sync
from port_bench.scene import garden
from port_bench.work import counts

GROUPS = raster.GROUPS


def cli_argv(cfg: dict, data: Path, out: Path, extra=()) -> list[str]:
    t = cfg["train"]
    argv = ["-d", str(data), "-o", str(out), "--init-ply", str(data / "init.ply"),
            "--strategy", t["strategy"], "-i", str(t["iterations"]),
            "--max-cap", str(t["max_cap"]), "--sh-degree", str(t["sh_degree"]),
            "--sh-degree-interval", str(t["sh_degree_interval"]),
            "--refine-every", str(t["refine_every"]), "--start-refine", str(t["start_refine"]),
            "--stop-refine", str(t["stop_refine"]), "--min-opacity", str(t["min_opacity"]),
            "--opacity-reg", str(t["opacity_reg"]), "--scale-reg", str(t["scale_reg"]),
            "--test-every", str(t["test_every"]), "--dispatch-steps", str(t["dispatch_steps"]),
            "--headless"]
    if t["eval"]:
        argv.append("--eval")
    if t["gut_exact"]:
        argv.append("--gut-exact")
    return argv + list(extra)


def check_params(params, cfg: dict) -> None:
    """The program runs as the configuration states: the values the CLI has
    no flag for come from its preset, and must be the configuration's."""
    opt, t = params.optimization, cfg["train"]
    for key in ("means_lr", "shs_lr", "opacity_lr", "scaling_lr", "rotation_lr",
                "lambda_dssim", "tile_size", "max_cap", "iterations", "gut_exact"):
        if getattr(opt, key) != t[key]:
            raise RuntimeError(f"the program's {key} is {getattr(opt, key)!r}, the "
                               f"configuration states {t[key]!r}")


class Feed:
    """The trainer's loader, recording the views it hands out and the host
    seconds the trainer waited for them."""

    def __init__(self, loader):
        self.loader, self.uids, self.wait_s = loader, [], 0.0

    def __iter__(self):
        return self

    def __next__(self):
        t = time.perf_counter()
        cam, img = next(self.loader)
        self.wait_s += time.perf_counter() - t
        self.uids.append(cam.uid)
        return cam, img

    def stop(self):
        self.loader.stop()


class Window:
    """The trainer's live control: opens the window at its first poll and
    asks the trainer to stop once the window is over. A traced run times
    `untraced_iterations` iterations by the host's clock, then profiles
    `busy_iterations` of the device alone and `trace_iterations` with the
    host's ops."""

    paused = False

    def __init__(self, ctx):
        self.ctx, self.tr = ctx, ctx.traffic["params"]
        self.stop_requested = False
        self.t0 = self.t1 = self.it0 = self.it1 = None
        self.cm = self.prof = None
        self.plain = None  # (seconds, iterations) of the untraced stretch
        self.busy = self.stage = None  # (profile, seconds, iterations)
        self.dispatches = []  # (n_nonfinite, n_instances, instance_cap) of each dispatch
        self.enqueue_s = []  # (steps, host seconds in run_dispatch) of each dispatch
        self.unpin = lambda: None

    def consume_save_request(self) -> bool:
        return False

    def _open(self, host: bool) -> None:
        from port_bench.trace import device_trace

        self.cm = device_trace(host)
        self.prof = self.cm.__enter__()

    def _close(self):
        self.cm.__exit__(None, None, None)
        return self.prof

    def run_pending(self, trainer) -> None:
        if self.stop_requested:
            return
        it = trainer.last_progress[0]
        if self.t0 is None:
            pinned, self.unpin = pin_host_threads()
            self.ctx.log(f"[port_bench] {pinned}")
            self.ctx.start_window()
            if self.ctx.trace:
                sync(self.ctx.device)
            self.t0, self.it0 = time.perf_counter(), it
            return
        now = time.perf_counter()
        if not self.ctx.trace:
            if now - self.t0 < self.ctx.seconds:
                return
        elif self.plain is None:
            if it - self.it0 >= self.tr["untraced_iterations"]:
                sync(self.ctx.device)
                self.plain = (time.perf_counter() - self.t0, it - self.it0)
                self._open(host=False)
                self.t_busy, self.it_busy = time.perf_counter(), it
            return
        elif self.busy is None:
            if it - self.it_busy >= self.tr["busy_iterations"]:
                prof = self._close()
                self.busy = (prof, time.perf_counter() - self.t_busy, it - self.it_busy)
                self._open(host=True)
                self.t_stage, self.it_stage = time.perf_counter(), it
            return
        elif it - self.it_stage < self.tr["trace_iterations"]:
            return
        else:
            self.stage = (self._close(), time.perf_counter() - self.t_stage, it - self.it_stage)
        sync(self.ctx.device)
        self.t1, self.it1 = time.perf_counter(), it
        self.stop_requested = True
        self.unpin()


def _views(data: Path, uids: list[int], device):
    """Reference views and target images of the trainer's views `uids`
    (the loader numbers views in name order)."""
    intr, views = garden.read_colmap_views(data)
    out, gts = [], []
    for uid in uids:
        v = views[uid]
        out.append(raster.View(torch.tensor(v["R"], device=device),
                               torch.tensor(v["T"], device=device), intr["fx"], intr["fy"],
                               intr["cx"], intr["cy"], intr["width"], intr["height"],
                               intr["model"], tuple(intr["radial"])))
        gts.append(torch.from_numpy(garden.load_jpeg(v["path"])).to(device))
    return out, gts


def _norm_gaps(prog: dict, ref: dict, keys) -> tuple[float, float]:
    """Worst leaf's |‖prog‖ - ‖ref‖| and ‖prog - ref‖, each over the larger of
    the reference leaf's norm and the median leaf norm."""
    norms = {k: float(torch.linalg.norm(ref[k].double())) for k in keys}
    med = float(np.median(list(norms.values())))
    gap = diff = 0.0
    for k in keys:
        base = max(norms[k], med, 1e-30)
        p = prog[k].to(ref[k].device).double()
        gap = max(gap, abs(float(torch.linalg.norm(p)) - norms[k]) / base)
        diff = max(diff, float(torch.linalg.norm(p - ref[k].double())) / base)
    return gap, diff


def reference_steps(first: dict, ctx, device, *, tf32: bool = False, half: bool = False):
    """The reference's first steps from the seed's PLY on the program's
    views: (params at the start, losses, first gradient, params at the end,
    instances a step)."""
    params = garden.make_splats(ctx.config["scene"], ctx.seed, device)
    views, gts = _views(first["data"], first["uids"], device)
    gen = torch.Generator(device=device).manual_seed(garden.seed_of(ctx.seed, 6))
    return (params, *raster.train_steps(params, views, gts, dict(ctx.config["train"]), gen,
                                        tf32=tf32, half=half))


def control_first(first: dict, ctx, device, *, fault: str = "tf32") -> dict:
    """What the reference computed with TF32 on ("tf32", the check's
    control) or over half the image ("half", a planted fault), put in the
    program's place (its Adam first moment: (1 - beta1) g)."""
    _, losses, g1, p_end, n_inst = reference_steps(first, ctx, device, tf32=fault == "tf32",
                                                   half=fault == "half")
    return dict(first, losses=losses, n_instances=n_inst, p_end=p_end,
                m1={k: (1.0 - raster.BETA1) * g for k, g in g1.items()})


def compare(first: dict, ctx, device) -> list[Check]:
    """The reference's first steps against what the program's steps left."""
    params, losses, g1, p_end, n_inst = reference_steps(first, ctx, device)
    g_prog = {k: first["m1"][k] / (1.0 - raster.BETA1) for k in GROUPS}
    grad_gap, grad_diff = _norm_gaps(g_prog, g1, GROUPS)
    g_norms = {k: float(torch.linalg.norm(g1[k])) for k in GROUPS}
    g_med = float(np.median(list(g_norms.values())))
    moved = [k for k in GROUPS if g_norms[k] >= 1e-3 * g_med]
    ctx.log(f"[port_bench] first gradient's norms by leaf {g_norms}; left out of the change: "
            f"{sorted(set(GROUPS) - set(moved)) or 'none'}")
    d_prog = {k: first["p_end"][k].to(device) - params[k] for k in moved}
    d_ref = {k: p_end[k] - params[k] for k in moved}
    upd_gap, upd_diff = _norm_gaps(d_prog, d_ref, moved)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(first["losses"], losses))
    inst_gap = max(abs(a - b) for a, b in zip(first["n_instances"], n_inst))
    lim = ctx.limits
    return [Check("loss_gap", loss_gap, lim["loss_gap"]),
            Check("grad_norm_gap", grad_gap, lim["grad_norm_gap"]),
            Check("grad_diff", grad_diff, lim["grad_diff"]),
            Check("update_norm_gap", upd_gap, lim["update_norm_gap"]),
            Check("update_diff", upd_diff, lim["update_diff"]),
            Check("instance_gap", float(inst_gap), lim["instance_gap"])]


def _snapshot(splats, adam) -> dict:
    """The strategy's state, copied to the host."""
    return {"params": {k: v.detach().cpu().clone() for k, v in splats.trainable_dict().items()},
            "exp_avg": {k: v.detach().cpu().clone() for k, v in adam.exp_avg.items()},
            "exp_avg_sq": {k: v.detach().cpu().clone() for k, v in adam.exp_avg_sq.items()},
            "n_active": int(splats.n_active)}


def capture_first_refine(store: dict):
    """Wrap the program's MCMC post_backward so that its first refine
    leaves the state before it and after it (noise included, before Adam)
    in `store`; returns the function that takes the wrapper off."""
    from lichtfeld_studio_tpu_torch.train.strategies import mcmc as strategy

    real = strategy.post_backward

    def post_backward(generator, splats, adam, binoms, cfg, *, refine=False, **kw):
        if not refine or "before" in store:
            return real(generator, splats, adam, binoms, cfg, refine=refine, **kw)
        store["before"] = _snapshot(splats, adam)
        out = real(generator, splats, adam, binoms, cfg, refine=refine, **kw)
        store["after"] = _snapshot(*out)
        return out

    strategy.post_backward = post_backward
    return lambda: setattr(strategy, "post_backward", real)


def refine_draws(ctx, capacity: int, iteration: int, device) -> dict:
    """The draws of the refine at `iteration`, replayed from the seed in
    the strategy's order (the noise of each step from the start iteration
    on, then the refine's)."""
    gen = torch.Generator(device=device).manual_seed(garden.seed_of(ctx.seed, 6))
    for _ in range(ctx.config["train"]["start_iteration"] + 1, iteration):
        mcmc.draws(gen, capacity, False, device)
    return mcmc.draws(gen, capacity, True, device)


def refine_lr(ctx, iteration: int) -> float:
    """The means lr at `iteration` (it decays a step from the start)."""
    t = ctx.config["train"]
    gamma = 0.01 ** (1.0 / t["iterations"])
    return raster.lr_schedule(t)["means"] * gamma ** (iteration - 1 - t["start_iteration"])


def _to(state: dict, device) -> dict:
    return {k: ({n: t.to(device) for n, t in v.items()} if isinstance(v, dict) else v)
            for k, v in state.items()}


def refine_readings(rf: dict, ctx, device, fault: str | None = "program") -> dict:
    """The refine's numbers: the program's (`fault` "program"), or those of
    the reference put in the program's place with a planted fault
    (reference/mcmc.py::planted; None plants none)."""
    before = _to(rf["before"], device)
    dr = refine_draws(ctx, before["params"]["opacity"].shape[0], rf["iteration"], device)
    lr = refine_lr(ctx, rf["iteration"])
    after = (_to(rf["after"], device) if fault == "program"
             else mcmc.planted(before, dr, lr, ctx.config["train"], fault))
    gap, ref = mcmc.judge(before, after, dr, lr, ctx.config["train"])
    moments = max(mcmc.leaf_diff(after[k], ref[k], None) for k in ("exp_avg", "exp_avg_sq"))
    return {"refine_pick_gap": gap,
            "refine_diff": mcmc.leaf_diff(after["params"], ref["params"], before["params"]),
            "refine_moment_diff": moments}


def compare_refine(first: dict, ctx, device) -> list[Check]:
    """The program's first refine (in the warm-up), judged from the state
    before it (reference/mcmc.py)."""
    rf = first.get("refine") or {}
    if "after" in rf:
        r = refine_readings(rf, ctx, device)
    else:  # the program ran no refine where the configuration states one
        ctx.log("[port_bench] the warm-up's refine never reached the strategy")
        r = dict.fromkeys(("refine_pick_gap", "refine_diff", "refine_moment_diff"), float("inf"))
    return [Check(k, v, ctx.limits[k]) for k, v in r.items()]


def set_up(ctx, out: Path, warm: bool = True):
    """Dataset, trainer, the start iteration, the check's first steps and
    (with `warm`) the warm-up. Returns (trainer, what the first steps
    left)."""
    from lichtfeld_studio_tpu_torch.cli import parse_args_and_params
    from lichtfeld_studio_tpu_torch.train.state import StepFlags, step_flags
    from lichtfeld_studio_tpu_torch.train.trainer import Trainer

    cfg, tr = ctx.config, ctx.traffic["params"]
    data = garden.build(ctx.cache / "data", cfg, ctx.seed, ctx.device)
    ctx.mark("dataset made")
    params = parse_args_and_params(cli_argv(cfg, data, out, tr.get("cli_extra", ())))
    check_params(params, cfg)
    trainer = Trainer.setup(params, ctx.device)
    state = trainer.state
    if state.splats.scene_scale != 1.0 or int(state.splats.n_active) != state.splats.capacity:
        raise RuntimeError("the warm start is not at the cap with scene scale 1")
    lr0 = raster.lr_schedule(cfg["train"])
    state.iteration = cfg["train"]["start_iteration"]
    state.adam.lr["means"] = torch.tensor(lr0["means"], dtype=torch.float32, device=ctx.device)
    state.generator = torch.Generator(device=ctx.device).manual_seed(garden.seed_of(ctx.seed, 6))

    ctx.mark("trainer set up")
    bg = torch.zeros(3, device=ctx.device)
    trainer.start_loader()
    trainer._loader = feed = Feed(trainer._loader)
    first = {"data": data, "losses": [], "n_instances": []}
    for i in range(tr["check_steps"]):
        flags = step_flags(trainer.cfg, state.iteration + 1)
        if flags != StepFlags():
            raise RuntimeError(f"the check's step {state.iteration + 1} is not a plain step")
        metrics = trainer.run_dispatch(1, flags, bg)
        first["losses"].append(float(metrics["loss"]))
        first["n_instances"].append(int(metrics["n_instances"]))
        if i == 0:
            first["m1"] = {k: v.detach().cpu().clone() for k, v in trainer.state.adam.exp_avg.items()}
    first["p_end"] = {k: v.detach().cpu().clone()
                      for k, v in trainer.state.splats.trainable_dict().items()}
    first["uids"] = feed.uids[:tr["check_steps"]]
    first["instance_cap"] = trainer.cfg.instance_cap
    ctx.mark("the check's first steps done")

    # warm-up: the trainer's dispatches (as train() groups them) through one
    # refine, whose state before and after is kept for the check
    k_max, plain, it = params.optimization.dispatch_steps, StepFlags(), trainer.state.iteration
    refined, after = False, 0
    first["refine"] = {}
    release = capture_first_refine(first["refine"]) if warm else None
    while warm and after < tr["warmup_dispatches_after_refine"]:
        flags = step_flags(trainer.cfg, it + 1)
        k = k_max if flags == plain and all(
            step_flags(trainer.cfg, it + j) == plain for j in range(2, k_max + 1)) else 1
        if flags.refine and not refined:
            first["refine"]["iteration"] = it + 1
        metrics = trainer.run_dispatch(k, flags, bg)
        int(metrics["n_instances"])  # the trainer's one read a dispatch
        it += k
        refined |= flags.refine
        after += int(refined and not flags.refine)
    if release is not None:
        release()
    trainer.stop_loader()
    sync(ctx.device)
    return trainer, first


def run(ctx) -> Result:
    tr = ctx.traffic["params"]
    out = ctx.cache / "runs" / ctx.cell["name"]
    shutil.rmtree(out, ignore_errors=True)
    trainer, first = set_up(ctx, out)

    window = Window(ctx)
    trainer.control = window
    run_dispatch = trainer.run_dispatch

    def counted_dispatch(k, flags, bg):
        t = time.perf_counter()
        metrics = run_dispatch(k, flags, bg)
        if window.t0 is not None and not window.stop_requested:
            window.dispatches.append((metrics["n_nonfinite"], metrics["n_instances"],
                                      trainer.cfg.instance_cap))
            window.enqueue_s.append((k, time.perf_counter() - t))
        return metrics

    trainer.run_dispatch = counted_dispatch
    start_loader = trainer.start_loader
    feed = []

    def recording_loader():
        start_loader()
        trainer._loader = f = Feed(trainer._loader)
        feed.append(f)

    trainer.start_loader = recording_loader
    trainer.train()
    ctx.mark("train() returned (window closed, PLY written)")
    peak = memory_peak(ctx.device)
    if window.t1 is None:
        raise RuntimeError("the trainer ended before the window closed")
    iters = window.it1 - window.it0
    secs = window.t1 - window.t0
    enq = sorted(1e3 * s / k for k, s in window.enqueue_s if k > 1)
    ctx.log(f"[port_bench] window: {iters} iterations in {secs:.3f} s; the loader's wait "
            f"{1e3 * feed[-1].wait_s / max(len(feed[-1].uids), 1):.3f} ms a view; host ms a step "
            f"in run_dispatch (dispatches of 8) min {enq[0]:.2f} median "
            f"{enq[len(enq) // 2]:.2f} max {enq[-1]:.2f}" if enq else "")
    failed = sum(int(bad) > 0 or int(n) > cap for bad, n, cap in window.dispatches)
    readings = {}
    trace = None
    if ctx.trace:
        from port_bench.trace import summarize

        trace = summarize(window.busy[0], window.busy[1], window.busy[2], window.stage[0],
                          window.stage[2], *window.plain)
        uids = feed[-1].uids
        sample = uids[len(uids) // 2:][:: max(1, len(uids) // 16)][:tr["work_views"]]
        last = {k: v.detach().clone()
                for k, v in trainer.state.splats.trainable_dict().items()}
    del trainer, window
    gc.collect()
    torch.cuda.empty_cache()
    if ctx.trace:
        readings = {"trace": trace,
                    "work": counts.train_work(last, ctx.config, first["data"], sample)}
        del last
        gc.collect()
        torch.cuda.empty_cache()
    checks = compare(first, ctx, ctx.device) + compare_refine(first, ctx, ctx.device)
    ctx.mark("reference compared")
    # an overflowing step drops instances: the reference would not match it
    checks.append(Check("instances_over_cap",
                        float(max(first["n_instances"]) > first["instance_cap"]), 0.0))
    shutil.rmtree(out, ignore_errors=True)
    return Result(metrics={"train_it_s": iters / secs},
                  attempted=iters, failed=failed, memory_peak_bytes=peak, checks=checks,
                  readings=readings, trace=trace)
