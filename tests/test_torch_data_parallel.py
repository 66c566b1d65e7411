"""Camera-batch data parallelism of the port (lichtfeld_studio_tpu_torch/
parallel/) against the JAX package's (lichtfeld_studio_tpu/parallel/) and
against the port's own sequential step, on the CPU under gloo.

Every rank is a spawned process that imports this module by name, so the
rank bodies live here at module level and JAX is imported only inside the
parent's reference functions. Each multi-process case bounds its
collectives (60 s) and its whole run (a join deadline); each rank runs one
thread. The studio's `/train --devices 2` runs its rank 0 in this process
(the session's thread) and is held to the CLI's ranks on the same flags.

Tolerances: the reduced gradients against the JAX package's per-camera
compute_grads averaged over the cameras, rtol 2e-2 / atol 2e-5 (the
single-camera parity tolerance of test_torch_train_step.py); everything
between the port's ranks and its sequential reference is bit for bit.
"""

import dataclasses
import datetime
import re

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from lichtfeld_studio_tpu_torch import cli
from lichtfeld_studio_tpu_torch.core.camera import look_at_camera
from lichtfeld_studio_tpu_torch.core.splat_data import SplatData
from lichtfeld_studio_tpu_torch.io.dataset import CameraDataset, InfiniteRandomLoader
from lichtfeld_studio_tpu_torch.parallel import (
    broadcast_state,
    dp_train_step,
    dryrun_multichip,
    make_camera_batch,
    reduce_grads,
    spawn_ranks,
    state_digest,
)
from lichtfeld_studio_tpu_torch.render import headless
from lichtfeld_studio_tpu_torch.tools.selfcheck_train import write_scene
from lichtfeld_studio_tpu_torch.train import state as t_state
from lichtfeld_studio_tpu_torch.train.strategies.mcmc import MCMCConfig

GROUPS = ("means", "sh0", "shN", "scaling", "rotation", "opacity")
TIMEOUT = datetime.timedelta(seconds=60)
DEADLINE = 120.0  # seconds, a whole spawned run
W, H, CAP = 48, 32, 64
LRS = dict(zip(("opt_means_lr", "shs_lr", "scaling_lr", "rotation_lr", "opacity_lr"),
               (1.6e-3, 2.5e-3, 5e-3, 1e-3, 0.05)))
MCMC = dict(max_cap=CAP, start_refine=1, stop_refine=1000, refine_every=1)
STRATEGIES = ("mcmc", "default")
# the one-step cases: (strategy, a refining step)
VARIANTS = {"mcmc_refine": ("mcmc", True), "adc": ("default", False),
            "adc_refine": ("default", True)}


def _spawn(fn, world, *args, device="cpu"):
    return spawn_ranks(fn, world, args=args, device=device, timeout=TIMEOUT, deadline=DEADLINE)


def _cameras(n):
    """n host cameras on a ring around the origin (the port's Camera)."""
    cams = []
    for i in range(n):
        theta = 0.3 * i
        eye = 4.0 * np.array([np.sin(theta), -0.1, -np.cos(theta)])
        cams.append(look_at_camera(eye, np.zeros(3), np.array([0.0, -1.0, 0.0]), 60.0, 60.0,
                                   W, H, uid=i))
    return cams


# ---------------------------------------------------------------------------
# (a) the camera batch


def test_make_camera_batch_equals_jax():
    from lichtfeld_studio_tpu.core.camera import look_at_camera as j_look_at
    from lichtfeld_studio_tpu.parallel.data_parallel import make_camera_batch as j_batch

    rng = np.random.default_rng(0)
    cams = _cameras(3)
    j_cams = [j_look_at(4.0 * np.array([np.sin(0.3 * i), -0.1, -np.cos(0.3 * i)]), np.zeros(3),
                        np.array([0.0, -1.0, 0.0]), 60.0, 60.0, W, H, uid=i) for i in range(3)]
    images = [rng.uniform(0, 1, (H, W, 3)).astype(np.float32) for _ in cams]
    got, gt = make_camera_batch(cams, images, "cpu")
    want, gt_j = j_batch(j_cams, images)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        assert got[k].numpy().dtype == np.asarray(want[k]).dtype, k
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gt_j))


# ---------------------------------------------------------------------------
# (b), (d) one step on two ranks: the JAX package's averaged gradients, the
# port's sequential averaged step, the ADC statistics


def _config(strategy):
    return t_state.TrainConfig(raster_mode="cuda", mcmc=MCMCConfig(**MCMC), lambda_dssim=0.2,
                               tile_size=32, instance_cap=4096, lr_gamma=0.999,
                               strategy=strategy)


def _port_state(arrays, device="cpu"):
    splats = SplatData.from_numpy(arrays, device)
    return t_state.init_train_state(
        splats, t_state.make_lrs(**LRS, scene_scale=splats.scene_scale), seed=0)


def _np(t):
    return t.detach().cpu().numpy()


def _sequential(arrays, cfg, views, images, flags, draws):
    """The sequential reference in one process: both cameras'
    compute_grads, (g0 + g1) / 2, the summed ADC statistics, apply_update
    with the same draws."""
    bg = torch.zeros(3)
    seq = _port_state(arrays)
    per_cam = [t_state.compute_grads(seq, v, g, bg, cfg, flags) for v, g in zip(views, images)]
    avg = {k: (per_cam[0][2][k] + per_cam[1][2][k]) / 2 for k in GROUPS}
    stats = None
    if cfg.strategy == "default":
        s0, s1 = (t_state.adc_stats(p[2]["_mean2d"], p[1]) for p in per_cam)
        stats = (s0[0] + s1[0], s0[1] + s1[1])
    return t_state.apply_update(seq, avg, cfg, (per_cam[0][0] + per_cam[1][0]) / 2, per_cam[0][1],
                                flags, draws, stats=stats)


def _rank_one_step(ctx, arrays, cams, gts, draws):
    """Per variant: this rank's reduced gradients and statistics, the DP
    step's state digest and statistics, and the sequential reference
    (_sequential, in this process) as a digest; then a --gut-exact step
    through a fisheye camera against its sequential reference."""
    from lichtfeld_studio_tpu_torch.tools.scenes import FISHEYE_RADIAL
    from lichtfeld_studio_tpu_torch.core.camera import CameraModelType

    torch.set_num_threads(1)
    bg = torch.zeros(3)
    out = {}
    for variant, (strategy, refine) in VARIANTS.items():
        cfg = _config(strategy)
        flags = t_state.StepFlags(refine=refine)
        step_draws = {k: torch.from_numpy(v) for k, v in draws.items()} if strategy == "mcmc" \
            else None
        views = [c.device_params("cpu") for c in cams]
        images = [torch.from_numpy(g) for g in gts]
        state = _port_state(arrays)
        broadcast_state(state, ctx)
        loss, rout, grads = t_state.compute_grads(state, views[ctx.rank], images[ctx.rank], bg, cfg,
                                                  flags)
        dm = grads.pop("_mean2d", None)
        stats = t_state.adc_stats(dm, rout) if dm is not None else None
        reduced, rstats = reduce_grads(grads, ctx.group, stats)
        res = {"grads": {k: _np(v) for k, v in reduced.items()},
               "stats": None if stats is None else [_np(s) for s in stats],
               "reduced_stats": None if rstats is None else [_np(s) for s in rstats]}
        state, metrics = dp_train_step(state, views[ctx.rank], images[ctx.rank], bg, cfg, flags,
                                       ctx.group, step_draws)
        res.update(digest=state_digest(state), loss=float(metrics["loss"]),
                   densify=[_np(state.densify_count), _np(state.densify_grad)],
                   n_active=int(state.splats.n_active))

        seq, seq_metrics = _sequential(arrays, cfg, views, images, flags, step_draws)
        res.update(seq_digest=state_digest(seq), seq_loss=float(seq_metrics["loss"]))
        out[variant] = res

    cfg = dataclasses.replace(_config("mcmc"), tile_size=16, projection="ut", gut_exact=True)
    views = [dataclasses.replace(c.device_params("cpu"), camera_model=CameraModelType.OPENCV_FISHEYE,
                                 radial=torch.tensor(FISHEYE_RADIAL)) for c in cams]
    images = [torch.from_numpy(g) for g in gts]
    state = _port_state(arrays)
    broadcast_state(state, ctx)
    state, metrics = dp_train_step(state, views[ctx.rank], images[ctx.rank], bg, cfg,
                                   t_state.StepFlags(), ctx.group)
    seq, seq_metrics = _sequential(arrays, cfg, views, images, t_state.StepFlags(), None)
    out["gut_exact"] = {"digest": state_digest(state), "seq_digest": state_digest(seq),
                        "loss": float(metrics["loss"]), "seq_loss": float(seq_metrics["loss"])}
    return out


def _jax_reference():
    """The scene, two cameras, their targets, the JAX package's per-camera
    compute_grads averaged over the two cameras (per strategy), and the MCMC
    draws apply_update takes from its key (test_torch_train_step.py's
    derivation)."""
    import jax
    import jax.numpy as jnp

    from lichtfeld_studio_tpu.core.camera import look_at_camera as j_look_at
    from lichtfeld_studio_tpu.train import state as j_state
    from lichtfeld_studio_tpu.train.strategies.mcmc import MCMCConfig as JMCMCConfig
    from tests.scene_utils import make_random_splats
    from tests.torch_parity import SPLAT_FIELDS, to_torch_camera

    rng = np.random.default_rng(0)
    sd = make_random_splats(rng, n=48, capacity=CAP, spread=0.9)
    sd = sd.replace_trainable({**sd.trainable_dict(), "opacity": sd.opacity.at[:4].set(-15.0)})
    sd = dataclasses.replace(sd, active_sh_degree=jnp.asarray(1, jnp.int32))
    j_cams = [j_look_at(4.0 * np.array([np.sin(0.3 * i), -0.1, -np.cos(0.3 * i)]), np.zeros(3),
                        np.array([0.0, -1.0, 0.0]), 60.0, 60.0, W, H, uid=i) for i in range(2)]
    gts = [rng.uniform(0, 1, (H, W, 3)).astype(np.float32) for _ in j_cams]
    state = j_state.init_train_state(sd, j_state.make_lrs(**LRS, scene_scale=sd.scene_scale),
                                     seed=0)
    avg = {}
    for strategy in STRATEGIES:
        cfg = j_state.TrainConfig(raster_mode="tiles", mcmc=JMCMCConfig(**MCMC), lambda_dssim=0.2,
                                  tile_size=32, instance_cap=4096, lr_gamma=0.999,
                                  strategy=strategy)
        compute = jax.jit(j_state.compute_grads, static_argnames=("cfg",))
        per_cam = [compute(state, c.device_params(), jnp.asarray(g), jnp.zeros(3), cfg=cfg)[2]
                   for c, g in zip(j_cams, gts)]
        avg[strategy] = {k: (np.asarray(per_cam[0][k]) + np.asarray(per_cam[1][k])) / 2
                         for k in GROUPS}
    _, sub = jax.random.split(state.key)
    k_rel, k_add, k_noise = jax.random.split(sub, 3)
    draws = {"relocate": np.asarray(jax.random.uniform(k_rel, (CAP,))),
             "add": np.asarray(jax.random.uniform(k_add, (CAP,))),
             "noise": np.asarray(jax.random.normal(k_noise, (CAP, 3)))}
    arrays = {k: np.asarray(getattr(sd, k)) for k in SPLAT_FIELDS}
    arrays.update(max_sh_degree=sd.max_sh_degree, scene_scale=sd.scene_scale)
    return arrays, [to_torch_camera(c) for c in j_cams], gts, avg, draws


@pytest.fixture(scope="module")
def one_step():
    arrays, cams, gts, avg, draws = _jax_reference()
    ranks = _spawn(_rank_one_step, 2, arrays, cams, gts, draws)
    return ranks, avg


@pytest.mark.parametrize("variant", VARIANTS)
def test_reduced_grads_match_jax_average(one_step, variant):
    ranks, avg = one_step
    strategy = VARIANTS[variant][0]
    for r in ranks:
        got = r[variant]["grads"]
        assert set(got) == set(GROUPS)
        for k in GROUPS:
            assert np.isfinite(got[k]).all(), k
            np.testing.assert_allclose(got[k], avg[strategy][k], rtol=2e-2, atol=2e-5,
                                       err_msg=k)
    for k in GROUPS:  # the same bucket on both ranks
        np.testing.assert_array_equal(ranks[0][variant]["grads"][k], ranks[1][variant]["grads"][k])


@pytest.mark.parametrize("variant", VARIANTS)
def test_dp_step_is_the_sequential_averaged_step(one_step, variant):
    """Two ranks give bit for bit the state of (g0 + g1) / 2 and
    apply_update with the same draws and statistics, on both ranks; a
    refining step grows (MCMC) or prunes and densifies (ADC) the model."""
    ranks, _ = one_step
    r0, r1 = ranks[0][variant], ranks[1][variant]
    assert r0["digest"] == r1["digest"] == r0["seq_digest"] == r1["seq_digest"]
    assert r0["loss"] == r1["loss"] == r0["seq_loss"] and np.isfinite(r0["loss"])
    assert (r0["n_active"] != 48) == VARIANTS[variant][1]


def test_gut_exact_dp_step_is_the_sequential_averaged_step(one_step):
    """--gut-exact through a fisheye camera (UT projection, the world
    blend's plain P5/P6): two ranks give the sequential step's bits."""
    r0, r1 = (r["gut_exact"] for r in one_step[0])
    assert r0["digest"] == r1["digest"] == r0["seq_digest"]
    assert r0["loss"] == r1["loss"] == r0["seq_loss"] and np.isfinite(r0["loss"])


@pytest.mark.parametrize("variant", VARIANTS)
def test_adc_statistics_are_the_sum_of_the_cameras(one_step, variant):
    """With ADC the bucket carries each camera's statistics and sums them,
    bit for bit, and after a plain step from zero the state holds those
    sums (a refine consumes them and starts again from zero). MCMC carries
    none."""
    ranks, _ = one_step
    r0, r1 = ranks[0][variant], ranks[1][variant]
    strategy, refine = VARIANTS[variant]
    if strategy == "mcmc":
        assert r0["stats"] is None and r0["reduced_stats"] is None
        assert not r0["densify"][0].any() and not r0["densify"][1].any()
        return
    want = [r0["stats"][i] + r1["stats"][i] for i in range(2)]
    assert (want[0] == 2).any() and (want[1] > 0).any()  # gaussians both cameras see
    for got in (r0["reduced_stats"], r1["reduced_stats"]):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for g, w in zip(r0["densify"], want):
        np.testing.assert_array_equal(g, np.zeros_like(w) if refine else w)


# ---------------------------------------------------------------------------
# (c), (e) four ranks through the trainer: replication across refines, and
# the instance-cap and capacity growth at the same iteration


def _rank_trainer(ctx, scene, out_root):
    """Four iterations (refines at 2 and 4) through Trainer.setup and
    train() per strategy, from a small instance cap and a capacity bucket
    that the first dispatch crowds; the (iteration, instance cap, capacity)
    after every dispatch, the losses and the final digest. Then a run of 8
    iterations under rank 0's live control: a save at 2, a pause at 3
    (resumed 0.3 s later), a stop at 4."""
    import threading

    from lichtfeld_studio_tpu_torch.cli import parse_args_and_params
    from lichtfeld_studio_tpu_torch.render.live_server import TrainingControl
    from lichtfeld_studio_tpu_torch.train.trainer import Trainer

    torch.set_num_threads(1)

    def argv(strategy, iterations, out=None):
        return ["-d", scene, "-o", f"{out_root}/{out or strategy}", "--headless", "--iterations",
                str(iterations), "--random", "--init-num-pts", "56", "--max-cap", "64",
                "--instance-cap", "16384", "--start-refine", "1", "--refine-every", "2",
                "--stop-refine", "5", "--num-workers", "1", "--devices", str(ctx.world),
                "--strategy", strategy, "--grad-threshold", "1e-9"]

    out = {}
    for strategy in STRATEGIES:
        params = parse_args_and_params(argv(strategy, 4))
        trainer = Trainer.setup(params, ctx.device, ranks=ctx)
        # room to grow: the capacity bucket (64, 56 live) and the instance cap
        trainer.params = dataclasses.replace(
            params, optimization=dataclasses.replace(params.optimization, max_cap=256))
        trainer.cfg = dataclasses.replace(trainer.cfg, instance_cap=4)
        log = []
        trainer.progress_callback = lambda it, loss, n: log.append(
            (it, trainer.cfg.instance_cap, trainer.state.splats.capacity, n))
        stats = trainer.train()
        out[strategy] = {"log": log, "losses": stats["losses"],
                         "digest": state_digest(trainer.state),
                         "writer": trainer.project is not None}

    trainer = Trainer.setup(parse_args_and_params(argv("mcmc", 8, "control")), ctx.device, ranks=ctx)
    if ctx.rank == 0:
        control = trainer.control = TrainingControl()

        def steer(it, loss, n):
            if it == 2:
                control.request_save()
            elif it == 3:
                control.pause()
                threading.Timer(0.3, control.resume).start()
            elif it == 4:
                control.request_stop()

        trainer.progress_callback = steer
    trainer.train()
    out["control"] = {"iteration": trainer.state.iteration, "digest": state_digest(trainer.state)}
    return out


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_trainer")
    write_scene(root / "scene", "cpu", width=W, height=H, n_views=6, n_gt=60, focal=60.0)
    return root / "out", _spawn(_rank_trainer, 4, str(root / "scene"), str(root / "out"))


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_four_ranks_stay_bit_identical(four_ranks, strategy):
    four_ranks = four_ranks[1]
    digests = {r[strategy]["digest"] for r in four_ranks}
    assert len(digests) == 1
    for r in four_ranks:
        assert len(r[strategy]["losses"]) == 4 and np.isfinite(r[strategy]["losses"]).all()
        assert r[strategy]["losses"] == four_ranks[0][strategy]["losses"]
    assert [r[strategy]["writer"] for r in four_ranks] == [True, False, False, False]


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_growth_at_the_same_iteration_on_every_rank(four_ranks, strategy):
    logs = [r[strategy]["log"] for r in four_ranks[1]]
    assert all(log == logs[0] for log in logs)
    its, caps, capacities = zip(*[row[:3] for row in logs[0]])
    assert its == (1, 2, 3, 4)
    assert caps[0] > 4 and capacities[0] == 128  # both grew after the first dispatch


def test_live_control_of_rank_0_steers_every_rank(four_ranks):
    """Rank 0's save, pause and stop reach the other ranks: every rank
    stops at rank 0's iteration with the same state, and rank 0 wrote the
    save at 2 and the last PLY at 4."""
    root, ranks = four_ranks
    runs = [r["control"] for r in ranks]
    assert [r["iteration"] for r in runs] == [4] * 4
    assert len({r["digest"] for r in runs}) == 1
    out = root / "control"
    assert (out / "splat_2.ply").exists() and (out / "splat_4.ply").exists()
    assert not (out / "splat_8.ply").exists()


# ---------------------------------------------------------------------------
# (f) the loader's rank shares


@pytest.mark.parametrize("world", [2, 3])
def test_loader_rank_shares_interleave_to_the_one_rank_stream(world):
    cams = _cameras(7)  # an epoch that the ranks do not divide
    ds = CameraDataset(cams, "all")

    def uids(rank, w, n):
        loader = InfiniteRandomLoader(ds, num_workers=1, seed=1, preload=False, rank=rank,
                                      world=w)
        try:
            return [next(loader)[0].uid for _ in range(n)]
        finally:
            loader.stop()

    for c in cams:  # no image files: the loader yields what load_image returns
        c._cached_image = np.zeros((1, 1, 3), np.float32)
    n = 3 * 7
    one = uids(0, 1, n * world)
    shares = [uids(r, world, n) for r in range(world)]
    assert [shares[i % world][i // world] for i in range(n * world)] == one
    for t in range(n):  # each step takes consecutive cameras of the one stream
        assert [s[t] for s in shares] == one[t * world:(t + 1) * world]


# ---------------------------------------------------------------------------
# (g) a rank that raises


def _rank_raises(ctx):
    torch.set_num_threads(1)
    if ctx.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.all_reduce(torch.ones(4), group=ctx.group)  # waits for rank 1
    return "unreachable"


def test_a_rank_that_raises_fails_the_run_with_its_message():
    import time

    t0 = time.monotonic()
    with pytest.raises(tmp.ProcessRaisedException, match="rank 1 fails on purpose"):
        _spawn(_rank_raises, 2)
    assert time.monotonic() - t0 < DEADLINE


STUDIO_FLAGS = ["--random", "--init-num-pts", "100", "--max-cap", "4096", "--start-refine", "1",
                "--refine-every", "2", "--stop-refine", "5", "--num-workers", "1",
                "--devices", "2"]


def _until(cond, what, limit=DEADLINE):
    import time

    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < limit, f"no {what} within {limit} s"
        time.sleep(0.05)


@pytest.fixture(scope="module")
def studio_two_ranks(tmp_path_factory):
    """Two /train runs with --devices 2 in one studio session on the CPU,
    driven through the live server, and the CLI's ranks on the same flags:
    run 1 (6 iterations) is paused once it has begun, renders a frame of
    rank 0's state and resumes; run 2 is paused, renders, and then its
    peer rank is killed."""
    import json
    import multiprocessing
    import time
    import urllib.request

    from lichtfeld_studio_tpu_torch.render import studio
    from lichtfeld_studio_tpu_torch.render.live_server import LiveTrainingServer

    root = tmp_path_factory.mktemp("studio_dp")
    scene = str(root / "scene")
    write_scene(root / "scene", "cpu", width=W, height=H, n_views=3, n_gt=20, focal=60.0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # every rank one thread, as in the CLI's run below
    patch = pytest.MonkeyPatch()
    patch.setattr(studio, "RANK_TIMEOUT", TIMEOUT)
    session = studio.StudioSession(out_dir=root / "studio", device="cpu")
    server = LiveTrainingServer(session, port=0).start()

    def call(path, body=None):
        req = urllib.request.Request(f"http://127.0.0.1:{server.port}{path}",
                                     data=None if body is None else json.dumps(body).encode(),
                                     method="GET" if body is None else "POST")
        with urllib.request.urlopen(req, timeout=DEADLINE) as r:
            data = r.read()
            return json.loads(data) if r.headers["Content-Type"] == "application/json" else data

    def paused_frame():
        """Pause the run once rank 0 has trained, render a frame, and
        return (state.json while paused, the frame)."""
        call("/control?cmd=pause", {})
        _until(lambda: session.last_progress[0] >= 1, "iteration")
        png = call(f"/render.png?w={W}&h={H}&yaw=0.3&pitch=0.1&r=1")
        return call("/state.json"), headless_png(png)

    out = {}
    try:
        assert call("/open", {"path": scene})["mode"] == "staged"
        res = call("/train", {"argv": STUDIO_FLAGS + ["--iterations", "6"]})
        out["started"] = res
        out["paused"], out["frame"] = paused_frame()
        call("/control?cmd=resume", {})
        assert session.wait(DEADLINE), "run 1 did not end"
        out["run1"] = {"mode": session.mode, "error": session.train_error,
                       "stats": session.train_stats, "digest": state_digest(session.trainer.state),
                       "session": call("/session.json"),
                       "listing": sorted(p.name for p in (root / "studio").iterdir())}

        res = call("/train", {"argv": STUDIO_FLAGS + ["--iterations", "1000"]})
        out["run2_paused"], out["run2_frame"] = paused_frame()
        peers = [p for p in multiprocessing.active_children() if p.is_alive()]
        out["run2_peers"] = len(peers)
        t0 = time.monotonic()
        for p in peers:
            p.kill()
        ended = session.wait(DEADLINE)
        out["run2"] = {"ended": ended, "seconds": time.monotonic() - t0, "mode": session.mode,
                       "error": session.train_error, "session": call("/session.json"),
                       "alive": [p for p in multiprocessing.active_children() if p.is_alive()]}
    finally:
        if session.control is not None:
            session.control.request_stop()
        session.wait(DEADLINE)
        server.stop()
        patch.undo()
        torch.set_num_threads(threads)

    cli_argv = ["-d", scene, "-o", str(root / "cli"), "--headless", *STUDIO_FLAGS,
                "--iterations", "6"]
    torch.set_num_threads(1)
    try:
        out["cli"] = _spawn(cli._train_rank, 2, cli_argv)
    finally:
        torch.set_num_threads(threads)
    return out


def headless_png(body: bytes) -> np.ndarray:
    import io

    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(body)))


def test_studio_devices_2_ends_in_the_cli_state(studio_two_ranks):
    """A studio /train with --devices 2 ends in "done" with no train_error,
    rank 0's final state equal bit for bit to that of the CLI's ranks on
    the same flags, and rank 0's outputs adopted by the session."""
    r = studio_two_ranks["run1"]
    assert studio_two_ranks["started"] == {"mode": "training", "iterations": 6}
    assert r["mode"] == "done" and r["error"] is None
    assert r["session"]["mode"] == "done" and r["session"]["train_error"] is None
    cli_digests = {x["digest"] for x in studio_two_ranks["cli"]}
    assert cli_digests == {r["digest"]}
    assert r["stats"]["num_gaussians"] == studio_two_ranks["cli"][0]["stats"]["num_gaussians"]
    assert r["stats"]["losses"] == studio_two_ranks["cli"][0]["stats"]["losses"]
    assert "splat_6.ply" in r["listing"] and r["session"]["model_loaded"]


def test_studio_devices_2_pauses_renders_rank_0_and_resumes(studio_two_ranks):
    """Paused from the browser, the run reports "paused" before its end and
    renders a frame of rank 0's state; resumed, it runs to its end."""
    paused, frame = studio_two_ranks["paused"], studio_two_ranks["frame"]
    assert paused["status"] == "paused" and paused["paused"]
    assert 1 <= paused["iteration"] < 6
    assert frame.shape == (H, W, 3) and frame.std() > 0
    assert studio_two_ranks["run1"]["stats"]["losses"][-1] > 0


def test_a_second_studio_train_opens_a_fresh_group(studio_two_ranks):
    """A second /train in the same session trains on two ranks again (a
    fresh group on a fresh store): it reaches a pause and renders."""
    paused = studio_two_ranks["run2_paused"]
    assert paused["status"] == "paused" and paused["iteration"] >= 1
    assert studio_two_ranks["run2_frame"].shape == (H, W, 3)
    assert studio_two_ranks["run2_peers"] == 1


def test_a_studio_peer_that_dies_surfaces_in_train_error(studio_two_ranks):
    """Rank 1 killed while the run is paused: rank 0 leaves its group, the
    run ends "done" with the peer's exit in train_error, within the
    collectives' timeout, and leaves no process behind."""
    r = studio_two_ranks["run2"]
    assert r["ended"] and r["seconds"] < TIMEOUT.total_seconds()
    assert r["mode"] == "done" and r["session"]["mode"] == "done"
    assert "rank 1 exited with code -9" in r["error"], r["error"]
    assert r["session"]["train_error"] == r["error"] and not r["alive"]


def test_trainer_setup_refuses_devices_without_a_group(tmp_path):
    """A direct caller of Trainer.setup with --devices 2 and no process
    group is refused before anything is set up."""
    from lichtfeld_studio_tpu_torch.cli import parse_args_and_params
    from lichtfeld_studio_tpu_torch.train.trainer import Trainer

    write_scene(tmp_path / "scene", "cpu", width=W, height=H, n_views=3, n_gt=20, focal=60.0)
    params = parse_args_and_params(["-d", str(tmp_path / "scene"), "-o", str(tmp_path / "out"),
                                    "--headless", "--devices", "2", "--iterations", "1"])
    with pytest.raises(ValueError, match="the CLI and the studio spawn the ranks"):
        Trainer.setup(params, "cpu")
    assert not (tmp_path / "out").exists()


# ---------------------------------------------------------------------------
# (h) the dry run


@pytest.mark.parametrize("n", [1, 2, 4])
def test_dryrun_multichip(n, capfd):
    loss = dryrun_multichip(n, device="cpu")
    assert np.isfinite(loss)
    assert f"dryrun_multichip({n}): OK" in capfd.readouterr().out


def test_bench_dp_at_a_tiny_size():
    """bench_dp's protocol on two CPU ranks at a tiny size: the ranks end
    with the same state (it raises otherwise), the timings are there."""
    from lichtfeld_studio_tpu_torch.bench_dp import benchmark_dp

    r = benchmark_dp(2, "cpu", warmup=1, steps=2, n0=200, cap=300, width=64, height=48,
                     instance_cap=4096)
    assert r["ranks"] == 2 and r["backend"] == "gloo" and r["allreduce_device_ms"] is None
    assert r["step_ms"] > r["reduce_ms"] > 0 and np.isfinite(r["loss"])
    assert r["bucket_mb"] == 300 * 59 * 4 / 1e6


# ---------------------------------------------------------------------------
# (i) the CLI


def test_cli_devices_2_trains_writes_on_rank_0_and_resumes(tmp_path, monkeypatch, capfd):
    """--devices 2 through main(argv) on the CPU (asked for by the test):
    rc 0, one set of outputs (rank 0's), equal digests printed by both
    ranks; then --resume from its snapshot on two ranks."""
    write_scene(tmp_path / "scene", "cpu", width=W, height=H, n_views=6, n_gt=60, focal=60.0)
    monkeypatch.setattr(headless, "default_device", lambda: torch.device("cpu"))
    out = tmp_path / "out"
    base = ["-d", str(tmp_path / "scene"), "-o", str(out), "--headless", "--random",
            "--init-num-pts", "100", "--max-cap", "4096", "--start-refine", "1",
            "--refine-every", "2", "--stop-refine", "5", "--num-workers", "1",
            "--save-state-every", "4", "--devices", "2", "--eval", "--test-every", "3",
            "--eval-steps", "4"]
    assert cli.main(base + ["--iterations", "4"]) == 0
    printed = capfd.readouterr().out
    digests = re.findall(r"^\[dp\] rank (\d) of 2 on cpu: iteration 4, state sha256 (\w+)",
                         printed, re.MULTILINE)
    assert sorted(r for r, _ in digests) == ["0", "1"] and len({d for _, d in digests}) == 1
    assert printed.count("[state] snapshot at iter 4") == 1 and printed.count("[eval] iter 4") == 1
    assert "done:" in printed and "[dp] 2 ranks, backend gloo" in printed
    assert sorted(p.name for p in out.iterdir()) == [
        "eval_step_4", "metrics.csv", "project.lfs", "report.txt", "splat_4.ply", "state_4",
        "viewer_live.html"]

    assert cli.main(base + ["--iterations", "6", "--resume", str(out / "state_4")]) == 0
    printed = capfd.readouterr().out
    assert printed.count("[resume] restored iteration 4") == 1
    digests = re.findall(r"iteration 6, state sha256 (\w+)", printed)
    assert len(digests) == 2 and len(set(digests)) == 1
    assert (out / "splat_6.ply").exists()
