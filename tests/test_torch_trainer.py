"""The port's Trainer (lichtfeld_studio_tpu_torch.train.trainer) end to end
on the CPU device: the products of Trainer.setup against the JAX package's,
a 30-iteration run through its artifacts, the flags that must reach the
step and the evaluator, growth of the instance buffer and of the gaussian
capacity, resume, events, and the live-control polling."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lichtfeld_studio_tpu.cli import parse_args_and_params as j_parse
from lichtfeld_studio_tpu.io.ply import write_ply as j_write_ply
from lichtfeld_studio_tpu.ops.rasterize import rasterize as j_rasterize
from lichtfeld_studio_tpu.train.trainer import Trainer as JTrainer
from lichtfeld_studio_tpu_torch import cli as t_cli
from lichtfeld_studio_tpu_torch.core import events
from lichtfeld_studio_tpu_torch.core.project import Project
from lichtfeld_studio_tpu_torch.io.ply import read_ply
from lichtfeld_studio_tpu_torch.ops.rasterize import apply_render_mode, rasterize
from lichtfeld_studio_tpu_torch.render import headless
from lichtfeld_studio_tpu_torch.train.state import step_flags
from lichtfeld_studio_tpu_torch.train.trainer import Trainer
from tests.scene_utils import make_camera, make_random_splats
from tests.test_trainer_e2e import _make_dataset
from tests.torch_parity import np_, to_torch_params, to_torch_splats

GROUPS = ("means", "sh0", "shN", "scaling", "rotation", "opacity")
BASE = ["--headless", "--max-cap", "4096", "--instance-cap", "16384", "--num-workers", "1"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A 6-view 48x32 transforms.json dataset and a warm-start PLY (the
    ground truth with slightly perturbed means)."""
    root = tmp_path_factory.mktemp("trainer_scene")
    rng = np.random.default_rng(42)
    gt = _make_dataset(rng, root / "scene")
    noisy = gt.replace_trainable({
        **gt.trainable_dict(),
        "means": gt.means + 0.01 * jnp.asarray(rng.normal(0, 1, gt.means.shape).astype(np.float32))})
    j_write_ply(noisy.to_point_cloud(), root / "init.ply")
    return root


def _argv(scene, out, *extra, iterations=4, init=True):
    return ["-d", str(scene / "scene"), "-o", str(out), "--iterations", str(iterations), *BASE,
            *(["--init-ply", str(scene / "init.ply")] if init else []), *extra]


def _setup(scene, out, *extra, **kw):
    return Trainer.setup(t_cli.parse_args_and_params(_argv(scene, out, *extra, **kw)), "cpu")


def test_trainer_end_to_end(scene, tmp_path):
    """test_trainer_e2e.py: warm start from --init-ply, 30 iterations,
    refine at 10 and 20, eval and save at 30."""
    out = tmp_path / "out"
    t = _setup(scene, out, "--eval", "--test-every", "3", "--eval-steps", "30", "--save-steps", "30",
               "--start-refine", "5", "--stop-refine", "25", "--refine-every", "10",
               "--sh-degree", "2", iterations=30)
    n0 = int(t.state.splats.n_active)
    stats = t.train()
    assert np.isfinite(stats["final_loss"]) and np.isfinite(stats["losses"]).all()
    assert stats["num_gaussians"] > n0  # MCMC grew at 10 and 20
    pc = read_ply(out / "splat_30.ply")
    assert pc.size == stats["num_gaussians"]
    rows = (out / "metrics.csv").read_text().strip().splitlines()
    assert len(rows) == 2  # header + one eval
    psnr = float(rows[-1].split(",")[1])
    assert np.isfinite(psnr) and psnr > 15.0, psnr
    assert (out / "report.txt").exists() and (out / "project.lfs").exists()
    assert t.state.iteration == 30 and t.last_progress[0] == 30


@pytest.mark.parametrize("extra,init", [
    ((), True), (("--eval", "--test-every", "3", "--strategy", "default", "--gut"), True),
    ((), False)], ids=["init_ply", "init_ply_eval_adc_gut", "sfm_cloud"])
def test_setup_products_match_jax(scene, tmp_path, extra, init):
    """Capacity, LRs, every TrainConfig field the two packages share, the
    split sizes and the initial splats (1e-6), for a warm start and for the
    loader's point cloud (kNN scales on the host in both)."""
    argv = _argv(scene, tmp_path / "t", *extra, init=init)
    t = Trainer.setup(t_cli.parse_args_and_params(argv), "cpu")
    j = JTrainer.setup(j_parse([a if a != str(tmp_path / "t") else str(tmp_path / "j")
                                for a in argv]))
    assert t.state.splats.capacity == j.state.splats.capacity
    assert (len(t.train_set), len(t.val_set)) == (len(j.train_set), len(j.val_set))
    for k in GROUPS:
        np.testing.assert_allclose(float(t.state.adam.lr[k]), float(j.state.adam.lr[k]), rtol=1e-7)
        np.testing.assert_allclose(np_(getattr(t.state.splats, k)),
                                   np.asarray(getattr(j.state.splats, k)), rtol=1e-6, atol=1e-6)
    assert int(t.state.splats.n_active) == int(j.state.splats.n_active)
    assert int(t.state.splats.active_sh_degree) == int(j.state.splats.active_sh_degree)
    np.testing.assert_allclose(t.state.splats.scene_scale, j.state.splats.scene_scale, rtol=1e-6)
    got, want = dataclasses.asdict(t.cfg), dataclasses.asdict(j.cfg)
    shared = (set(got) & set(want)) - {"raster_mode"}
    assert {"iterations", "strategy", "projection", "antialiasing", "gut_exact", "instance_cap",
            "tile_size", "mcmc", "lr_gamma", "grad_threshold", "reset_every"} <= shared
    for k in shared:
        assert got[k] == want[k], k
    assert t.cfg.raster_mode == "cuda"
    assert (t.evaluator is None) == (j.evaluator is None)
    if t.evaluator is not None:
        assert t.evaluator.instance_cap == j.evaluator.instance_cap
        assert t.evaluator.projection == j.evaluator.projection == "ut"


def test_random_init_setup(scene, tmp_path):
    t = _setup(scene, tmp_path / "o", "--random", "--init-num-pts", "500", init=False)
    assert int(t.state.splats.n_active) == 500 and t.state.splats.capacity == 4096
    assert t.cfg.mcmc.max_cap == 4096 and t.state.splats.max_sh_degree == 3


# --- every parsed flag must change behaviour (tests/test_flags_wiring.py) ---

def test_gut_forces_ut_projection(scene, tmp_path):
    assert _setup(scene, tmp_path / "a").cfg.projection == "auto"
    assert _setup(scene, tmp_path / "b", "--gut").cfg.projection == "ut"
    t = _setup(scene, tmp_path / "c", "--gut-exact")
    assert t.cfg.projection == "ut" and t.cfg.gut_exact


def test_antialiasing_changes_opacity(rng):
    """Mip-Splatting compensation scales opacity by the det ratio
    (reference rasterizer.cpp:52,181); equal to the JAX package's render
    (2e-3: its dense per-tile blend against the port's plain P2)."""
    splats = make_random_splats(rng, n=32)
    cam = make_camera().device_params()
    sd, params = to_torch_splats(splats), to_torch_params(cam)
    kw = dict(mode="cuda", instance_cap=4096, tile_size=16)
    with torch.no_grad():
        plain = rasterize(sd, params, torch.zeros(3), **kw)
        aa = rasterize(sd, params, torch.zeros(3), antialiasing=True, **kw)
        aa_ut = rasterize(sd, params, torch.zeros(3), antialiasing=True, projection="ut", **kw)
        ut = rasterize(sd, params, torch.zeros(3), projection="ut", **kw)
    assert float((plain.image - aa.image).abs().max()) > 1e-4, "antialiasing had no effect"
    # compensation can only dim (det ratio <= 1): alpha never increases
    assert float((aa.alpha - plain.alpha).max()) <= 1e-6
    assert float((ut.image - aa_ut.image).abs().max()) > 1e-4
    assert float((aa_ut.alpha - ut.alpha).max()) <= 1e-6
    for proj, got in (("auto", aa), ("ut", aa_ut)):
        want = j_rasterize(splats, cam, jnp.zeros(3), mode="tiles", instance_cap=4096, k_max=64,
                           antialiasing=True, projection=proj)
        np.testing.assert_allclose(np_(got.image), np.asarray(want.image), atol=2e-3)


def test_gut_antialiasing_trains_finite(scene, tmp_path, capsys):
    """--gut --antialiasing over dead slots (capacity 4096, 48 live): the
    compensation's sqrt has a zero gradient at 0, so no NaN reaches Adam
    (the JAX package's UT path turns non-finite there)."""
    t = _setup(scene, tmp_path / "o", "--gut", "--antialiasing", iterations=3)
    stats = t.train()
    assert "[health]" not in capsys.readouterr().out
    assert np.isfinite(stats["losses"]).all()
    assert all(torch.isfinite(p).all() for p in t.state.splats.parameters())


def test_antialiasing_flag_reaches_cfg(scene, tmp_path):
    t = _setup(scene, tmp_path / "o", "--antialiasing", "--eval", "--test-every", "3")
    assert t.cfg.antialiasing is True and t.evaluator.antialiasing is True
    assert _setup(scene, tmp_path / "p").cfg.antialiasing is False


def test_render_modes(rng):
    """apply_render_mode's shapes and semantics (rasterizer.cpp:364-394)."""
    sd = to_torch_splats(make_random_splats(rng, n=32))
    with torch.no_grad():
        out = rasterize(sd, to_torch_params(make_camera().device_params()), torch.zeros(3),
                        mode="cuda", instance_cap=4096, with_depth=True, inference=True)
    h, w = out.image.shape[:2]
    shapes = {"RGB": 3, "D": 1, "ED": 1, "RGB_D": 4, "RGB_ED": 4}
    for mode, ch in shapes.items():
        assert apply_render_mode(out, mode).shape == (h, w, ch)
    d, ed = apply_render_mode(out, "D")[..., 0], apply_render_mode(out, "ED")[..., 0]
    # expected depth = accumulated / alpha >= accumulated where alpha <= 1
    assert float(torch.where(out.alpha > 0.3, ed - d, 0.0).min()) >= -1e-4


def test_render_mode_reaches_evaluator(scene, tmp_path):
    t = _setup(scene, tmp_path / "o", "--eval", "--test-every", "3", "--render-mode", "RGB_D")
    assert t.evaluator is not None and t.evaluator.render_mode == "RGB_D"


def test_sh_degree_interval_flag(scene, tmp_path):
    t = _setup(scene, tmp_path / "o", "--sh-degree-interval", "7")
    assert t.cfg.mcmc.sh_degree_interval == 7
    assert step_flags(t.cfg, 7).sh_step and not step_flags(t.cfg, 6).sh_step


def test_save_depth_flag_dumps_depth(scene, tmp_path):
    t = _setup(scene, tmp_path / "a", "--eval", "--test-every", "3", "--eval-steps", "2",
               "--save-depth")
    assert t.evaluator.save_depth is True
    t.evaluator.evaluate(t.state.splats, 2)
    assert list((tmp_path / "a" / "eval_step_2").glob("*_depth.png")), "no depth dumps written"
    t2 = _setup(scene, tmp_path / "b", "--eval", "--test-every", "3", "--eval-steps", "2")
    t2.evaluator.evaluate(t2.state.splats, 2)
    assert not list((tmp_path / "b" / "eval_step_2").glob("*_depth.png"))


def test_project_lfs_created_and_registers_plys(scene, tmp_path):
    t = _setup(scene, tmp_path / "o", "--save-steps", "2")
    assert t.project.path.exists(), "project .lfs not created at setup"
    t.train()
    plys = Project.load(t.project.path).plys()
    assert {r.iteration for r in plys} == {2, 4}
    assert (tmp_path / "o" / "splat_2.ply").exists() and (tmp_path / "o" / "splat_4.ply").exists()


def test_save_state_and_resume(scene, tmp_path, capsys):
    """--save-state-every and --resume: the second trainer continues from
    iteration 4 to 6 with the first's tensors; a snapshot of a grown
    capacity makes the resuming trainer grow first; shrinking is refused."""
    t = _setup(scene, tmp_path / "a", "--save-state-every", "2")
    t.train()
    snap = tmp_path / "a" / "state_4"
    assert snap.exists(), "periodic state snapshot missing"
    t2 = _setup(scene, tmp_path / "b", "--resume", str(snap), iterations=6)
    assert "[resume] restored iteration 4" in capsys.readouterr().out
    assert t2.state.iteration == 4
    for k in GROUPS:
        assert torch.equal(t2.state.splats.get_parameter(k), t.state.splats.get_parameter(k)), k
        assert torch.equal(t2.state.adam.exp_avg[k], t.state.adam.exp_avg[k]), k
    stats = t2.train()
    assert t2.state.iteration == 6 and (tmp_path / "b" / "splat_6.ply").exists()
    assert stats["iters_per_s"] > 0 and len(stats["losses"]) == 2
    # a snapshot at twice the capacity: the template grows before it restores
    t._set_capacity(8192)
    t.save_state(99)
    t3 = _setup(scene, tmp_path / "c")
    assert t3.state.splats.capacity == 4096
    t3.restore(str(tmp_path / "a" / "state_99"))
    assert t3.state.splats.capacity == 8192 == t3.cfg.mcmc.max_cap
    assert t3.state.adam.exp_avg["shN"].shape[0] == 8192
    with pytest.raises(ValueError, match="shrinking"):
        t.restore(str(snap))


def test_events_emitted_during_training(scene, tmp_path):
    got = {"progress": [], "saved": 0, "done": 0, "eval": 0}
    bus = events.bus()
    handlers = [
        (events.TrainingProgress, bus.when(events.TrainingProgress,
                                           lambda e: got["progress"].append(e.iteration))),
        (events.CheckpointSaved, bus.when(
            events.CheckpointSaved, lambda e: got.__setitem__("saved", got["saved"] + 1))),
        (events.TrainingCompleted, bus.when(
            events.TrainingCompleted, lambda e: got.__setitem__("done", got["done"] + 1))),
        (events.EvaluationCompleted, bus.when(
            events.EvaluationCompleted, lambda e: got.__setitem__("eval", got["eval"] + 1))),
    ]
    try:
        t = _setup(scene, tmp_path / "o", "--eval", "--test-every", "3", "--eval-steps", "1002",
                   "1004", "--dispatch-steps", "2", iterations=1004)
        t.state.iteration = 1000  # past the shN freeze, whose steps run one a dispatch
        seen = []
        t.progress_callback = lambda it, loss, n: seen.append((it, loss, n))
        t.train()
    finally:
        for kind, h in handlers:
            bus.off(kind, h)
    # dispatches of 2 between the boundaries 1002 and 1004
    assert got["progress"] == [1002, 1004] == [s[0] for s in seen]
    assert got["saved"] == 1 and got["done"] == 1 and got["eval"] == 2
    assert all(np.isfinite(s[1]) for s in seen)


def test_viewer_cli_corrupt_splat_clean_error(tmp_path, capsys):
    """A corrupt -v file gives a diagnostic and exit 2, not a traceback
    (test_flags_wiring.py:230; the .html export of the JAX package's test is
    not ported, so the render goes to a .png)."""
    png = str(tmp_path / "x.png")
    bad = tmp_path / "bad.ply"
    bad.write_bytes(b"not a ply at all")
    assert t_cli.main(["-v", str(bad), "--render-output", png]) == 2
    assert "could not load splat file" in capsys.readouterr().err
    assert t_cli.main(["-v", str(tmp_path / "missing.ply"), "--render-output", png]) == 2
    assert "not found" in capsys.readouterr().err
    # a header without end_header must error out, not spin on EOF
    trunc = tmp_path / "trunc.ply"
    trunc.write_bytes(b"ply\nformat binary_little_endian 1.0\n")
    assert t_cli.main(["-v", str(trunc), "--render-output", png]) == 2
    assert "truncated PLY header" in capsys.readouterr().err


def test_instance_cap_grows_at_the_jax_threshold(scene, tmp_path, capsys):
    """> 85 % of the instance buffer: x1.25 or 1.15 x the count, 128-aligned,
    capped by --instance-cap (trainer.py:411-434 of the JAX package)."""
    t = _setup(scene, tmp_path / "o", iterations=1)
    with torch.no_grad():
        n_inst = int(rasterize(t.state.splats, t.train_set[0].device_params("cpu"), torch.zeros(3),
                               mode="cuda", tile_size=t.cfg.tile_size, instance_cap=16384,
                               inference=True).n_instances)
    small = int(n_inst / 0.9)  # crowded: count > 0.85 * cap
    assert n_inst > 0.85 * small
    t.cfg = dataclasses.replace(t.cfg, instance_cap=small)
    t.train()
    grown = t.cfg.instance_cap
    assert "[instance-cap]" in capsys.readouterr().out
    need = max(int(small * 1.25), int(n_inst * 1.15))
    assert grown == min(-(-need // 128) * 128, 16384) > small
    # roomy: no growth
    t2 = _setup(scene, tmp_path / "p", iterations=1)
    t2.train()
    assert t2.cfg.instance_cap == 16384 and "[instance-cap]" not in capsys.readouterr().out


def test_capacity_grows_x2_at_85_percent(scene, tmp_path, capsys):
    """More than 85 % of the bucket live and the bucket below --max-cap: the
    state is padded to twice the bucket and cfg.mcmc.max_cap follows
    (trainer.py:436-455 of the JAX package)."""
    t = _setup(scene, tmp_path / "o", iterations=2)
    n = int(t.state.splats.n_active)
    # rebuild the state in a snug bucket below max_cap
    sd = t.state.splats
    from lichtfeld_studio_tpu_torch.core.splat_data import SplatData
    from lichtfeld_studio_tpu_torch.train.state import init_train_state, make_lrs

    bucket = n + 4
    snug = SplatData.from_arrays(*(np_(getattr(sd, k))[:n] for k in GROUPS), capacity=bucket,
                                 scene_scale=sd.scene_scale)
    opt = t.params.optimization
    t.state = init_train_state(snug, make_lrs(opt.means_lr, opt.shs_lr, opt.scaling_lr,
                                              opt.rotation_lr, opt.opacity_lr, sd.scene_scale))
    t.cfg = dataclasses.replace(t.cfg, mcmc=dataclasses.replace(t.cfg.mcmc, max_cap=bucket))
    assert n > 0.85 * bucket and bucket < opt.max_cap
    t.train()
    assert "[capacity]" in capsys.readouterr().out
    assert t.state.splats.capacity == 2 * bucket == t.cfg.mcmc.max_cap
    assert t.state.densify_count.shape[0] == 2 * bucket
    assert all(torch.isfinite(p).all() for p in t.state.splats.parameters())


class _StubControl:
    """The live-control surface the trainer polls: stops the run after
    `stop_after` dispatches and asks for one save on the first."""

    def __init__(self, stop_after):
        self.paused, self.stop_requested = False, False
        self.stop_after, self.polls, self._save = stop_after, 0, True

    def run_pending(self, trainer):
        self.polls += 1
        if trainer.training_active and self.polls >= self.stop_after:
            self.stop_requested = True

    def consume_save_request(self):
        save, self._save = self._save, False
        return save


def test_control_stops_the_run_and_the_ply_carries_the_real_iteration(scene, tmp_path, capsys):
    t = _setup(scene, tmp_path / "o", "--eval", "--test-every", "3", iterations=20)
    t.control = _StubControl(stop_after=3)
    stopped = []
    h = events.bus().when(events.TrainingStopped, lambda e: stopped.append(e.iteration))
    try:
        stats = t.train()
    finally:
        events.bus().off(events.TrainingStopped, h)
    assert stopped == [3] and "[control] stop requested at iter 3" in capsys.readouterr().out
    out = tmp_path / "o"
    assert (out / "splat_3.ply").exists() and not (out / "splat_20.ply").exists()
    assert (out / "splat_1.ply").exists()  # the save request of the first poll
    assert t.state.iteration == 3 and not t.training_active
    assert stats["iters_per_s"] > 0 and len(stats["losses"]) == 3
    assert t.control.polls == 4  # three dispatches and the drain after the loop


@pytest.mark.parametrize("extra", [
    ("--strategy", "default", "--grad-threshold", "1e-6", "--reset-every", "8"),
    ("--gut-exact", "--antialiasing"),
    ("--timelapse-images", "r_1.png", "--timelapse-every", "3", "--dispatch-steps", "4"),
], ids=["adc", "gut_exact_antialiasing", "timelapse"])
def test_other_configurations_train(scene, tmp_path, extra):
    """--strategy default (refine at 5, an opacity reset at 8), --gut-exact
    with --antialiasing, and timelapse frames, 10 iterations each."""
    t = _setup(scene, tmp_path / "o", *extra, "--start-refine", "2", "--stop-refine", "9",
               "--refine-every", "5", iterations=10)
    n0 = int(t.state.splats.n_active)
    stats = t.train()
    assert np.isfinite(stats["losses"]).all() and len(stats["losses"]) >= 3
    assert (tmp_path / "o" / "splat_10.ply").exists()
    if "default" in extra:
        assert stats["num_gaussians"] != n0  # ADC grew or pruned at 5
    if "--timelapse-images" in extra:
        frames = sorted(p.name for p in (tmp_path / "o" / "timelapse" / "r_1").iterdir())
        assert frames == ["000003.png", "000006.png", "000009.png"]


def test_cli_trains_on_the_device_it_is_given(scene, tmp_path, monkeypatch, capsys):
    """main(argv) end to end, the CPU asked for by the test."""
    monkeypatch.setattr(headless, "default_device", lambda: torch.device("cpu"))
    rc = t_cli.main(_argv(scene, tmp_path / "o", "--eval", "--test-every", "3", "--eval-steps", "4"))
    out = capsys.readouterr().out
    assert rc == 0 and "done:" in out and "[eval] iter 4" in out and "[health]" not in out
    assert (tmp_path / "o" / "splat_4.ply").exists() and (tmp_path / "o" / "metrics.csv").exists()
