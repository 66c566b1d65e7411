"""The port's configuration layer and command line against the JAX
package's: parse_args_and_params of both on the same argv lists gives equal
TrainingParameters, field by field; a flag whose feature is not ported
exits 2 naming its ROADMAP item, and the viewer flags run (items 8 and
10); each training component's flag trains; training, rendering and the
live viewer without a GPU exit 1."""

import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from lichtfeld_studio_tpu import cli as j_cli
from lichtfeld_studio_tpu.config import parameters as j_params
from lichtfeld_studio_tpu_torch import cli as t_cli
from lichtfeld_studio_tpu_torch.config import parameters as t_params
from lichtfeld_studio_tpu_torch.render import headless
from lichtfeld_studio_tpu_torch.tools.selfcheck_train import train_argv
from tests.test_trainer_e2e import _make_dataset
from tests.torch_parity import params_via_json

# the verify skill's training line
VERIFY = ["-d", "scene", "-o", "out", "--headless", "--eval", "--test-every", "8",
          "--iterations", "40", "--eval-steps", "40", "--save-steps", "40", "--max-cap", "200000",
          "--instance-cap", "2097152", "--start-refine", "10", "--stop-refine", "35",
          "--refine-every", "10", "--random", "--init-num-pts", "20000"]

ARGVS = {
    "defaults": ["-d", "scene"],
    "verify_skill_flow_1": VERIFY,
    "selfcheck_mcmc": train_argv("scene", "out", 2000, "mcmc"),
    "selfcheck_default": train_argv("scene", "out", 2000, "default"),
    "steps_scaler": ["-d", "scene", "--steps-scaler", "0.25", "--eval-steps", "1000", "7000",
                     "--strategy", "default"],
    "adc_flags": ["-d", "s", "--strategy", "default", "--prune-opacity", "0.01", "--grow-scale3d",
                  "0.02", "--grow-scale2d", "0.06", "--prune-scale3d", "0.2", "--prune-scale2d",
                  "0.3", "--reset-every", "500", "--pause-refine-after-reset", "50",
                  "--revised-opacity", "--grad-threshold", "1e-4"],
    "render_and_gut": ["-d", "s", "--gut-exact", "--antialiasing", "--render-mode", "RGB_ED",
                       "--save-depth", "--timelapse-images", "a.png", "b.png",
                       "--timelapse-every", "7", "--resume", "out/state_40", "--init-ply", "x.ply",
                       "--save-state-every", "20", "-r", "2", "--max-width", "800",
                       "--project-path", "p.lfs", "--images", "images_2", "--sh-degree-interval",
                       "7", "--num-workers", "1", "--dispatch-steps", "4", "--skip-intermediate",
                       "--preload-to-ram", "--tv-loss-weight", "5", "--min-opacity", "0.01",
                       "--opacity-reg", "0.02", "--scale-reg", "0.03", "--init-extent", "2.5"],
    "viewer": ["-v", "a.ply", "--render-output", "x.png", "--render-size", "64", "48"],
    "not_ported_flags_parse": ["-d", "s", "--sog", "--sog-iterations", "3", "--sparsity",
                               "--sparsify-steps", "10", "--prune-ratio", "0.5", "--init-rho",
                               "1e-3", "--bilateral-grid", "--bilateral-grid-x", "4",
                               "--pose-optimization", "mlp", "--bg-modulation", "--devices", "4",
                               "--lpips-weights", "w.npz", "--live-viewer", "0"],
}


def _flat(params):
    return {**{f"dataset.{k}": v for k, v in dataclasses.asdict(params.dataset).items()},
            **{f"opt.{k}": v for k, v in dataclasses.asdict(params.optimization).items()},
            "ply_path": params.ply_path, "init_ply": params.init_ply, "resume": params.resume}


@pytest.mark.parametrize("name", list(ARGVS))
def test_parse_args_and_params_matches_jax(name):
    argv = [str(a) for a in ARGVS[name]]
    got, want = _flat(t_cli.parse_args_and_params(argv)), _flat(j_cli.parse_args_and_params(argv))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k


def test_config_json_and_presets_match_jax(tmp_path):
    cfg = {"iterations": 1234, "random": True, "skip_intermediate": True, "max_cap": 5000,
           "unknown_key": 1, "eval_steps": [10, 20]}
    path = tmp_path / "opt.json"
    path.write_text(json.dumps(cfg))
    argv = ["-d", "s", "--config", str(path), "--max-cap", "6000"]
    got, want = t_cli.parse_args_and_params(argv), j_cli.parse_args_and_params(argv)
    assert _flat(got) == _flat(want)
    assert got.optimization.iterations == 1234 and got.optimization.random_init
    assert got.optimization.max_cap == 6000  # the CLI overrides the JSON
    for strategy in ("mcmc", "default", "none_such"):
        assert dataclasses.asdict(t_params.preset_for_strategy(strategy)) == dataclasses.asdict(
            j_params.preset_for_strategy(strategy))
    scaled_t = t_params.apply_step_scaling(t_params.OptimizationParameters(steps_scaler=0.5))
    scaled_j = j_params.apply_step_scaling(j_params.OptimizationParameters(steps_scaler=0.5))
    assert dataclasses.asdict(scaled_t) == dataclasses.asdict(scaled_j)
    assert scaled_t.iterations == 15_000 and scaled_t.eval_steps == [3500, 15_000]
    # TrainingParameters cross between the packages as JSON, both ways
    there = params_via_json(want, t_params.TrainingParameters)
    back = params_via_json(there, j_params.TrainingParameters)
    assert _flat(there) == _flat(want) == _flat(back)
    t_params.save_training_parameters_to_json(got, tmp_path / "p.json")
    assert json.loads((tmp_path / "p.json").read_text()) == want.to_json()


NOT_PORTED = {
    "--sog": (["--sog", "--sog-iterations", "2"], "item 10"),
    "--devices": (["--devices", "2"], "item 9"),
    "--live-viewer": (["--live-viewer", "0"], "item 10"),
}


@pytest.mark.parametrize("flag", list(NOT_PORTED))
def test_flag_of_a_feature_not_ported_exits_2(flag, tiny_scene, tmp_path, monkeypatch, capsys):
    """The flags of this table exited 2 before their slice: --devices > 1
    still does, naming its ROADMAP item; --sog and --live-viewer are ported
    and train 2 iterations on the CPU (asked for by the test), --sog
    writing splat_2.sog, --live-viewer serving the run."""
    extra, item = NOT_PORTED[flag]
    out = tmp_path / "out"
    if flag == "--devices":
        assert t_cli.main(["-d", str(tmp_path), "-o", str(out), *extra]) == 2
        err = capsys.readouterr().err
        assert "not ported yet" in err and flag in err and f"ROADMAP queue 1, {item}" in err
        assert not out.exists()
        return
    monkeypatch.setattr(headless, "default_device", lambda: torch.device("cpu"))
    rc = t_cli.main(["-d", str(tiny_scene), "-o", str(out), "--iterations", "2", "--headless",
                     "--random", "--init-num-pts", "64", "--max-cap", "4096",
                     "--num-workers", "1", *extra])
    printed = capsys.readouterr().out
    assert rc == 0 and "done:" in printed
    assert (out / "splat_2.ply").exists() and (out / "viewer_live.html").exists()
    if flag == "--sog":
        from lichtfeld_studio_tpu_torch.io.sog import read_sog

        assert read_sog(out / "splat_2.sog").size == 64
    else:
        assert "[viewer] live training viewer at http://127.0.0.1:" in printed


COMPONENT_FLAGS = {
    "--sparsity": ["--sparsity", "--sparsify-steps", "1"],  # ADMM init at step 2, the prune
    "--pose-optimization": ["--pose-optimization", "direct"],
    "--pose-optimization-mlp": ["--pose-optimization", "mlp"],
    "--bilateral-grid": ["--bilateral-grid"],
    "--bg-modulation": ["--bg-modulation"],
    "all-four": ["--pose-optimization", "direct", "--bilateral-grid", "--bg-modulation",
                 "--sparsity", "--sparsify-steps", "1"],
}


@pytest.fixture(scope="module")
def tiny_scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("component_scene")
    _make_dataset(np.random.default_rng(3), root / "scene", n_views=3)
    return root / "scene"


@pytest.mark.parametrize("flag", list(COMPONENT_FLAGS))
def test_component_flag_trains(flag, tiny_scene, tmp_path, monkeypatch, capsys):
    """Each training component's flag, and all four together, through
    main(argv), 2 iterations on the CPU (asked for by the test)."""
    monkeypatch.setattr(headless, "default_device", lambda: torch.device("cpu"))
    out = tmp_path / "out"
    rc = t_cli.main(["-d", str(tiny_scene), "-o", str(out), "--iterations", "2", "--headless",
                     "--random", "--init-num-pts", "64", "--max-cap", "4096", "--num-workers", "1",
                     *COMPONENT_FLAGS[flag]])
    printed = capsys.readouterr().out
    assert rc == 0 and "done:" in printed and "[health]" not in printed
    assert (out / "splat_2.ply").exists()
    if "--sparsity" in COMPONENT_FLAGS[flag]:
        assert "[sparsity] pruned to 26 gaussians" in printed  # 64 - floor(0.6 * 64)


def _viewer_argv(argv, tmp_path, rng):
    """The argv with a.ply, b.ply and a.sog written into tmp_path, and a
    64x48 PNG output there unless the argv names one."""
    from lichtfeld_studio_tpu_torch.io.ply import write_ply
    from lichtfeld_studio_tpu_torch.io.sog import write_sog
    from tests.scene_utils import make_random_splats
    from tests.torch_parity import to_torch_splats

    pc = to_torch_splats(make_random_splats(rng, n=40)).to_point_cloud()
    write_ply(pc, tmp_path / "a.ply")
    write_ply(pc, tmp_path / "b.ply")
    write_sog(pc, tmp_path / "a.sog", kmeans_iterations=2, device="cpu")
    names = {"a.ply": tmp_path / "a.ply", "a.ply,b.ply": f"{tmp_path / 'a.ply'},{tmp_path / 'b.ply'}",
             "a.sog": tmp_path / "a.sog", "x.html": tmp_path / "x.html"}
    argv = [str(names.get(a, a)) for a in argv]
    if "-v" in argv and "--render-output" not in argv:
        argv += ["--render-output", str(tmp_path / "x.png"), "--render-size", "64", "48"]
    return argv


def _interrupt_the_lobby(monkeypatch):
    def interrupt(_seconds):
        raise KeyboardInterrupt

    monkeypatch.setattr(t_cli, "time", types.SimpleNamespace(sleep=interrupt))


@pytest.mark.parametrize("argv,item", [
    (["-v", "a.ply,b.ply"], "item 8"), (["-v", "a.sog"], "item 8"),
    (["-v", "a.ply", "--render-output", "x.html"], "item 10"),
    (["--live-viewer", "0"], "item 10"),  # the studio lobby
])
def test_viewer_features_not_ported_exit_2(argv, item, tmp_path, monkeypatch, capsys):
    """These exited 2 before items 8 and 10 were ported; now each runs on
    the CPU (asked for by the test): a two-model render, a .sog render, the
    HTML export and the studio lobby."""
    monkeypatch.setattr(headless, "default_device", lambda: torch.device("cpu"))
    _interrupt_the_lobby(monkeypatch)
    argv = _viewer_argv(argv, tmp_path, np.random.default_rng(4))
    assert t_cli.main(argv) == 0
    printed = capsys.readouterr()
    assert "not ported yet" not in printed.err
    if "x.html" in " ".join(argv):
        assert "interactive viewer written" in printed.out and (tmp_path / "x.html").exists()
    elif "-v" in argv:
        from lichtfeld_studio_tpu_torch.io.image import load_image

        img = load_image(str(tmp_path / "x.png"))
        assert img.shape[:2] == (48, 64) and img.std() > 0.01
    else:
        assert "studio session" in printed.out


@pytest.mark.parametrize("argv,rc", [
    (["-v", "a.ply,b.ply"], 1), (["-v", "a.sog"], 1),
    (["-v", "a.ply", "--render-output", "x.html"], 0),
    (["--live-viewer", "0"], 1), (["-d", "scene", "--live-viewer", "0"], 1),
    (["-d", "scene", "--sog"], 1),
], ids=["several-models", "sog-view", "html", "lobby", "live-viewer-run", "sog-train"])
def test_viewer_flag_needs_a_gpu_where_it_computes(argv, rc, tiny_scene, tmp_path, monkeypatch,
                                                   capsys):
    """Without a GPU every viewer flag that renders or trains exits 1 (no
    CPU fallback); the HTML export, host numpy, still runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _interrupt_the_lobby(monkeypatch)
    argv = [str(tiny_scene) if a == "scene" else a for a in argv]
    argv = _viewer_argv(argv, tmp_path, np.random.default_rng(5))
    assert t_cli.main([*argv, "-o", str(tmp_path / "out")]) == rc
    err = capsys.readouterr().err
    assert ("GPU" in err) == (rc == 1)
    assert not (tmp_path / "x.png").exists()


def test_training_needs_a_gpu_or_arguments(tmp_path, capsys, monkeypatch):
    assert t_cli.main([]) == 2
    assert "--data-path required" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:  # argparse refuses an unknown strategy
        t_cli.main(["-d", str(tmp_path), "--strategy", "bogus"])
    assert e.value.code == 2
    capsys.readouterr()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert t_cli.main(["-d", str(tmp_path), "-o", str(tmp_path / "out")]) == 1
    assert "GPU" in capsys.readouterr().err
    assert not (tmp_path / "out").exists()
