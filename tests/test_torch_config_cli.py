"""The port's configuration layer and command line against the JAX
package's: parse_args_and_params of both on the same argv lists gives equal
TrainingParameters, field by field; a flag whose feature is not ported
exits 2 naming its ROADMAP item; training without a GPU exits 1."""

import dataclasses
import json

import pytest
import torch

from lichtfeld_studio_tpu import cli as j_cli
from lichtfeld_studio_tpu.config import parameters as j_params
from lichtfeld_studio_tpu_torch import cli as t_cli
from lichtfeld_studio_tpu_torch.config import parameters as t_params
from lichtfeld_studio_tpu_torch.tools.selfcheck_train import train_argv
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
    "--sog": (["--sog"], "item 10"),
    "--sparsity": (["--sparsity"], "item 6"),
    "--pose-optimization": (["--pose-optimization", "direct"], "item 6"),
    "--bilateral-grid": (["--bilateral-grid"], "item 6"),
    "--bg-modulation": (["--bg-modulation"], "item 6"),
    "--devices": (["--devices", "2"], "item 9"),
    "--live-viewer": (["--live-viewer", "0"], "item 10"),
}


@pytest.mark.parametrize("flag", list(NOT_PORTED))
def test_flag_of_a_feature_not_ported_exits_2(flag, tmp_path, capsys):
    extra, item = NOT_PORTED[flag]
    assert t_cli.main(["-d", str(tmp_path), "-o", str(tmp_path / "out"), *extra]) == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and flag in err and f"ROADMAP queue 1, {item}" in err
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("argv,item", [
    (["-v", "a.ply,b.ply"], "item 8"), (["-v", "a.sog"], "item 8"),
    (["-v", "a.ply", "--render-output", "x.html"], "item 10"),
    (["--live-viewer", "0"], "item 10"),  # the studio lobby
])
def test_viewer_features_not_ported_exit_2(argv, item, capsys):
    assert t_cli.main(argv) == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and f"ROADMAP queue 1, {item}" in err


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
