"""Training-state checkpoint and resume of the port
(lichtfeld_studio_tpu_torch.train.checkpoint): k steps, save, m steps
against load + m steps, every tensor and the generator's state bit-equal;
peek_capacity; a generator of another device type is refused."""

import numpy as np
import pytest
import torch

from lichtfeld_studio_tpu_torch.ops.rasterize import rasterize
from lichtfeld_studio_tpu_torch.train import state as t_state
from lichtfeld_studio_tpu_torch.train.capacity import grow_capacity
from lichtfeld_studio_tpu_torch.train.checkpoint import (
    load_checkpoint,
    peek_capacity,
    save_checkpoint,
)
from lichtfeld_studio_tpu_torch.train.strategies.mcmc import MCMCConfig
from tests.torch_parity import random_scene

GROUPS = ("means", "sh0", "shN", "scaling", "rotation", "opacity")


def _setup(strategy, capacity=48):
    rng = np.random.default_rng(11)
    sd, cam = random_scene(rng, n=24, width=32, height=32)
    lrs = t_state.make_lrs(1.6e-3, 2.5e-3, 5e-3, 1e-3, 0.05, sd.scene_scale)
    cfg = t_state.TrainConfig(
        raster_mode="cuda", instance_cap=2048, lr_gamma=0.999, strategy=strategy,
        grad_threshold=1e-6, reset_every=4,
        mcmc=MCMCConfig(max_cap=capacity, start_refine=2, stop_refine=100, refine_every=3))
    params = cam.device_params()
    with torch.no_grad():
        target = rasterize(sd, params, torch.zeros(3), mode="cuda", instance_cap=2048,
                           inference=True).image.clone()

    def fresh():
        sd2, _ = random_scene(np.random.default_rng(11), n=24, width=32, height=32)
        return grow_capacity(t_state.init_train_state(sd2, lrs, seed=0), capacity)

    def steps(state, first, last):
        for i in range(first, last):
            state, _ = t_state.train_step(state, params, target, torch.zeros(3), cfg,
                                          t_state.step_flags(cfg, i + 1))
        return state

    return fresh, steps


def _tensors(state):
    out = {f"param.{k}": getattr(state.splats, k).detach() for k in GROUPS}
    for field in ("exp_avg", "exp_avg_sq", "step_count", "lr"):
        out.update({f"adam.{field}.{k}": v for k, v in getattr(state.adam, field).items()})
    out.update(n_active=state.splats.n_active, active_sh_degree=state.splats.active_sh_degree,
               binoms=state.binoms, densify_count=state.densify_count,
               densify_grad=state.densify_grad, generator=state.generator.get_state())
    return out


@pytest.mark.parametrize("strategy", ["mcmc", "default"])
def test_resume_is_bit_exact(tmp_path, strategy):
    fresh, steps = _setup(strategy)
    live = steps(fresh(), 0, 5)  # crosses a refine step (iteration 3)
    save_checkpoint(live, tmp_path / "state_5")
    assert (tmp_path / "state_5").is_dir()
    restored = load_checkpoint(tmp_path / "state_5", fresh())
    assert restored.iteration == live.iteration == 5
    for name, want in _tensors(live).items():
        assert torch.equal(_tensors(restored)[name], want), name
    assert restored.splats.scene_scale == live.splats.scene_scale
    assert restored.splats.max_sh_degree == live.splats.max_sh_degree
    # m more steps, live against restored: refine (6), reset (8) and noise draws
    live, restored = steps(live, 5, 9), steps(restored, 5, 9)
    for name, want in _tensors(live).items():
        assert torch.equal(_tensors(restored)[name], want), name
    assert all(torch.isfinite(p).all() for p in restored.splats.parameters())


def test_peek_capacity_and_capacity_mismatch(tmp_path):
    fresh, steps = _setup("mcmc", capacity=96)
    state = steps(fresh(), 0, 2)
    save_checkpoint(state, tmp_path / "snap")
    assert peek_capacity(tmp_path / "snap") == 96
    assert peek_capacity(tmp_path / "nothing_here") is None
    small, _ = _setup("mcmc", capacity=48)
    with pytest.raises(ValueError, match="capacity"):
        load_checkpoint(tmp_path / "snap", small())


def test_generator_of_another_device_is_refused(tmp_path):
    fresh, steps = _setup("mcmc")
    state = steps(fresh(), 0, 1)
    save_checkpoint(state, tmp_path / "snap")
    payload = torch.load(tmp_path / "snap" / "state.pt", weights_only=True)
    payload["generator_device"] = "cuda"  # as a snapshot written on a GPU says
    torch.save(payload, tmp_path / "snap" / "state.pt")
    with pytest.raises(ValueError, match="cuda generator"):
        load_checkpoint(tmp_path / "snap", fresh())
