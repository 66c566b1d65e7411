"""Port parity for lichtfeld_studio_tpu_torch.train.capacity against the JAX
package: the first bucket, growth leaf by leaf (bit for bit), the render
unchanged by growth (bit for bit), and densification in the bigger bucket."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lichtfeld_studio_tpu.train import capacity as j_cap
from lichtfeld_studio_tpu.train import state as j_state
from lichtfeld_studio_tpu_torch.ops.rasterize import rasterize
from lichtfeld_studio_tpu_torch.train import capacity as t_cap
from lichtfeld_studio_tpu_torch.train import state as t_state
from lichtfeld_studio_tpu_torch.train.strategies.mcmc import MCMCConfig
from tests.scene_utils import make_camera, make_random_splats
from tests.torch_parity import np_, to_torch_camera, to_torch_splats, to_torch_train_state

GROUPS = ("means", "sh0", "shN", "scaling", "rotation", "opacity")


@pytest.mark.parametrize("n,max_cap", [(30_000, 1_000_000), (600_000, 1_000_000), (10, 1_000_000),
                                       (20_000, 200_000), (70_000, 100_000)])
def test_initial_capacity_matches_jax(n, max_cap):
    assert t_cap.initial_capacity(n, max_cap) == j_cap.initial_capacity(n, max_cap)


def test_initial_capacity_buckets():
    assert t_cap.initial_capacity(30_000, 1_000_000) == 65536  # 2x headroom, power of two
    assert t_cap.initial_capacity(600_000, 1_000_000) == 1_000_000  # clamped
    assert t_cap.initial_capacity(10, 1_000_000) == 2**15  # floor


def test_grow_matches_jax_leaf_by_leaf(rng):
    splats = make_random_splats(rng, n=24, capacity=32)
    lrs = j_state.make_lrs(1.6e-3, 2.5e-3, 5e-3, 1e-3, 0.05, splats.scene_scale)
    state_j = j_state.init_train_state(splats, lrs, seed=0)
    moments = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32))
               for k, v in state_j.adam.exp_avg.items()}
    state_j = dataclasses.replace(
        state_j, adam=dataclasses.replace(state_j.adam, exp_avg=moments, exp_avg_sq=moments),
        densify_count=jnp.arange(32, dtype=jnp.float32), densify_grad=jnp.ones(32))
    state = to_torch_train_state(state_j)
    old_params = list(state.splats.parameters())
    grown_j = j_cap.grow_capacity(state_j, 64)
    grown = t_cap.grow_capacity(state, 64)
    assert grown.splats.capacity == 64 and int(grown.splats.n_active) == 24
    for k in GROUPS:
        np.testing.assert_array_equal(np_(getattr(grown.splats, k)),
                                      np.asarray(getattr(grown_j.splats, k)), err_msg=k)
        np.testing.assert_array_equal(np_(grown.adam.exp_avg[k]),
                                      np.asarray(grown_j.adam.exp_avg[k]), err_msg=k)
        np.testing.assert_array_equal(np_(grown.adam.exp_avg_sq[k]),
                                      np.asarray(grown_j.adam.exp_avg_sq[k]), err_msg=k)
        assert getattr(grown.splats, k).requires_grad
    np.testing.assert_array_equal(np_(grown.densify_count), np.asarray(grown_j.densify_count))
    np.testing.assert_array_equal(np_(grown.densify_grad), np.asarray(grown_j.densify_grad))
    assert all(p.shape[0] == 64 for p in grown.splats.parameters())
    assert not any(p is q for p in grown.splats.parameters() for q in old_params)
    # growing to the same or a smaller capacity changes nothing
    assert t_cap.grow_capacity(grown, 64) is grown and grown.splats.capacity == 64


def test_grow_preserves_state_and_render(rng):
    """test_capacity.py:25: four refining steps, grow 32 -> 64: the state's
    prefix and the render are unchanged bit for bit, and densification goes
    on in the bigger bucket."""
    sd = to_torch_splats(make_random_splats(rng, n=24, capacity=32))
    params = to_torch_camera(make_camera(32, 32)).device_params()
    bg = torch.zeros(3)
    cfg = t_state.TrainConfig(
        raster_mode="cuda", instance_cap=2048, lr_gamma=1.0,
        mcmc=MCMCConfig(max_cap=32, start_refine=1, stop_refine=100, refine_every=2))
    state = t_state.init_train_state(
        sd, t_state.make_lrs(1.6e-3, 2.5e-3, 5e-3, 1e-3, 0.05, sd.scene_scale), seed=0)
    kw = dict(mode="cuda", instance_cap=2048, inference=True)
    with torch.no_grad():
        target = rasterize(sd, params, bg, **kw).image.clone()
    for i in range(4):
        state, _ = t_state.train_step(state, params, target, bg, cfg, t_state.step_flags(cfg, i + 1))
    with torch.no_grad():
        before = rasterize(state.splats, params, bg, **kw).image.clone()
    means, m_means, n = state.splats.means.detach().clone(), state.adam.exp_avg["means"].clone(), \
        int(state.splats.n_active)
    grown = t_cap.grow_capacity(state, 64)
    assert grown.splats.capacity == 64 and int(grown.splats.n_active) == n
    assert torch.equal(grown.splats.means[:32], means)
    assert torch.equal(grown.adam.exp_avg["means"][:32], m_means)
    with torch.no_grad():
        after = rasterize(grown.splats, params, bg, **kw).image
    assert torch.equal(after, before)
    cfg2 = dataclasses.replace(cfg, mcmc=dataclasses.replace(cfg.mcmc, max_cap=64))
    for i in range(4, 8):
        grown, _ = t_state.train_step(grown, params, target, bg, cfg2,
                                      t_state.step_flags(cfg2, i + 1))
    assert int(grown.splats.n_active) > n
    assert all(torch.isfinite(p).all() for p in grown.splats.parameters())
