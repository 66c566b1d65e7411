"""Port parity for the MCMC train step of lichtfeld_studio_tpu_torch.train
against the JAX package, on one small scene with dead slots past the live
prefix.

compute_grads and apply_update are compared SEPARATELY: at Adam's first
step m / sqrt(v) is +-1 wherever g != 0, so a gradient that differs only in
rounding near 0 moves a parameter by 2 lr, and parameters after a whole
step say little. Tolerances:
  * compute_grads (port "cuda" mode on the CPU: plain P2/P3/P4; JAX
    "tiles", its float32 dense per-tile blend, since the "pallas" mode's
    bf16 colours move the loss by ~4e-5 relative): loss rel 1e-5, grads
    rtol 2e-2 / atol 2e-5;
  * apply_update fed the JAX package's grads and random draws: params,
    moments and LRs rtol 1e-5 (atol 1e-7), step counts, n_active and the
    SH degree equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lichtfeld_studio_tpu.train import state as j_state
from lichtfeld_studio_tpu.train.strategies.mcmc import MCMCConfig as JMCMCConfig
from lichtfeld_studio_tpu_torch.ops.rasterize import rasterize as t_rasterize
from lichtfeld_studio_tpu_torch.tools.scenes import train_briefly
from lichtfeld_studio_tpu_torch.train import state as t_state
from lichtfeld_studio_tpu_torch.train.strategies.mcmc import MCMCConfig as TMCMCConfig
from tests.scene_utils import make_camera, make_random_splats
from tests.torch_parity import np_, to_torch_camera, to_torch_splats

GROUPS = ("means", "sh0", "shN", "scaling", "rotation", "opacity")
CAP = 64
LRS = dict(zip(("opt_means_lr", "shs_lr", "scaling_lr", "rotation_lr", "opacity_lr"),
               (1.6e-3, 2.5e-3, 5e-3, 1e-3, 0.05)))
MCMC = dict(max_cap=CAP, start_refine=1, stop_refine=1000, refine_every=1)


def _scene():
    rng = np.random.default_rng(0)
    sd = make_random_splats(rng, n=48, capacity=CAP, spread=0.9)
    op = sd.opacity.at[:4].set(-15.0)  # dead: relocation targets
    sd = sd.replace_trainable({**sd.trainable_dict(), "opacity": op})
    sd = dataclasses.replace(sd, active_sh_degree=jnp.asarray(1, jnp.int32))  # room for sh_step
    gt = rng.uniform(0, 1, (32, 48, 3)).astype(np.float32)
    return sd, make_camera(48, 32), gt


def _configs():
    common = dict(lambda_dssim=0.2, tile_size=32, instance_cap=4096, lr_gamma=0.999)
    return (j_state.TrainConfig(raster_mode="tiles", mcmc=JMCMCConfig(**MCMC), **common),
            t_state.TrainConfig(raster_mode="cuda", mcmc=TMCMCConfig(**MCMC), **common))


@pytest.fixture(scope="module")
def jax_step():
    """The JAX package's compute_grads on the scene."""
    sd, cam, gt = _scene()
    cfg_j, _ = _configs()
    state = j_state.init_train_state(sd, j_state.make_lrs(**LRS, scene_scale=sd.scene_scale), seed=0)
    compute = jax.jit(j_state.compute_grads, static_argnames=("cfg",))
    loss, out, grads = compute(state, cam.device_params(), jnp.asarray(gt), jnp.zeros(3), cfg=cfg_j)
    return sd, cam, gt, state, float(loss), out, {k: np.asarray(v) for k, v in grads.items()}


def _port_state(sd):
    return t_state.init_train_state(
        to_torch_splats(sd), t_state.make_lrs(**LRS, scene_scale=sd.scene_scale), seed=0)


def test_compute_grads_matches_jax(jax_step):
    sd, cam, gt, _, loss_j, out_j, grads_j = jax_step
    _, cfg = _configs()
    state = _port_state(sd)
    loss, out, grads = t_state.compute_grads(
        state, to_torch_camera(cam).device_params(), torch.from_numpy(gt), torch.zeros(3), cfg)
    np.testing.assert_allclose(float(loss), loss_j, rtol=1e-5)
    assert int(out.n_instances) == int(out_j.n_instances)
    for k in GROUPS:
        g = np_(grads[k])
        assert np.isfinite(g).all(), k  # dead and padded slots included
        np.testing.assert_allclose(g, grads_j[k], rtol=2e-2, atol=2e-5, err_msg=k)


def test_compute_grads_matches_jax_with_the_tail_trim():
    """compute_grads where the backward's tail trim engages, at the default
    eps (1/255) of both packages: the JAX package's "pallas" mode, the one
    that trims, against the port's "cuda" mode. The scene is the JAX
    package's trim scene (test_pallas_blend.py::
    test_grad_skip_eps_trim_bound: 512 faint spheres far wider than the
    image); the one above keeps every window (48 gaussians, one window a
    tile). Tolerances: loss rel 1e-4 (bf16 colours on the JAX side); grads
    rtol 2e-2 and atol 5e-3 of the group's largest JAX gradient (that
    rounding, 2^-9 of a colour, summed over the image) plus 1e-6 (the
    rotation is rounding noise on spheres); the gaussians with a zero
    mean, SH0 and SH-rest gradient are the same on both sides, and there
    are some."""
    from lichtfeld_studio_tpu.kernels import blend_pallas
    from lichtfeld_studio_tpu_torch.kernels import blend as kblend

    assert blend_pallas.GRAD_SKIP_EPS == kblend.GRAD_SKIP_EPS == 1.0 / 255.0
    rng = np.random.default_rng(0)
    sd = make_random_splats(rng, n=512, spread=0.05, opacity_range=(0.045, 0.055))
    sd = sd.replace_trainable({**sd.trainable_dict(),
                               "scaling": jnp.full_like(sd.scaling, np.log(5.0))})
    cam, gt = make_camera(32, 32), rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)
    cfg_j, cfg_t = _configs()
    cfg_j = dataclasses.replace(cfg_j, raster_mode="pallas")
    state = j_state.init_train_state(sd, j_state.make_lrs(**LRS, scene_scale=sd.scene_scale), seed=0)
    compute = jax.jit(j_state.compute_grads, static_argnames=("cfg",))
    loss_j, _, grads_j = compute(state, cam.device_params(), jnp.asarray(gt), jnp.zeros(3),
                                 cfg=cfg_j)
    loss, _, grads = t_state.compute_grads(
        _port_state(sd), to_torch_camera(cam).device_params(), torch.from_numpy(gt),
        torch.zeros(3), cfg_t)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-4)
    for k in GROUPS:
        g, g_j = np_(grads[k]), np.asarray(grads_j[k])
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(g, g_j, rtol=2e-2, atol=5e-3 * np.abs(g_j).max() + 1e-6,
                                   err_msg=k)
        if k in ("means", "sh0", "shN"):  # MCMC's regularisers reach every scale and opacity
            zero, zero_j = ~g.reshape(len(g), -1).any(1), ~g_j.reshape(len(g_j), -1).any(1)
            assert (zero == zero_j).all() and zero.any(), k


@pytest.mark.parametrize("flags", [
    dict(), dict(refine=True), dict(sh_step=True, shn_frozen=True),
], ids=["plain", "refine", "sh_step_shn_frozen"])
def test_apply_update_matches_jax(jax_step, flags):
    sd, cam, gt, state_j, loss_j, out_j, grads_j = jax_step
    cfg_j, cfg = _configs()
    new_j, metrics_j = j_state.apply_update(
        state_j, {k: jnp.asarray(v) for k, v in grads_j.items()}, cfg_j, jnp.asarray(loss_j),
        out_j, j_state.StepFlags(**flags))
    # the draws apply_update takes from its key, in the JAX package's splits
    _, sub = jax.random.split(state_j.key)
    k_rel, k_add, k_noise = jax.random.split(sub, 3)
    draws = {"relocate": jax.random.uniform(k_rel, (CAP,)), "add": jax.random.uniform(k_add, (CAP,)),
             "noise": jax.random.normal(k_noise, (CAP, 3))}
    state = _port_state(sd)
    out = t_rasterize(state.splats, to_torch_camera(cam).device_params(), torch.zeros(3),
                      mode="cuda", tile_size=32, instance_cap=4096, inference=True)
    state, metrics = t_state.apply_update(
        state, {k: torch.tensor(v) for k, v in grads_j.items()}, cfg, torch.tensor(loss_j),
        out, t_state.StepFlags(**flags),
        draws={k: torch.from_numpy(np.asarray(v)) for k, v in draws.items()})
    tol = dict(rtol=1e-5, atol=1e-7)
    s, sj = state.splats, new_j.splats
    assert int(s.n_active) == int(sj.n_active) == int(metrics_j["n_active"])
    assert int(s.active_sh_degree) == int(sj.active_sh_degree)
    assert state.iteration == int(new_j.iteration) == 1
    for k in GROUPS:
        np.testing.assert_allclose(np_(getattr(s, k)), np.asarray(getattr(sj, k)), **tol, err_msg=k)
        np.testing.assert_allclose(np_(state.adam.exp_avg[k]), np.asarray(new_j.adam.exp_avg[k]),
                                   **tol, err_msg=k)
        np.testing.assert_allclose(np_(state.adam.exp_avg_sq[k]),
                                   np.asarray(new_j.adam.exp_avg_sq[k]), **tol, err_msg=k)
        assert int(state.adam.step_count[k]) == int(new_j.adam.step_count[k]), k
        np.testing.assert_allclose(float(state.adam.lr[k]), float(new_j.adam.lr[k]), rtol=1e-7)
    assert int(metrics["n_nonfinite"]) == int(metrics_j["n_nonfinite"]) == 0
    if flags.get("refine"):
        assert int(s.n_active) > 48


def test_step_flags_match_jax():
    cfg_j, cfg = _configs()
    cfg_j = dataclasses.replace(cfg_j, mcmc=JMCMCConfig(max_cap=CAP))
    cfg = dataclasses.replace(cfg, mcmc=TMCMCConfig(max_cap=CAP))
    for it in (1, 99, 500, 600, 999, 1000, 1001, 1100, 25_000, 25_100):
        want = dataclasses.asdict(j_state.step_flags(cfg_j, it))
        got = dataclasses.asdict(t_state.step_flags(cfg, it))
        assert got == {k: want[k] for k in got}, it


def test_features_not_ported_raise():
    """The four training components are ported: their configurations
    build, and step_flags agrees with the JAX package's, the sparsity
    phase and its ADMM steps included, for both strategies. An unknown
    strategy or pose mode still raises."""
    for kw in (dict(pose_mode="direct"), dict(pose_mode="mlp"), dict(use_bilateral_grid=True),
               dict(bg_modulation=True),
               dict(enable_sparsity=True, iterations=3000, sparsify_steps=1200)):
        for strategy in ("mcmc", "default"):
            mcmc = dict(max_cap=CAP, start_refine=500, stop_refine=2500, refine_every=100)
            cfg = t_state.TrainConfig(strategy=strategy, mcmc=TMCMCConfig(**mcmc), **kw)
            cfg_j = j_state.TrainConfig(strategy=strategy, mcmc=JMCMCConfig(**mcmc), **kw)
            assert cfg.base_iterations == cfg_j.base_iterations
            for it in (1, 600, 1000, 1800, 1801, 1850, 1900, 2000, 2400, 3000):
                assert (dataclasses.asdict(t_state.step_flags(cfg, it))
                        == dataclasses.asdict(j_state.step_flags(cfg_j, it))), (kw, strategy, it)
    flags = t_state.step_flags(cfg, 1801)
    assert flags.sparsity_phase and flags.admm_init and not flags.refine
    assert t_state.step_flags(cfg, 1850).admm_update
    with pytest.raises(ValueError, match="unknown strategy"):
        t_state.TrainConfig(strategy="bogus")
    with pytest.raises(ValueError, match="pose optimization mode"):
        t_state.TrainConfig(pose_mode="bogus")


def test_training_lowers_the_loss():
    """30 port steps toward a target rendered from the unperturbed scene
    (as test_train_smoke.py): the loss falls by 10% or more."""
    sd, cam, _ = _scene()
    tcam = to_torch_camera(cam).device_params()
    gt_sd = to_torch_splats(sd)
    with torch.no_grad():
        gt = t_rasterize(gt_sd, tcam, torch.zeros(3), mode="oracle").image
    rng = np.random.default_rng(1)
    noisy = sd.means + 0.03 * jnp.asarray(rng.normal(0, 1, sd.means.shape).astype(np.float32))
    state = _port_state(sd.replace_trainable({**sd.trainable_dict(), "means": noisy}))
    _, cfg = _configs()
    cfg = dataclasses.replace(cfg, scale_reg=0.0, opacity_reg=0.0, lr_gamma=1.0,
                              mcmc=TMCMCConfig(max_cap=CAP, start_refine=10, stop_refine=25,
                                               refine_every=10))
    losses = []
    for it in range(1, 31):
        state, m = t_state.train_step(state, tcam, gt, torch.zeros(3), cfg,
                                      t_state.step_flags(cfg, it))
        losses.append(float(m["loss"]))
        assert int(m["n_nonfinite"]) == 0
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.9 * losses[0], (losses[0], losses[-1])
    assert int(state.splats.n_active) > 48  # refines at 10 and 20


def test_train_briefly_runs_small():
    """tools/scenes.py's train scene through train_briefly at a tiny size:
    every step healthy, growth on the refines."""
    r = train_briefly("cpu", plain_steps=6, refine_steps=2, n0=300, cap=400, width=96, height=64,
                      instance_cap=8192)
    assert r["steps"] == 8 and r["all_losses_finite"] and r["max_n_nonfinite"] == 0
    assert r["max_n_instances"] <= r["instance_cap"]
    assert r["n_active_after_refine"] > r["n_active_before_refine"] == 300
    assert r["state"].iteration == 8 and r["inputs"][0].width == 96
