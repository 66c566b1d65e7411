"""Port parity for the --gut-exact MCMC train step (UT projection, the
per-pixel world ray table, the exact world-space blend with plain P5/P6 and
P4 on the CPU) against the JAX package, through an OpenCV-fisheye camera
with dead slots past the live prefix.

Tolerances: compute_grads against the JAX package's dense world blend
("tiles" mode, float32 colours): loss within 1e-5 relative, gradients
within 1e-3 of the largest per group (the stream form against the dense
form); apply_update fed the JAX package's gradients and random draws:
rtol 1e-5 (atol 1e-7), as tests/test_torch_train_step.py; the gut scene
through tools/scenes.py::train_briefly at a tiny size: finite, the loss
going down."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lichtfeld_studio_tpu.core.camera import CameraModelType, ShutterType
from lichtfeld_studio_tpu.train import state as j_state
from lichtfeld_studio_tpu.train.strategies.mcmc import MCMCConfig as JMCMCConfig
from lichtfeld_studio_tpu_torch.ops.rasterize import rasterize as t_rasterize
from lichtfeld_studio_tpu_torch.tools.scenes import gut_scene, inference_frame, train_briefly
from lichtfeld_studio_tpu_torch.train import state as t_state
from lichtfeld_studio_tpu_torch.train.strategies.mcmc import MCMCConfig as TMCMCConfig
from tests.gut_cases import FISHEYE_RADIAL
from tests.scene_utils import make_camera, make_random_splats
from tests.torch_parity import np_, to_torch_params, to_torch_splats

GROUPS = ("means", "sh0", "shN", "scaling", "rotation", "opacity")
CAP = 64
LRS = dict(zip(("opt_means_lr", "shs_lr", "scaling_lr", "rotation_lr", "opacity_lr"),
               (1.6e-3, 2.5e-3, 5e-3, 1e-3, 0.05)))
MCMC = dict(max_cap=CAP, start_refine=1, stop_refine=1000, refine_every=1)


def _scene():
    rng = np.random.default_rng(2)
    sd = make_random_splats(rng, n=48, capacity=CAP, spread=0.9)
    op = sd.opacity.at[:4].set(-15.0)  # dead: relocation targets
    sd = sd.replace_trainable({**sd.trainable_dict(), "opacity": op})
    sd = dataclasses.replace(sd, active_sh_degree=jnp.asarray(1, jnp.int32))
    gt = rng.uniform(0, 1, (32, 48, 3)).astype(np.float32)
    cam = make_camera(48, 32)
    cam.camera_model = CameraModelType.OPENCV_FISHEYE
    cam.radial_distortion = FISHEYE_RADIAL
    return sd, cam.device_params(), gt


def _configs():
    common = dict(lambda_dssim=0.2, tile_size=16, instance_cap=4096, lr_gamma=0.999,
                  projection="ut", gut_exact=True)
    return (j_state.TrainConfig(raster_mode="tiles", mcmc=JMCMCConfig(**MCMC), **common),
            t_state.TrainConfig(raster_mode="cuda", mcmc=TMCMCConfig(**MCMC), **common))


def _rolling(params):
    """`params` with a rolling shutter whose end-of-frame pose has moved."""
    w2c_end = np.asarray(params.w2c).copy()
    w2c_end[0, 3] += 0.1
    return dataclasses.replace(params, w2c_end=jnp.asarray(w2c_end),
                               shutter_type=ShutterType.ROLLING_TOP_TO_BOTTOM)


def _jax_step(sd, params, gt):
    """The JAX package's compute_grads on the scene through `params`."""
    cfg_j, _ = _configs()
    state = j_state.init_train_state(sd, j_state.make_lrs(**LRS, scene_scale=sd.scene_scale), seed=0)
    compute = jax.jit(j_state.compute_grads, static_argnames=("cfg",))
    loss, out, grads = compute(state, params, jnp.asarray(gt), jnp.zeros(3), cfg=cfg_j)
    return sd, params, gt, state, float(loss), out, {k: np.asarray(v) for k, v in grads.items()}


@pytest.fixture(scope="module")
def jax_step():
    return _jax_step(*_scene())


def _port_state(sd):
    return t_state.init_train_state(
        to_torch_splats(sd), t_state.make_lrs(**LRS, scene_scale=sd.scene_scale), seed=0)


@pytest.mark.parametrize("shutter", ["global", "rolling"])
def test_gut_compute_grads_matches_jax(jax_step, shutter):
    """Through a global shutter, and through a rolling shutter with its
    end-of-frame pose."""
    if shutter == "rolling":
        sd, params, gt = jax_step[:3]
        jax_step = _jax_step(sd, _rolling(params), gt)
    sd, params, gt, _, loss_j, out_j, grads_j = jax_step
    _, cfg = _configs()
    loss, out, grads = t_state.compute_grads(
        _port_state(sd), to_torch_params(params), torch.from_numpy(gt), torch.zeros(3), cfg)
    np.testing.assert_allclose(float(loss), loss_j, rtol=1e-5)
    assert int(out.n_instances) == int(out_j.n_instances)
    for k in GROUPS:
        g, ref = np_(grads[k]), grads_j[k]
        assert np.isfinite(g).all(), k  # dead and padded slots included
        assert np.abs(g - ref).max() <= 1e-3 * np.abs(ref).max(), k


def test_gut_apply_update_matches_jax(jax_step):
    """One refine step's MCMC relocation, growth, noise and Adam on the
    gut-exact step's gradients, with the JAX package's draws injected."""
    sd, params, gt, state_j, loss_j, out_j, grads_j = jax_step
    cfg_j, cfg = _configs()
    flags = dict(refine=True)
    new_j, metrics_j = j_state.apply_update(
        state_j, {k: jnp.asarray(v) for k, v in grads_j.items()}, cfg_j, jnp.asarray(loss_j),
        out_j, j_state.StepFlags(**flags))
    _, sub = jax.random.split(state_j.key)
    k_rel, k_add, k_noise = jax.random.split(sub, 3)
    draws = {"relocate": jax.random.uniform(k_rel, (CAP,)), "add": jax.random.uniform(k_add, (CAP,)),
             "noise": jax.random.normal(k_noise, (CAP, 3))}
    state = _port_state(sd)
    out = t_rasterize(state.splats, to_torch_params(params), torch.zeros(3), mode="cuda",
                      instance_cap=4096, projection="ut", gut_exact=True, inference=True)
    state, metrics = t_state.apply_update(
        state, {k: torch.tensor(v) for k, v in grads_j.items()}, cfg, torch.tensor(loss_j), out,
        t_state.StepFlags(**flags), draws={k: torch.tensor(np.asarray(v)) for k, v in draws.items()})
    tol = dict(rtol=1e-5, atol=1e-7)
    assert int(state.splats.n_active) == int(new_j.splats.n_active) > 48
    for k in GROUPS:
        np.testing.assert_allclose(np_(getattr(state.splats, k)), np.asarray(getattr(new_j.splats, k)),
                                   **tol, err_msg=k)
        np.testing.assert_allclose(np_(state.adam.exp_avg[k]), np.asarray(new_j.adam.exp_avg[k]),
                                   **tol, err_msg=k)
    assert int(metrics["n_nonfinite"]) == int(metrics_j["n_nonfinite"]) == 0


def test_train_briefly_gut_runs_small():
    """The gut scene through train_briefly at a tiny size: every step
    finite, the loss going down, growth on the refine step, a finite
    inference frame within the cap."""
    r = train_briefly("cpu", gut_scene, plain_steps=3, refine_steps=1, n0=300, cap=400, width=96,
                      height=64, instance_cap=8192)
    r.update(inference_frame(r))
    assert r["all_losses_finite"] and r["max_n_nonfinite"] == 0 and r["frame_finite"]
    assert r["loss_last"] < r["loss_first"]
    assert r["max_n_instances"] <= r["instance_cap"]
    assert r["frame_n_instances"] <= r["instance_cap"]
    assert r["n_active_after_refine"] > r["n_active_before_refine"] == 300
    assert r["inputs"][3].gut_exact
