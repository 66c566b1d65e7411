"""The training components inside the port's train step (pose
optimisation, bilateral grid, background modulation, ADMM sparsity): the
two integration tests of tests/test_components_train.py on the port, and
one compute_grads + apply_update per configuration against the JAX
package on a 32x32 pinhole camera, the JAX state carried across by
to_torch_train_state and both packages' random draws injected; then a
checkpoint round trip and a capacity growth with the components' state.

Tolerances: loss within 1e-5 relative; every gradient (splat groups, pose,
grids) within 1e-4 of its group's largest (the port's plain P2/P3/P4 on
the CPU against the JAX package's float32 dense "tiles" blend); after
apply_update fed the JAX package's gradients, parameters, moments, LRs and
duals within 1e-5 relative (1e-7 absolute). The exact path with a pose
gradient (both packages' dense route, a pinhole camera below k_max): image
within 1e-5, pose gradient within 1e-3 of its largest.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lichtfeld_studio_tpu.train import state as j_state
from lichtfeld_studio_tpu.train.components import sparsity as j_sp
from lichtfeld_studio_tpu.train.strategies.mcmc import MCMCConfig as JMCMCConfig
from lichtfeld_studio_tpu_torch.ops.rasterize import rasterize as t_rasterize
from lichtfeld_studio_tpu_torch.train import state as t_state
from lichtfeld_studio_tpu_torch.train.capacity import grow_capacity
from lichtfeld_studio_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from lichtfeld_studio_tpu_torch.train.strategies.mcmc import MCMCConfig as TMCMCConfig
from tests.scene_utils import make_camera, make_random_splats
from tests.torch_parity import (
    flat_aux,
    np_,
    to_torch_camera,
    to_torch_splats,
    to_torch_train_state,
)

GROUPS = ("means", "sh0", "shN", "scaling", "rotation", "opacity")
CAP, N = 48, 24
LRS = (1.6e-3, 2.5e-3, 5e-3, 1e-3, 0.05)
NO_REFINE = dict(max_cap=CAP, start_refine=10**9, stop_refine=10**9 + 1)

CONFIGS = {
    # name: (TrainConfig fields, iteration of the state, dual fixture)
    "pose_bilateral_bg": (dict(pose_mode="direct", use_bilateral_grid=True, tv_loss_weight=1.0,
                               bg_modulation=True, iterations=100), 30, False),
    "pose_mlp": (dict(pose_mode="mlp"), 0, False),
    "bilateral_odd_dims": (dict(use_bilateral_grid=True, bilateral_dims=(5, 7, 3)), 0, False),
    "sparsity_init": (dict(enable_sparsity=True, iterations=100, sparsify_steps=60,
                           sparsity_rho=1e-2), 40, False),
    "sparsity_update": (dict(enable_sparsity=True, iterations=100, sparsify_steps=60,
                             sparsity_rho=1e-2), 49, True),
}


def _scene():
    """Splats, camera 1 of 3 and a target: the splats' own render mixed
    with noise, so that no residual of the L1 term sits at 0, where its
    sign (and the gradient) would be rounding noise."""
    rng = np.random.default_rng(0)
    splats = make_random_splats(rng, n=N, capacity=CAP)
    cam = make_camera(32, 32)
    cam.uid = 1
    with torch.no_grad():
        render = t_rasterize(to_torch_splats(splats), to_torch_camera(cam).device_params(),
                             torch.zeros(3), mode="cuda", instance_cap=2048).image
    noise = rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)
    return splats, cam, (0.7 * np_(render) + 0.3 * noise).astype(np.float32)


def _configs(fields):
    common = dict(instance_cap=2048, lr_gamma=1.0, **fields)
    return (j_state.TrainConfig(raster_mode="tiles", k_max=64, mcmc=JMCMCConfig(**NO_REFINE),
                                **common),
            t_state.TrainConfig(raster_mode="cuda", mcmc=TMCMCConfig(**NO_REFINE), **common))


def _jax_state(splats, cfg_j, iteration, duals):
    lrs = j_state.make_lrs(*LRS, splats.scene_scale)
    st = j_state.init_train_state(splats, lrs, cfg=cfg_j, num_cameras=3, seed=0)
    rng = np.random.default_rng(3)
    aux = st.aux_params
    if "pose" in aux:  # off the identity, on every camera (the mlp's output layer too)
        pose = aux["pose"]
        aux = {**aux, "pose": {**pose, **{k: jnp.asarray(
            rng.normal(0, 0.02, pose[k].shape).astype(np.float32))
            for k in ("embeddings", "w_out") if k in pose}}}
    if "bilateral" in aux:
        aux = {**aux, "bilateral": aux["bilateral"] + jnp.asarray(
            rng.normal(0, 0.02, aux["bilateral"].shape).astype(np.float32))}
    st = dataclasses.replace(st, aux_params=aux, iteration=jnp.asarray(iteration, jnp.int32))
    if duals:
        admm = j_sp.init_admm(splats.opacity, splats.active_mask(), splats.n_active,
                              cfg_j.sparsity_prune_ratio)
        u = jnp.where(splats.active_mask(), jnp.asarray(
            rng.normal(0, 0.05, CAP).astype(np.float32)), 0.0)
        st = dataclasses.replace(st, admm_u=u, admm_z=admm.z)
    return st


def _draws(state_j):
    """The JAX package's random draws of one step: the background jitter
    (compute_grads) and MCMC's (apply_update)."""
    _, sub = jax.random.split(state_j.key)
    k_rel, k_add, k_noise = jax.random.split(sub, 3)
    mcmc = {"relocate": jax.random.uniform(k_rel, (CAP,)),
            "add": jax.random.uniform(k_add, (CAP,)),
            "noise": jax.random.normal(k_noise, (CAP, 3))}
    bg = jax.random.uniform(jax.random.fold_in(state_j.key, 17), (3,))
    return ({"bg": torch.from_numpy(np.array(bg))},
            {k: torch.from_numpy(np.array(v)) for k, v in mcmc.items()})


def _close_to_largest(got, want, rel, what):
    got, want = np_(got), np.asarray(want)
    assert np.isfinite(got).all(), what
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= rel * scale + 1e-12, (
        what, np.abs(got - want).max() / max(scale, 1e-30))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_step_matches_jax(name):
    fields, iteration, duals = CONFIGS[name]
    splats, cam, target = _scene()
    cfg_j, cfg = _configs(fields)
    state_j = _jax_state(splats, cfg_j, iteration, duals)
    flags_j = j_state.step_flags(cfg_j, iteration + 1)
    flags = t_state.step_flags(cfg, iteration + 1)
    assert dataclasses.asdict(flags) == dataclasses.asdict(flags_j)
    if name.startswith("sparsity"):
        assert flags.sparsity_phase and (flags.admm_update if duals else flags.admm_init)
    compute = jax.jit(j_state.compute_grads, static_argnames=("cfg", "flags"))
    loss_j, out_j, grads_j = compute(state_j, cam.device_params(), jnp.asarray(target),
                                     jnp.zeros(3), cfg=cfg_j, flags=flags_j)

    draws_bg, draws_mcmc = _draws(state_j)
    state = to_torch_train_state(state_j)
    params = to_torch_camera(cam).device_params()
    loss, out, grads = t_state.compute_grads(state, params, torch.from_numpy(target),
                                             torch.zeros(3), cfg, flags, draws=draws_bg)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    for k in GROUPS:
        _close_to_largest(grads[k], grads_j[k], 1e-4, k)
    aux_j = flat_aux(grads_j.get("_aux", {}))
    aux_t = grads.get("_aux", {})
    assert sorted(aux_t) == sorted(aux_j) == sorted(state.aux_params)
    for k, g in aux_t.items():
        assert float(np.abs(np.asarray(aux_j[k])).max()) > 0, k
        _close_to_largest(g, aux_j[k], 1e-4, k)

    # apply_update on the JAX package's gradients and draws
    new_j, _ = jax.jit(j_state.apply_update, static_argnames=("cfg", "flags"))(
        state_j, grads_j, cfg=cfg_j, loss=loss_j, out=out_j, flags=flags_j)
    state = to_torch_train_state(state_j)
    out = t_rasterize(state.splats, params, torch.zeros(3), mode="cuda", tile_size=32,
                      instance_cap=2048, inference=True)
    grads_t = {k: torch.from_numpy(np.array(v)) for k, v in grads_j.items() if k in GROUPS}
    grads_t["_aux"] = {k: torch.from_numpy(np.array(v)) for k, v in aux_j.items()}
    state, _ = t_state.apply_update(state, grads_t, cfg, torch.tensor(float(loss_j)), out, flags,
                                    draws=draws_mcmc)
    tol = dict(rtol=1e-5, atol=1e-7)
    assert state.iteration == int(new_j.iteration) == iteration + 1
    for k in GROUPS:
        np.testing.assert_allclose(np_(getattr(state.splats, k)),
                                   np.asarray(getattr(new_j.splats, k)), **tol, err_msg=k)
    want_aux = flat_aux(new_j.aux_params)
    want_m, want_v = flat_aux(new_j.aux_adam.exp_avg), flat_aux(new_j.aux_adam.exp_avg_sq)
    for k, v in state.aux_params.items():
        np.testing.assert_allclose(np_(v), np.asarray(want_aux[k]), **tol, err_msg=k)
        np.testing.assert_allclose(np_(state.aux_adam.exp_avg[k]), np.asarray(want_m[k]), **tol)
        np.testing.assert_allclose(np_(state.aux_adam.exp_avg_sq[k]), np.asarray(want_v[k]),
                                   **tol)
        group = k.split(".")[0]
        np.testing.assert_allclose(float(state.aux_adam.lr[k]),
                                   float(new_j.aux_adam.lr[group]), rtol=1e-6, err_msg=k)
        assert int(state.aux_adam.step_count[k]) == int(new_j.aux_adam.step_count[group])
    np.testing.assert_allclose(np_(state.admm_u), np.asarray(new_j.admm_u), rtol=2.4e-7, atol=1e-7)
    np.testing.assert_allclose(np_(state.admm_z), np.asarray(new_j.admm_z), rtol=2.4e-7, atol=1e-7)
    if flags.admm_init or flags.admm_update:
        assert (np_(state.admm_z)[:N] == 0).sum() == int(np.float32(0.6) * np.float32(N))


def test_exact_path_pose_gradient_matches_jax_dense():
    """gut_exact with pose optimisation: both packages take the dense route
    (cam_grad), on a pinhole camera below k_max, where the JAX package's
    ray table and camera are right."""
    splats, cam, target = _scene()
    cfg_j, cfg = _configs(dict(pose_mode="direct", projection="ut", gut_exact=True))
    state_j = _jax_state(splats, cfg_j, 0, False)
    flags_j = j_state.step_flags(cfg_j, 1)
    loss_j, out_j, grads_j = jax.jit(j_state.compute_grads, static_argnames=("cfg", "flags"))(
        state_j, cam.device_params(), jnp.asarray(target), jnp.zeros(3), cfg=cfg_j,
        flags=flags_j)
    state = to_torch_train_state(state_j)
    loss, out, grads = t_state.compute_grads(state, to_torch_camera(cam).device_params(),
                                             torch.from_numpy(target), torch.zeros(3), cfg,
                                             t_state.step_flags(cfg, 1))
    assert float(out.alpha.max()) > 0.1, "fixture: nothing rendered"
    np.testing.assert_allclose(np_(out.image), np.asarray(out_j.image), atol=1e-5)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    want = np.asarray(grads_j["_aux"]["pose"]["embeddings"])
    assert np.abs(want[1]).max() > 0 and not want[[0, 2]].any()
    _close_to_largest(grads["_aux"]["pose.embeddings"], want, 1e-3, "pose")


def _train(cfg, state, params, target, steps):
    losses = []
    for i in range(steps):
        state, m = t_state.train_step(state, params, target, torch.zeros(3), cfg,
                                      t_state.step_flags(cfg, state.iteration + 1))
        losses.append(float(m["loss"]))
    return state, losses


def _port_state(cfg):
    splats, cam, target = _scene()
    state = t_state.init_train_state(to_torch_splats(splats),
                                     t_state.make_lrs(*LRS, splats.scene_scale), cfg=cfg,
                                     num_cameras=3, seed=0)
    return state, to_torch_camera(cam).device_params(), torch.from_numpy(target)


def test_train_step_with_pose_and_bilateral():
    """tests/test_components_train.py: 12 steps with pose, grid and
    background modulation; camera 1's embedding and grid move, the others
    stay."""
    _, cfg = _configs(dict(pose_mode="direct", use_bilateral_grid=True, tv_loss_weight=1.0,
                           bg_modulation=True))
    state, params, target = _port_state(cfg)
    assert {"pose.embeddings", "bilateral"} == set(state.aux_params)
    state, losses = _train(cfg, state, params, target, 12)
    assert np.isfinite(losses).all()
    emb = np_(state.aux_params["pose.embeddings"])
    assert np.abs(emb[1]).sum() > 0 and np.abs(emb[[0, 2]]).sum() == 0
    grids = np_(state.aux_params["bilateral"])
    eye = np_(t_state.identity_grids(3))
    assert np.abs(grids[1] - eye[1]).sum() > 0 and np.array_equal(grids[[0, 2]], eye[[0, 2]])
    assert float(state.aux_adam.lr["bilateral"]) > 0


def test_train_step_sparsity_phase():
    """tests/test_components_train.py: 20 steps, the ADMM phase from 11."""
    _, cfg = _configs(dict(iterations=20, enable_sparsity=True, sparsify_steps=10,
                           sparsity_rho=1e-3, sparsity_prune_ratio=0.5))
    assert cfg.base_iterations == 10
    state, params, target = _port_state(cfg)
    for i in range(20):
        fl = t_state.step_flags(cfg, i + 1)
        if i + 1 == 11:
            assert fl.admm_init and fl.sparsity_phase
        state, m = t_state.train_step(state, params, target, torch.zeros(3), cfg, fl)
        assert np.isfinite(float(m["loss"]))
    assert (np_(state.admm_z[:N]) == 0).sum() >= 10


def test_zero_pose_renders_the_unposed_fisheye_camera():
    """At zero pose parameters the posed camera renders what the camera
    itself renders, for a fisheye camera too: the model, distortion and
    shutter stay (the JAX package renders a pinhole there)."""
    from tests.gut_cases import FISHEYE_RADIAL
    from lichtfeld_studio_tpu_torch.core.camera import CameraModelType

    splats, cam, _ = _scene()
    _, cfg = _configs(dict(pose_mode="direct"))
    state, params, _ = _port_state(cfg)
    fisheye = dataclasses.replace(params, camera_model=CameraModelType.OPENCV_FISHEYE,
                                  radial=torch.from_numpy(FISHEYE_RADIAL.copy()))
    posed = t_state.posed_camera(fisheye, cfg, {"embeddings": state.aux_params["pose.embeddings"]})
    assert posed.camera_model == CameraModelType.OPENCV_FISHEYE and posed.radial is fisheye.radial
    with torch.no_grad():
        a = t_rasterize(state.splats, fisheye, torch.zeros(3), mode="cuda", instance_cap=2048)
        b = t_rasterize(state.splats, posed, torch.zeros(3), mode="cuda", instance_cap=2048)
        pin = t_rasterize(state.splats, params, torch.zeros(3), mode="cuda", instance_cap=2048)
    assert float(a.alpha.max()) > 0.1
    np.testing.assert_allclose(np_(b.image), np_(a.image), atol=1e-6)
    assert np.abs(np_(a.image) - np_(pin.image)).max() > 1e-2  # the model matters here


def _sparsity_state():
    _, cfg = _configs(dict(pose_mode="mlp", use_bilateral_grid=True, bg_modulation=True,
                           enable_sparsity=True, iterations=6, sparsify_steps=3))
    state, params, target = _port_state(cfg)
    state, _ = _train(cfg, state, params, target, 4)  # ADMM init at 4
    assert state.admm_z.any() and state.aux_adam.step_count["pose.w0"] == 4
    return cfg, state


def test_checkpoint_round_trip_with_components(tmp_path):
    """The snapshot restores the components' parameters, their Adam state
    and the ADMM duals with the same bits."""
    cfg, state = _sparsity_state()
    save_checkpoint(state, tmp_path / "s")
    template, _, _ = _port_state(cfg)
    back = load_checkpoint(tmp_path / "s", template)
    assert back.iteration == state.iteration == 4
    for a, b in ((back.aux_params, state.aux_params), (back.aux_adam.exp_avg, state.aux_adam.exp_avg),
                 (back.aux_adam.exp_avg_sq, state.aux_adam.exp_avg_sq),
                 (back.aux_adam.step_count, state.aux_adam.step_count),
                 (back.aux_adam.lr, state.aux_adam.lr)):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(back.admm_u, state.admm_u) and torch.equal(back.admm_z, state.admm_z)
    _, other = _configs(dict(pose_mode="direct"))
    with pytest.raises(ValueError, match="components"):
        load_checkpoint(tmp_path / "s", _port_state(other)[0])


def test_grow_capacity_pads_the_duals():
    _, state = _sparsity_state()
    u, z = state.admm_u.clone(), state.admm_z.clone()
    state = grow_capacity(state, 2 * CAP)
    assert state.admm_u.shape == state.admm_z.shape == (2 * CAP,)
    assert torch.equal(state.admm_u[:CAP], u) and torch.equal(state.admm_z[:CAP], z)
    assert not state.admm_u[CAP:].any() and not state.admm_z[CAP:].any()
