"""Port parity for the train-step ops: SSIM and the photometric loss, the
scale and opacity regs, Adam, and the MCMC ops and strategy, against the
JAX package on the same numpy inputs. Random draws are JAX's own (from the
key splits the JAX functions use), handed to the port as tensors.
Tolerances: masks and counts exactly equal; floats rtol 1e-5 (atol 1e-7
where values cross zero)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lichtfeld_studio_tpu.ops import adam as j_adam
from lichtfeld_studio_tpu.ops import losses as j_losses
from lichtfeld_studio_tpu.ops import mcmc_ops as j_mcmc_ops
from lichtfeld_studio_tpu.ops import ssim as j_ssim
from lichtfeld_studio_tpu.train.strategies import mcmc as j_mcmc
from lichtfeld_studio_tpu_torch.ops import adam as t_adam
from lichtfeld_studio_tpu_torch.ops import losses as t_losses
from lichtfeld_studio_tpu_torch.ops import mcmc_ops as t_mcmc_ops
from lichtfeld_studio_tpu_torch.ops import ssim as t_ssim
from lichtfeld_studio_tpu_torch.train.strategies import mcmc as t_mcmc
from tests.scene_utils import make_random_splats
from tests.torch_parity import np_, to_torch_splats

TOL = dict(rtol=1e-5, atol=1e-7)
GROUPS = ("means", "sh0", "shN", "scaling", "rotation", "opacity")


def _t(x):
    return torch.from_numpy(np.array(x))


def _images(seed=0, h=40, w=52):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


def test_ssim_psnr_and_photometric_loss_match_jax():
    a, b = _images()
    np.testing.assert_allclose(float(t_ssim.ssim(_t(a), _t(b))), float(j_ssim.ssim(a, b)), **TOL)
    np.testing.assert_allclose(float(t_ssim.psnr(_t(a), _t(b))), float(j_ssim.psnr(a, b)), **TOL)
    g_j = jax.grad(lambda x: j_losses.photometric_loss(x, jnp.asarray(b), 0.2))(jnp.asarray(a))
    x = _t(a).requires_grad_(True)
    loss = t_losses.photometric_loss(x, _t(b), 0.2)
    (g_t,) = torch.autograd.grad(loss, x)
    np.testing.assert_allclose(float(loss.detach()), float(j_losses.photometric_loss(a, b, 0.2)), **TOL)
    np.testing.assert_allclose(np_(g_t), np.asarray(g_j), rtol=1e-5, atol=1e-9)


def test_regs_match_jax(rng):
    sd = make_random_splats(rng, n=30, capacity=40)
    ts = to_torch_splats(sd)
    for name, j_fn, t_fn, group in (
        ("scale", j_losses.scale_reg_loss, t_losses.scale_reg_loss, "scaling"),
        ("opacity", j_losses.opacity_reg_loss, t_losses.opacity_reg_loss, "opacity"),
    ):
        def j_loss(p):
            return j_fn(sd.replace_trainable({**sd.trainable_dict(), group: p}), 0.01)

        g_j = jax.grad(j_loss)(getattr(sd, group))
        loss = t_fn(ts, 0.01)
        (g_t,) = torch.autograd.grad(loss, getattr(ts, group))
        np.testing.assert_allclose(float(loss.detach()), float(j_loss(getattr(sd, group))), **TOL, err_msg=name)
        np.testing.assert_allclose(np_(g_t), np.asarray(g_j), **TOL, err_msg=name)
        assert float(t_fn(ts, 0.0)) == 0.0


@pytest.mark.parametrize("skip", [(), ("shN",)])
def test_adam_three_steps_match_jax(rng, skip):
    shapes = {"means": (20, 3), "shN": (20, 15, 3), "opacity": (20, 1)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    lrs = {"means": 1e-2, "shN": 1e-3, "opacity": 5e-2}
    pj, sj = {k: jnp.asarray(v) for k, v in params.items()}, j_adam.init_adam(params, lrs)
    pt, st = {k: _t(v) for k, v in params.items()}, t_adam.init_adam({k: _t(v) for k, v in params.items()}, lrs)
    for step in range(3):
        grads = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        pj, sj = j_adam.adam_step(pj, grads, sj, static_skip=skip)
        pt, st = t_adam.adam_step(pt, {k: _t(v) for k, v in grads.items()}, st, static_skip=skip)
    sj, st = j_adam.scale_lrs(sj, 0.5, ("means",)), t_adam.scale_lrs(st, 0.5, ("means",))
    for k in shapes:
        np.testing.assert_allclose(np_(pt[k]), np.asarray(pj[k]), **TOL, err_msg=k)
        np.testing.assert_allclose(np_(st.exp_avg[k]), np.asarray(sj.exp_avg[k]), **TOL, err_msg=k)
        np.testing.assert_allclose(np_(st.exp_avg_sq[k]), np.asarray(sj.exp_avg_sq[k]), **TOL, err_msg=k)
        assert int(st.step_count[k]) == int(sj.step_count[k]) == 3
        np.testing.assert_allclose(float(st.lr[k]), float(sj.lr[k]), rtol=1e-7)
    if skip:
        np.testing.assert_array_equal(np_(pt["shN"]), params["shN"])


def test_relocation_and_multinomial_match_jax(rng):
    binoms_j = j_mcmc_ops.make_binoms()
    binoms_t = t_mcmc_ops.make_binoms()
    np.testing.assert_array_equal(np_(binoms_t), np.asarray(binoms_j))
    ops = rng.uniform(0.01, 0.99, 64).astype(np.float32)
    scales = rng.uniform(0.01, 1.0, (64, 3)).astype(np.float32)
    ratios = rng.integers(1, 60, 64).astype(np.int32)  # past n_max: clipped
    op_j, s_j = j_mcmc_ops.relocation(ops, scales, ratios, binoms_j)
    op_t, s_t = t_mcmc_ops.relocation(_t(ops), _t(scales), _t(ratios), binoms_t)
    np.testing.assert_allclose(np_(op_t), np.asarray(op_j), **TOL)
    np.testing.assert_allclose(np_(s_t), np.asarray(s_j), rtol=1e-5, atol=1e-6)

    probs = np.where(rng.uniform(size=300) < 0.3, 0.0, rng.uniform(size=300)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    idx_j = j_mcmc._sample_multinomial(key, jnp.asarray(probs), 500)
    u = jax.random.uniform(key, (500,))
    idx_t = t_mcmc._sample_multinomial(_t(u), _t(probs))
    np.testing.assert_array_equal(np_(idx_t), np.asarray(idx_j))
    assert np.all(probs[np_(idx_t)] > 0)


def _relocation_scene(rng):
    sd = make_random_splats(rng, n=40, capacity=64)
    op = sd.opacity.at[:6].set(-15.0)  # six dead gaussians
    rot = sd.rotation.at[7].set(0.0)  # one degenerate quaternion
    sd = sd.replace_trainable({**sd.trainable_dict(), "opacity": op, "rotation": rot})
    adam = j_adam.init_adam(sd.trainable_dict(), {k: 0.01 for k in GROUPS})
    # nonzero moments, so zeroing at the sources shows
    adam = dataclasses.replace(
        adam, exp_avg={k: jnp.ones_like(v) for k, v in adam.exp_avg.items()},
        exp_avg_sq={k: jnp.full_like(v, 2.0) for k, v in adam.exp_avg_sq.items()})
    t_state = t_adam.AdamState(
        {k: _t(v) for k, v in adam.exp_avg.items()}, {k: _t(v) for k, v in adam.exp_avg_sq.items()},
        {k: _t(v) for k, v in adam.step_count.items()}, {k: _t(v) for k, v in adam.lr.items()})
    return sd, adam, to_torch_splats(sd), t_state


def _assert_same_model(ts, sd, t_adam_state, j_adam_state):
    assert int(ts.n_active) == int(sd.n_active)
    for k in GROUPS:
        np.testing.assert_allclose(np_(getattr(ts, k)), np.asarray(getattr(sd, k)), **TOL, err_msg=k)
        np.testing.assert_array_equal(np_(t_adam_state.exp_avg[k]), np.asarray(j_adam_state.exp_avg[k]))
        np.testing.assert_array_equal(np_(t_adam_state.exp_avg_sq[k]),
                                      np.asarray(j_adam_state.exp_avg_sq[k]))


@pytest.mark.parametrize("op", ["relocate", "add"])
def test_relocate_and_add_match_jax(rng, op):
    sd, adam, ts, t_state = _relocation_scene(rng)
    cfg = j_mcmc.MCMCConfig(max_cap=64)
    key = jax.random.PRNGKey(5)
    u = _t(jax.random.uniform(key, (sd.capacity,)))
    j_fn = j_mcmc.relocate_gs if op == "relocate" else j_mcmc.add_new_gs
    t_fn = t_mcmc.relocate_gs if op == "relocate" else t_mcmc.add_new_gs
    sd2, adam2 = j_fn(key, sd, adam, j_mcmc_ops.make_binoms(), cfg)
    ts2, t_state2 = t_fn(u, ts, t_state, t_mcmc_ops.make_binoms(), t_mcmc.MCMCConfig(max_cap=64))
    _assert_same_model(ts2, sd2, t_state2, adam2)
    if op == "add":
        assert int(ts2.n_active) == 42


def test_add_noise_matches_jax(rng):
    sd = make_random_splats(rng, n=30, capacity=40)
    op = sd.opacity.at[:10].set(-8.0)  # low opacity: the gate opens
    key = jax.random.PRNGKey(9)
    args = (np.asarray(op), np.asarray(sd.scaling), np.asarray(sd.rotation), np.asarray(sd.means),
            np.asarray(sd.active_mask()))
    m_j = j_mcmc_ops.add_noise(*args, key, jnp.asarray(2.0))
    noise = jax.random.normal(key, (sd.capacity, 3))
    m_t = t_mcmc_ops.add_noise(*map(_t, args), _t(noise), torch.tensor(2.0))
    np.testing.assert_allclose(np_(m_t), np.asarray(m_j), **TOL)
    assert np.abs(np_(m_t) - args[3])[:10].max() > 1e-5  # the noise landed
    np.testing.assert_array_equal(np_(m_t)[30:], args[3][30:])  # dead slots untouched
