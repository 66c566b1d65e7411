"""Port parity for the ADC ("default") strategy of
lichtfeld_studio_tpu_torch.train against the JAX package: grow, prune,
opacity reset and post_backward with the JAX package's normal draws
injected (indices and n_active equal, values rtol 1e-6 / atol 1e-6), the
step schedule of both strategies, d loss / d mean2d and the densification
statistics, and a short ADC run."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lichtfeld_studio_tpu.ops.adam import init_adam as j_init_adam
from lichtfeld_studio_tpu.ops.rasterize import rasterize as j_rasterize
from lichtfeld_studio_tpu.train import state as j_state
from lichtfeld_studio_tpu.train.strategies import adc as j_adc
from lichtfeld_studio_tpu.train.strategies.mcmc import MCMCConfig as JMCMCConfig
from lichtfeld_studio_tpu_torch.ops.adam import init_adam as t_init_adam
from lichtfeld_studio_tpu_torch.train import state as t_state
from lichtfeld_studio_tpu_torch.train.strategies import adc as t_adc
from lichtfeld_studio_tpu_torch.train.strategies.mcmc import MCMCConfig as TMCMCConfig
from tests.scene_utils import make_camera, make_random_splats
from tests.torch_parity import np_, to_torch_camera, to_torch_splats, to_torch_train_state

GROUPS = ("means", "sh0", "shN", "scaling", "rotation", "opacity")
TOL = dict(rtol=1e-6, atol=1e-6)


def _cfgs(**kw):
    mcmc = dict(max_cap=kw.pop("max_cap", 128), start_refine=kw.pop("start_refine", 3),
                stop_refine=kw.pop("stop_refine", 1000), refine_every=kw.pop("refine_every", 5))
    k_max = kw.pop("k_max", 64)  # the JAX tiles mode's gaussians a tile
    # 16-px tiles: the reference tiling (segmented sums in another order
    # flip ADC's hard grow thresholds)
    common = {**dict(strategy="default", tile_size=16, instance_cap=4096, scale_reg=0.0,
                     opacity_reg=0.0, lr_gamma=1.0), **kw}
    return (j_state.TrainConfig(raster_mode="tiles", k_max=k_max, mcmc=JMCMCConfig(**mcmc), **common),
            t_state.TrainConfig(raster_mode="cuda", mcmc=TMCMCConfig(**mcmc), **common))


def _adams(splats_j, splats_t, rng):
    """The same non-zero Adam moments for both packages."""
    a_j = j_init_adam(splats_j.trainable_dict(), {k: 0.01 for k in GROUPS})
    a_t = t_init_adam({k: p.detach() for k, p in splats_t.trainable_dict().items()},
                      {k: 0.01 for k in GROUPS})
    for k in GROUPS:
        m = rng.normal(size=a_t.exp_avg[k].shape).astype(np.float32)
        a_j.exp_avg[k], a_t.exp_avg[k] = jnp.asarray(m), torch.from_numpy(m.copy())
        a_j.exp_avg_sq[k], a_t.exp_avg_sq[k] = jnp.asarray(m * m), torch.from_numpy(m * m)
    return a_j, a_t


def _assert_same(splats_t, adam_t, splats_j, adam_j):
    assert int(splats_t.n_active) == int(splats_j.n_active)
    for k in GROUPS:
        np.testing.assert_allclose(np_(getattr(splats_t, k)), np.asarray(getattr(splats_j, k)),
                                   **TOL, err_msg=k)
        np.testing.assert_allclose(np_(adam_t.exp_avg[k]), np.asarray(adam_j.exp_avg[k]),
                                   **TOL, err_msg=k)
        np.testing.assert_allclose(np_(adam_t.exp_avg_sq[k]), np.asarray(adam_j.exp_avg_sq[k]),
                                   **TOL, err_msg=k)


def _grow_scene(rng, capacity=64):
    n = 16
    splats = make_random_splats(rng, n=n, capacity=capacity)
    # gaussians 0-3 small, 4-7 large, the rest small; 0-7 with high gradients
    scaling = np.full((capacity, 3), -10.0, np.float32)
    scaling[:4] = np.log(0.001 * splats.scene_scale)
    scaling[4:8] = np.log(1.0 * splats.scene_scale)
    scaling[8:n] = np.log(0.001 * splats.scene_scale)
    splats = splats.replace_trainable({**splats.trainable_dict(), "scaling": jnp.asarray(scaling)})
    grad = np.zeros(capacity, np.float32)
    grad[:8] = 1.0
    return splats, np.ones(capacity, np.float32), grad


def _jax_split_draws(key, capacity):
    k1, k2 = jax.random.split(key)
    return {"split_a": torch.from_numpy(np.array(jax.random.normal(k1, (capacity, 3)))),
            "split_b": torch.from_numpy(np.array(jax.random.normal(k2, (capacity, 3))))}


@pytest.mark.parametrize("revised,capacity", [(False, 64), (True, 64), (False, 20)],
                         ids=["plain", "revised_opacity", "capacity_clips_growth"])
def test_grow_matches_jax(rng, revised, capacity):
    """duplicate + split (test_adc.py:48): 4 duplicated + 4 split = +8, or
    as many as the capacity holds; the candidates beyond it are dropped."""
    splats, count, grad = _grow_scene(rng, capacity)
    cfg_j, cfg = _cfgs(revised_opacity=revised)
    st = to_torch_splats(splats)
    a_j, a_t = _adams(splats, st, rng)
    key = jax.random.PRNGKey(0)
    new_j, adam_j = j_adc.grow_gs(key, splats, a_j, jnp.asarray(count), jnp.asarray(grad), cfg_j)
    new_t, adam_t = t_adc.grow_gs(_jax_split_draws(key, capacity), st, a_t,
                                  torch.from_numpy(count), torch.from_numpy(grad), cfg)
    assert int(new_t.n_active) == min(16 + 8, capacity)
    _assert_same(new_t, adam_t, new_j, adam_j)
    np.testing.assert_allclose(np_(new_t.get_scaling()[4:8]), 1.0 * splats.scene_scale / 1.6,
                               rtol=1e-4)


@pytest.mark.parametrize("iteration", [100, 5000], ids=["before_reset_every", "after_reset_every"])
def test_prune_matches_jax(rng, iteration):
    """prune + stable partition (test_adc.py:72); after reset_every the
    size rule prunes too."""
    n = 24
    splats = make_random_splats(rng, n=n, capacity=32)
    op = np.array(splats.opacity)
    op[3] = op[10] = -15.0
    sc = np.array(splats.scaling)
    sc[5] = np.log(0.5 * splats.scene_scale)  # too big once iteration > reset_every
    rot = np.array(splats.rotation)
    rot[7] = 0.0  # degenerate quaternion
    splats = splats.replace_trainable({**splats.trainable_dict(), "opacity": jnp.asarray(op),
                                       "scaling": jnp.asarray(sc), "rotation": jnp.asarray(rot)})
    cfg_j, cfg = _cfgs()
    st = to_torch_splats(splats)
    a_j, a_t = _adams(splats, st, rng)
    new_j, adam_j = j_adc.prune_gs(jnp.asarray(iteration), splats, a_j, cfg_j)
    new_t, adam_t = t_adc.prune_gs(iteration, st, a_t, cfg)
    _assert_same(new_t, adam_t, new_j, adam_j)
    if iteration <= cfg.reset_every:
        gone = [3, 7, 10]
        assert int(new_t.n_active) == n - len(gone)
        np.testing.assert_allclose(np_(new_t.means[: n - len(gone)]),
                                   np.delete(np.asarray(splats.means[:n]), gone, axis=0),
                                   atol=1e-6)
    else:  # the size rule prunes gaussian 5 and every other large one too
        assert int(new_t.n_active) < n - 3


def test_reset_opacity_matches_jax(rng):
    splats = make_random_splats(rng, n=8, opacity_range=(0.5, 0.9))
    cfg_j, cfg = _cfgs()
    st = to_torch_splats(splats)
    a_j, a_t = _adams(splats, st, rng)
    new_j, adam_j = j_adc.reset_opacity(splats, a_j, cfg_j)
    new_t, adam_t = t_adc.reset_opacity(st, a_t, cfg)
    _assert_same(new_t, adam_t, new_j, adam_j)
    assert np.all(np_(torch.sigmoid(new_t.opacity[:8, 0])) <= 2.0 * cfg.prune_opacity + 1e-6)
    assert float(adam_t.exp_avg["opacity"].abs().max()) == 0.0


@pytest.mark.parametrize("flags", [dict(refine=True, sh_step=True), dict(reset=True), dict()],
                         ids=["refine_sh", "reset", "plain"])
def test_post_backward_matches_jax(rng, flags):
    splats, count, grad = _grow_scene(rng)
    splats = dataclasses.replace(splats, active_sh_degree=jnp.asarray(1, jnp.int32))
    cfg_j, cfg = _cfgs()
    st = to_torch_splats(splats)
    a_j, a_t = _adams(splats, st, rng)
    key = jax.random.PRNGKey(3)
    out_j = j_adc.post_backward(key, jnp.asarray(10), splats, a_j, jnp.asarray(count),
                                jnp.asarray(grad), cfg_j, **flags)
    out_t = t_adc.post_backward(None, 10, st, a_t, torch.from_numpy(count), torch.from_numpy(grad),
                                cfg, draws=_jax_split_draws(key, 64), **flags)
    _assert_same(out_t[0], out_t[1], out_j[0], out_j[1])
    assert int(out_t[0].active_sh_degree) == int(out_j[0].active_sh_degree)
    np.testing.assert_array_equal(np_(out_t[2]), np.asarray(out_j[2]))
    np.testing.assert_array_equal(np_(out_t[3]), np.asarray(out_j[3]))


@pytest.mark.parametrize("name,kw", [
    ("mcmc", dict(strategy="mcmc")),
    ("default", dict(strategy="default")),
    ("default_short_pause", dict(strategy="default", reset_every=500, pause_refine_after_reset=150,
                                 start_refine=100, stop_refine=2600, refine_every=50)),
])
def test_step_flags_match_jax_1_to_7000(name, kw):
    """The whole schedule (test_adc.py:132 and the MCMC one): refine, SH,
    reset (gated below stop_refine) and the shN freeze, iterations 1..7000."""
    mcmc = {k: kw.pop(k) for k in ("start_refine", "stop_refine", "refine_every") if k in kw}
    cfg_j = j_state.TrainConfig(mcmc=JMCMCConfig(**mcmc), **kw)
    cfg = t_state.TrainConfig(mcmc=TMCMCConfig(**mcmc), **kw)
    seen = set()
    for it in range(1, 7001):
        want = dataclasses.asdict(j_state.step_flags(cfg_j, it))
        got = dataclasses.asdict(t_state.step_flags(cfg, it))
        assert got == {k: want[k] for k in got}, it
        seen.update(k for k, v in got.items() if v)
    assert {"refine", "sh_step", "shn_frozen"} <= seen
    assert ("reset" in seen) == (kw["strategy"] == "default")


def test_reset_gated_by_stop_refine():
    cfg = t_state.TrainConfig(strategy="default", reset_every=100,
                              mcmc=TMCMCConfig(start_refine=10, stop_refine=250, refine_every=10))
    assert t_state.step_flags(cfg, 100).reset and t_state.step_flags(cfg, 200).reset
    assert not t_state.step_flags(cfg, 300).reset  # on or after stop_refine: never


@pytest.fixture(scope="module")
def adc_step():
    """One JAX compute_grads + apply_update with strategy="default"."""
    rng = np.random.default_rng(5)
    sd = make_random_splats(rng, n=40, capacity=64, spread=0.9)
    cam = make_camera(48, 32)
    gt = rng.uniform(0, 1, (32, 48, 3)).astype(np.float32)
    cfg_j, _ = _cfgs()
    lrs = j_state.make_lrs(1.6e-3, 2.5e-3, 5e-3, 1e-3, 0.05, sd.scene_scale)
    state = j_state.init_train_state(sd, lrs, seed=0)
    compute = jax.jit(j_state.compute_grads, static_argnames=("cfg",))
    loss, out, grads = compute(state, cam.device_params(), jnp.asarray(gt), jnp.zeros(3), cfg=cfg_j)
    new_state, _ = j_state.apply_update(state, grads, cfg_j, loss, out, j_state.StepFlags())
    return sd, cam, gt, state, loss, out, grads, new_state


def test_mean2d_gradient_and_stats_match_jax(adc_step):
    """d loss / d mean2d through the port's one backward pass (P3's plain
    version on the CPU) against the gradient of the JAX package's zero
    dummy: 1e-5 of the largest entry (float32 sums in another order); the
    densification statistics after apply_update: counts equal, gradient
    norms 1e-5 of the largest."""
    sd, cam, gt, state_j, loss_j, out_j, grads_j, new_j = adc_step
    _, cfg = _cfgs()
    state = to_torch_train_state(state_j)
    loss, out, grads = t_state.compute_grads(
        state, to_torch_camera(cam).device_params(), torch.from_numpy(gt), torch.zeros(3), cfg)
    want = np.asarray(grads_j["_mean2d"])
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(np_(grads["_mean2d"]), want, rtol=0, atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(np_(out.visibility), np.asarray(out_j.visibility))
    state, _ = t_state.apply_update(state, grads, cfg, loss, out, t_state.StepFlags())
    np.testing.assert_array_equal(np_(state.densify_count), np.asarray(new_j.densify_count))
    want_g = np.asarray(new_j.densify_grad)
    np.testing.assert_allclose(np_(state.densify_grad), want_g, rtol=0,
                               atol=1e-5 * want_g.max())
    # the MCMC step asks for no such gradient
    _, _, grads_m = t_state.compute_grads(
        to_torch_train_state(state_j), to_torch_camera(cam).device_params(),
        torch.from_numpy(gt), torch.zeros(3), dataclasses.replace(cfg, strategy="mcmc"))
    assert "_mean2d" not in grads_m


def test_adc_training_grows_and_stays_finite(rng):
    """A 30-step ADC run (test_adc.py:100): the loss falls, the model grows
    at the refine steps, everything stays finite."""
    gt_splats = make_random_splats(rng, n=32, capacity=128)
    cam = make_camera(48, 32)
    target = np.asarray(j_rasterize(gt_splats, cam.device_params(), jnp.zeros(3), mode="tiles",
                                    instance_cap=4096, k_max=64).image)
    noisy = gt_splats.replace_trainable({
        **gt_splats.trainable_dict(),
        "means": gt_splats.means
        + 0.05 * jnp.asarray(rng.normal(0, 1, gt_splats.means.shape).astype(np.float32))})
    _, cfg = _cfgs(start_refine=5, refine_every=10, reset_every=10_000, grad_threshold=2e-5)
    sd = to_torch_splats(noisy)
    state = t_state.init_train_state(
        sd, t_state.make_lrs(1.6e-3, 2.5e-3, 5e-3, 1e-3, 0.05, sd.scene_scale), seed=0)
    params = to_torch_camera(cam).device_params()
    losses = []
    for i in range(30):
        state, metrics = t_state.train_step(state, params, torch.from_numpy(target.copy()),
                                            torch.zeros(3), cfg, t_state.step_flags(cfg, i + 1))
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    # growth events spike the loss: the best of the last steps against the start
    assert min(losses[-5:]) < np.mean(losses[:5])
    assert int(state.splats.n_active) > 32
    assert torch.isfinite(state.densify_grad).all()
    for p in state.splats.trainable_dict().values():
        assert torch.isfinite(p).all()


def test_live_counts_through_reset_and_refines_match_jax(rng):
    """Both packages train the same model on the same view with the JAX
    package's split draws injected, the regularisers on, through refines at
    15, 30 and 45 and opacity resets at 20 and 40: the live count after
    every step is equal, so what a reset and the refine after it grow and
    prune is the JAX package's behaviour; the last loss within 1e-4."""
    n, cap = 48, 256
    gt_splats = make_random_splats(rng, n=n, capacity=cap)
    cam = make_camera(48, 32)
    target = np.asarray(j_rasterize(gt_splats, cam.device_params(), jnp.zeros(3), mode="tiles",
                                    instance_cap=4096, k_max=64).image)
    noisy = gt_splats.replace_trainable({
        **gt_splats.trainable_dict(),
        "means": gt_splats.means
        + 0.05 * jnp.asarray(rng.normal(0, 1, gt_splats.means.shape).astype(np.float32))})
    cfg_j, cfg = _cfgs(max_cap=cap, k_max=cap, start_refine=5, refine_every=15, reset_every=20,
                       opacity_reg=0.01, scale_reg=0.01)
    state_j = j_state.init_train_state(
        noisy, j_state.make_lrs(1.6e-3, 2.5e-3, 5e-3, 1e-3, 0.05, noisy.scene_scale), seed=0)
    state = to_torch_train_state(state_j)
    compute = jax.jit(j_state.compute_grads, static_argnames=("cfg",))
    params_j, params = cam.device_params(), to_torch_camera(cam).device_params()
    counts_j, counts, seen = [], [], set()
    for it in range(1, 47):
        flags_j, flags = j_state.step_flags(cfg_j, it), t_state.step_flags(cfg, it)
        seen.update(k for k in ("refine", "reset") if getattr(flags, k))
        _, sub = jax.random.split(state_j.key)  # the key apply_update hands the strategy
        loss_j, out_j, grads_j = compute(state_j, params_j, jnp.asarray(target), jnp.zeros(3),
                                         cfg=cfg_j)
        state_j, _ = j_state.apply_update(state_j, grads_j, cfg_j, loss_j, out_j, flags_j)
        loss, out, grads = t_state.compute_grads(state, params, torch.from_numpy(target.copy()),
                                                 torch.zeros(3), cfg)
        state, _ = t_state.apply_update(state, grads, cfg, loss, out, flags,
                                        draws=_jax_split_draws(sub, cap))
        counts_j.append(int(state_j.splats.n_active))
        counts.append(int(state.splats.n_active))
    assert seen == {"refine", "reset"}
    assert counts == counts_j
    assert counts[-1] != n and len(set(counts)) >= 3  # the refines did change the model
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-4)
