"""The port's training components (lichtfeld_studio_tpu_torch.train.
components): each case of tests/test_components.py on the port, and each
function through both packages on the same numpy inputs made from a seed.

Tolerances: the bilateral slice and TV within 1e-6 (their gradients within
1e-5 of the largest), the pose transforms within 1e-6, the background
within 1e-7 with the JAX package's jitter injected; on tie-free inputs
the ADMM duals' zero pattern and the prune mask exactly, the duals' values
within 2 float32 ulps (the two packages' sigmoids differ in the last bit)
and the sparsity loss within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lichtfeld_studio_tpu.train.components import background as j_bg
from lichtfeld_studio_tpu.train.components import bilateral_grid as j_bil
from lichtfeld_studio_tpu.train.components import poseopt as j_pose
from lichtfeld_studio_tpu.train.components import sparsity as j_sp
from lichtfeld_studio_tpu_torch.ops.ssim import ssim
from lichtfeld_studio_tpu_torch.train.components import background as t_bg
from lichtfeld_studio_tpu_torch.train.components import bilateral_grid as t_bil
from lichtfeld_studio_tpu_torch.train.components import poseopt as t_pose
from lichtfeld_studio_tpu_torch.train.components import sparsity as t_sp
from tests.torch_parity import np_


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


# ---------------------------------------------------------------- bilateral
def test_identity_grid_is_noop(rng):
    rgb = torch.from_numpy(rng.uniform(0, 1, (24, 32, 3)).astype(np.float32))
    out = t_bil.apply_bilateral_grid(t_bil.identity_grids(2), rgb, 1)
    np.testing.assert_allclose(np_(out), np_(rgb), atol=1e-5)


def test_identity_grid_tv_zero():
    assert float(t_bil.tv_loss(t_bil.identity_grids(3))) == 0.0


def test_grid_gradients_flow(rng):
    grids = t_bil.identity_grids(1).requires_grad_(True)
    rgb = torch.from_numpy(rng.uniform(0, 1, (16, 16, 3)).astype(np.float32))
    tgt = torch.from_numpy(rng.uniform(0, 1, (16, 16, 3)).astype(np.float32))
    loss = ((t_bil.slice_grid(grids[0], rgb) - tgt) ** 2).mean() + t_bil.tv_loss(grids)
    (g,) = torch.autograd.grad(loss, [grids])
    assert torch.isfinite(g).all() and float(g.abs().sum()) > 0


def test_warmup_lr_schedule():
    assert abs(t_bil.warmup_exponential_lr(1.0, 0, 30000) - 0.01) < 1e-6
    assert abs(t_bil.warmup_exponential_lr(1.0, 1000, 30000) - 1.0) < 1e-3
    assert abs(t_bil.warmup_exponential_lr(1.0, 30000, 30000) - 0.01) < 1e-3


@pytest.mark.parametrize("dims", [(16, 16, 8), (5, 7, 3)], ids=["default", "odd"])
def test_bilateral_slice_and_tv_match_jax(dims):
    """A grid off identity, an image with values outside [0, 1] (clamped
    for the luminance, not for the affine): slice, TV and the gradients of
    a loss of both, against the JAX package."""
    rng = np.random.default_rng(4)
    x, y, w = dims
    grids = (np.asarray(j_bil.identity_grids(3, grid_w=x, grid_h=y, grid_l=w))
             + rng.normal(0, 0.05, (3, 12, w, y, x)).astype(np.float32))
    rgb = rng.uniform(-0.1, 1.1, (20, 28, 3)).astype(np.float32)
    tgt = rng.uniform(0, 1, (20, 28, 3)).astype(np.float32)

    def loss_j(g, c):
        out = j_bil.apply_bilateral_grid(g, c, jnp.asarray(2))
        return jnp.mean((out - tgt) ** 2) + 3.0 * j_bil.tv_loss(g), out

    (l_j, out_j), (gg_j, gc_j) = jax.value_and_grad(loss_j, argnums=(0, 1), has_aux=True)(
        jnp.asarray(grids), jnp.asarray(rgb))
    g_t, c_t = _t(grids).requires_grad_(True), _t(rgb).requires_grad_(True)
    out_t = t_bil.apply_bilateral_grid(g_t, c_t, 2)
    l_t = ((out_t - _t(tgt)) ** 2).mean() + 3.0 * t_bil.tv_loss(g_t)
    gg_t, gc_t = torch.autograd.grad(l_t, [g_t, c_t])
    np.testing.assert_allclose(np_(out_t), np.asarray(out_j), atol=1e-6)
    np.testing.assert_allclose(float(t_bil.tv_loss(_t(grids))), float(j_bil.tv_loss(grids)),
                               atol=1e-6)
    np.testing.assert_allclose(float(l_t.detach()), float(l_j), atol=1e-6)
    for a, b in ((gg_t, gg_j), (gc_t, gc_j)):
        b = np.asarray(b)
        assert np.abs(np_(a) - b).max() <= 1e-5 * np.abs(b).max()


def test_warmup_lr_matches_jax():
    for step in (0, 1, 500, 999, 1000, 1001, 7000, 29_999, 30_000):
        want = float(j_bil.warmup_exponential_lr(2e-3, jnp.asarray(step), 30_000))
        assert t_bil.warmup_exponential_lr(2e-3, step, 30_000) == pytest.approx(want, rel=1e-6)


# ---------------------------------------------------------------- pose opt
def test_rotation_6d_identity():
    r = t_pose.rotation_6d_to_matrix(torch.tensor([1.0, 0, 0, 0, 1, 0]))
    np.testing.assert_allclose(np_(r), np.eye(3), atol=1e-6)


def test_pose_zero_init_is_identity():
    w2c = torch.eye(4)
    w2c[0, 3] = 2.0
    for mode in ("direct", "mlp"):
        out = t_pose.apply_pose_opt(mode, t_pose.init_pose_params(mode, 4), w2c, 2)
        np.testing.assert_allclose(np_(out), np_(w2c), atol=1e-6)


def test_pose_direct_translation():
    params = t_pose.init_pose_params("direct", 2)
    params["embeddings"][1, 0] = 0.5  # dx
    out = t_pose.apply_pose_opt("direct", params, torch.eye(4), 1)
    np.testing.assert_allclose(np_(out[:3, 3]), [0.5, 0, 0], atol=1e-6)


def test_mlp_init_law():
    """The mlp's hidden layers follow torch.nn.Linear's U(+-1/sqrt(width))
    and its output layer is zero, as the JAX package's."""
    p = t_pose.init_pose_params("mlp", 3, generator=torch.Generator().manual_seed(5))
    lim = 1.0 / 8.0
    for k in ("w0", "b0", "w1", "b1"):
        assert float(p[k].abs().max()) <= lim and float(p[k].abs().max()) > 0.9 * lim
    assert not p["w_out"].any() and not p["b_out"].any() and not p["embeddings"].any()
    assert sorted(p) == sorted(j_pose.init_pose_params("mlp", 3))


@pytest.mark.parametrize("mode", ["direct", "mlp"])
def test_pose_transforms_match_jax(mode):
    """Random (non-zero) pose parameters, the JAX package's mlp draws
    carried across: the adjusted w2c within 1e-6."""
    rng = np.random.default_rng(7)
    params_j = j_pose.init_pose_params(mode, 4, key=jax.random.PRNGKey(3))
    params_j = {k: jnp.asarray(rng.normal(0, 0.1, v.shape).astype(np.float32)) if k != "w0"
                else v for k, v in params_j.items()}
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    w2c[:3, 3] = rng.normal(size=3)
    for uid in range(4):
        want = j_pose.apply_pose_opt(mode, params_j, jnp.asarray(w2c), jnp.asarray(uid))
        got = t_pose.apply_pose_opt(mode, {k: _t(v) for k, v in params_j.items()}, _t(w2c), uid)
        np.testing.assert_allclose(np_(got), np.asarray(want), atol=1e-6)
    r = rng.normal(size=(5, 6)).astype(np.float32)
    np.testing.assert_allclose(np_(t_pose.rotation_6d_to_matrix(_t(r))),
                               np.asarray(j_pose.rotation_6d_to_matrix(jnp.asarray(r))), atol=1e-6)


# ---------------------------------------------------------------- background
def test_bg_schedule_piecewise():
    assert t_bg.inv_weight_piecewise(0, 100) == 1.0
    assert abs(t_bg.inv_weight_piecewise(37, 100) - 0.76) < 0.01
    assert t_bg.inv_weight_piecewise(80, 100) <= 0.0 + 1e-6


def test_bg_modulation_bounds():
    g = torch.Generator().manual_seed(0)
    for it in (1, 100, 5000):
        v = np_(t_bg.background_for_step(torch.zeros(3), it, 30000, torch.rand(3, generator=g)))
        assert (v >= 0).all() and (v <= 1).all()


def test_background_matches_jax():
    """Every step of the schedule's four pieces and the three periods'
    wraps, JAX's jitter injected."""
    base = np.array([0.1, 0.5, 0.9], np.float32)
    for it in (1, 2, 24, 25, 26, 36, 37, 41, 43, 50, 51, 74, 75, 76, 99, 100, 1234):
        key = jax.random.PRNGKey(it)
        want = np.asarray(j_bg.background_for_step(jnp.asarray(base), jnp.asarray(it), key, 100,
                                                   True))
        u = _t(jax.random.uniform(key, (3,)))
        got = np_(t_bg.background_for_step(_t(base), it, 100, u))
        np.testing.assert_allclose(got, want, atol=1e-7, err_msg=str(it))
        assert float(t_bg.inv_weight_piecewise(it, 100)) == float(
            j_bg.inv_weight_piecewise(jnp.asarray(it), 100))


# ---------------------------------------------------------------- ssim ref
def test_ssim_matches_scipy_reference(rng):
    """The port's SSIM against a direct scipy implementation (same windows,
    valid padding)."""
    from scipy.ndimage import convolve1d

    a = rng.uniform(0, 1, (48, 64, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    x = np.arange(11) - 5
    g = np.exp(-(x**2) / (2 * 1.5**2))
    g /= g.sum()

    def blur(img):
        out = convolve1d(img, g, axis=0, mode="constant")
        out = convolve1d(out, g, axis=1, mode="constant")
        return out[5:-5, 5:-5]

    c1, c2 = 0.01**2, 0.03**2
    mu1, mu2 = blur(a), blur(b)
    s1 = blur(a * a) - mu1 * mu1
    s2 = blur(b * b) - mu2 * mu2
    s12 = blur(a * b) - mu1 * mu2
    ref = (((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
           / ((mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2))).mean()
    ours = float(ssim(torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    assert ours <= 1.0 + 1e-5


# ---------------------------------------------------------------- sparsity
def test_admm_prune_z_zeros_smallest(rng):
    c = 16
    op_logit = torch.from_numpy(rng.normal(0, 1, (c, 1)).astype(np.float32))
    st = t_sp.init_admm(op_logit, torch.ones(c, dtype=torch.bool), torch.tensor(c), 0.5)
    z = np_(st.z)
    assert (z == 0).sum() == 8
    opa = np_(torch.sigmoid(op_logit[:, 0]))
    assert set(np.argsort(opa)[:8]) == set(np.nonzero(z == 0)[0])


def test_admm_loss_decreases_with_matching_opacity(rng):
    c = 8
    op_logit = torch.from_numpy(rng.normal(0, 1, (c, 1)).astype(np.float32))
    active = torch.ones(c, dtype=torch.bool)
    st = t_sp.init_admm(op_logit, active, torch.tensor(c), 0.25)
    op = op_logit.clone().requires_grad_(True)
    loss = t_sp.sparsity_loss(op, active, st, rho=1.0)
    assert float(loss) > 0
    (g,) = torch.autograd.grad(loss, [op])
    assert torch.isfinite(g).all()


def test_prune_mask_fraction(rng):
    c = 20
    op_logit = torch.from_numpy(rng.normal(0, 1, (c, 1)).astype(np.float32))
    m = t_sp.prune_mask(op_logit, torch.ones(c, dtype=torch.bool), torch.tensor(c), 0.3)
    assert int(m.sum()) == 6


@pytest.mark.parametrize("n_live", [37, 64], ids=["dead_tail", "full"])
def test_admm_matches_jax(n_live):
    """init, two updates, the loss and its gradient, and the prune mask on
    tie-free opacities, dead slots past the live prefix, against the JAX
    package's."""
    rng = np.random.default_rng(11)
    cap, ratio = 64, 0.6
    logits = rng.permutation(np.linspace(-4, 4, cap)).astype(np.float32)[:, None]
    active_np = np.arange(cap) < n_live
    args_j = (jnp.asarray(active_np), jnp.asarray(n_live, jnp.int32))
    args_t = (torch.from_numpy(active_np), torch.tensor(n_live, dtype=torch.int32))
    st_j = j_sp.init_admm(jnp.asarray(logits), *args_j, ratio)
    st_t = t_sp.init_admm(_t(logits), *args_t, ratio)
    for step in range(3):
        for a, b in ((st_t.z, st_j.z), (st_t.u, st_j.u)):
            b = np.asarray(b)
            np.testing.assert_array_equal(np_(a) == 0, b == 0)
            np.testing.assert_allclose(np_(a), b, rtol=2.4e-7, atol=0)
        logits = logits + rng.normal(0, 0.3, logits.shape).astype(np.float32)
        st_j = j_sp.update_admm(jnp.asarray(logits), *args_j, st_j, ratio)
        st_t = t_sp.update_admm(_t(logits), *args_t, st_t, ratio)
    l_j, g_j = jax.value_and_grad(lambda o: j_sp.sparsity_loss(o, args_j[0], st_j, 5e-4))(
        jnp.asarray(logits))
    op = _t(logits).requires_grad_(True)
    l_t = t_sp.sparsity_loss(op, args_t[0], st_t, 5e-4)
    np.testing.assert_allclose(float(l_t.detach()), float(l_j), rtol=1e-6)
    np.testing.assert_allclose(np_(torch.autograd.grad(l_t, [op])[0]), np.asarray(g_j),
                               rtol=1e-6, atol=1e-12)
    m_j = np.asarray(j_sp.prune_mask(jnp.asarray(logits), *args_j, ratio))
    m_t = np_(t_sp.prune_mask(_t(logits), *args_t, ratio))
    np.testing.assert_array_equal(m_t, m_j)
    assert m_t.sum() == int(np.float32(ratio) * np.float32(n_live))
