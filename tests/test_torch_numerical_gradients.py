"""tests/test_numerical_gradients.py on the port: central differences
against the port's analytic gradients, at the reference's tolerances
(relative 0.2 for the geometry groups, whose perturbations flip discrete
masks that the analytic gradient ignores; 0.08 otherwise; 0.02 for SH and
the projection alone). The full pipeline runs the port's kernel path on
CPU tensors (plain P1-P4). One case the reference lacks: the pose
embedding, d loss / d embeddings[uid] of the train step's loss (geometry:
0.2)."""

import numpy as np
import pytest
import torch

from lichtfeld_studio_tpu_torch.ops.projection import project_gaussians
from lichtfeld_studio_tpu_torch.ops.rasterize import rasterize
from lichtfeld_studio_tpu_torch.ops.sh import sh_to_color
from lichtfeld_studio_tpu_torch.train import state as t_state
from lichtfeld_studio_tpu_torch.train.strategies.mcmc import MCMCConfig
from tests.scene_utils import make_camera, make_random_splats
from tests.torch_parity import to_torch_camera, to_torch_splats

GEOMETRY = ("means", "rotation", "scaling", "opacity")


def _directional(loss, x, grad, eps, seed):
    """(analytic, central difference) of `loss` along a random direction."""
    d = torch.from_numpy(np.random.default_rng(seed).normal(0, 1, x.shape).astype(np.float32))
    analytic = float((grad * d).sum())
    fd = (float(loss(x + eps * d)) - float(loss(x - eps * d))) / (2 * eps)
    return analytic, fd


@pytest.mark.parametrize("group", ["means", "sh0", "shN", "scaling", "rotation", "opacity"])
def test_full_pipeline_directional_derivative(rng, group):
    """Directional derivative of the full render loss against central
    differences, one parameter group per case."""
    cam = to_torch_camera(make_camera(32, 32)).device_params()
    splats = to_torch_splats(make_random_splats(rng, n=12))
    target = torch.from_numpy(rng.uniform(0, 1, (32, 32, 3)).astype(np.float32))
    p0 = {k: v.detach().clone() for k, v in splats.trainable_dict().items()}

    def loss(x):
        splats.replace_trainable({**p0, group: x})
        out = rasterize(splats, cam, torch.zeros(3), mode="cuda", instance_cap=2048)
        return ((out.image - target) ** 2).mean()

    with torch.no_grad():
        splats.replace_trainable(p0)
    value = loss(p0[group])
    (grad,) = torch.autograd.grad(value, [getattr(splats, group)])
    with torch.no_grad():
        eps = 1e-3 if group in ("means", "scaling") else 3e-3
        analytic, fd = _directional(loss, p0[group], grad, eps, sum(map(ord, group)))
    rel = abs(analytic - fd) / max(abs(analytic), abs(fd), 1e-5)
    tol = 0.2 if group in GEOMETRY else 0.08
    assert rel < tol, f"{group}: analytic {analytic:.6g} vs fd {fd:.6g} (rel {rel:.3f})"


def test_sh_gradients_finite_diff(rng):
    means = torch.from_numpy(rng.normal(0, 1, (4, 3)).astype(np.float32) + np.array([0, 0, 5], np.float32))
    sh0 = torch.from_numpy(rng.normal(0, 0.3, (4, 1, 3)).astype(np.float32))
    shN = torch.from_numpy(rng.normal(0, 0.1, (4, 15, 3)).astype(np.float32))
    cam = torch.zeros(3)
    args = {"sh0": sh0, "shN": shN, "means": means}

    def f(**kw):
        a = {**args, **kw}
        return (sh_to_color(a["sh0"], a["shN"], a["means"], cam, 3) ** 2).sum()

    leaves = {k: v.clone().requires_grad_(True) for k, v in args.items()}
    grads = dict(zip(leaves, torch.autograd.grad(f(**leaves), list(leaves.values()))))
    with torch.no_grad():
        for name, x in args.items():
            analytic, fd = _directional(lambda y: f(**{name: y}), x, grads[name], 1e-3, 1)
            assert abs(analytic - fd) / max(abs(fd), 1e-6) < 0.02, name


def test_projection_gradients_finite_diff(rng):
    """EWA projection outputs (mean2d, conic, depth) against central
    differences of means and log-scales."""
    cam = to_torch_camera(make_camera(64, 48))
    splats = to_torch_splats(make_random_splats(rng, n=6))
    p = cam.device_params()

    def f(means, scaling):
        out = project_gaussians(
            means, scaling, splats.rotation.detach(), splats.opacity.detach(), splats.sh0.detach(),
            splats.shN.detach(), splats.active_mask(), splats.active_sh_degree, p.w2c,
            p.cam_position, p.K, width=64, height=48)
        w = torch.where(out.valid[:, None], 1.0, 0.0)
        return ((w * out.mean2d).sum() + 10.0 * (w * out.conic).sum()
                + torch.where(out.valid, out.depth, 0.0).sum())

    m, s = splats.means.detach().clone(), splats.scaling.detach().clone()
    gm, gs = torch.autograd.grad(f(m.requires_grad_(True), s.requires_grad_(True)), [m, s])
    m, s = m.detach(), s.detach()
    with torch.no_grad():
        for x, g, fn in ((m, gm, lambda y: f(y, s)), (s, gs, lambda y: f(m, y))):
            analytic, fd = _directional(fn, x, g, 1e-4, 3)
            assert abs(analytic - fd) / max(abs(fd), 1e-4) < 0.02


@pytest.mark.parametrize("mode", ["direct", "mlp"])
def test_pose_embedding_gradient_finite_diff(rng, mode):
    """d loss / d embeddings[uid] of compute_grads (render through the
    posed camera, L1 + SSIM) against central differences along a random
    direction of that row."""
    cam = make_camera(32, 32)
    cam.uid = 1
    params = to_torch_camera(cam).device_params()
    sd = make_random_splats(rng, n=16)
    target = torch.from_numpy(rng.uniform(0, 1, (32, 32, 3)).astype(np.float32))
    cfg = t_state.TrainConfig(raster_mode="cuda", instance_cap=2048, pose_mode=mode,
                              mcmc=MCMCConfig(max_cap=16))
    state = t_state.init_train_state(to_torch_splats(sd), t_state.make_lrs(
        1.6e-3, 2.5e-3, 5e-3, 1e-3, 0.05, sd.scene_scale), cfg=cfg, num_cameras=3)
    if mode == "mlp":  # a live output layer, so the embedding reaches the pose
        state.aux_params["pose.w_out"] = torch.from_numpy(
            rng.normal(0, 0.05, (64, 9)).astype(np.float32))
    emb0 = state.aux_params["pose.embeddings"].clone()
    grad = t_state.compute_grads(state, params, target, torch.zeros(3), cfg)[2]["_aux"][
        "pose.embeddings"]
    assert grad[[0, 2]].abs().max() == 0 and grad[1].abs().max() > 0

    def loss(row):
        emb = emb0.clone()
        emb[1] = row
        state.aux_params["pose.embeddings"] = emb
        return t_state.compute_grads(state, params, target, torch.zeros(3), cfg)[0]

    analytic, fd = _directional(loss, emb0[1], grad[1], 1e-3, 5)
    rel = abs(analytic - fd) / max(abs(analytic), abs(fd), 1e-5)
    assert rel < 0.2, f"analytic {analytic:.6g} vs fd {fd:.6g} (rel {rel:.3f})"
