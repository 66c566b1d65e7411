"""Port parity for the training blend: rasterize(mode="cuda") of
lichtfeld_studio_tpu_torch (on the CPU: the plain P2, P3 and P4, binned
with the exact sort and slot layout) against the JAX package's
rasterize(mode="pallas") in interpret mode, and against the port's own
dense oracle differentiated by autograd.

Tolerances:
  * against JAX, the JAX package's own bar against its oracle
    (test_pallas_blend.py): grads rtol 2e-2, atol 2e-5 (3e-5 on the deep
    scene), with the JAX tail trim off (GRAD_SKIP_EPS = 0: the port
    replays every counted contribution). The JAX side streams colours as
    bf16 and contracts the geometry moments in one bf16 pass; the port
    stays float32;
  * against the port's oracle: per group, max |cuda - oracle| <= 1e-5 x
    max |oracle| (the same float32 math, summed in another order): about
    2000 times tighter;
  * the training forward: image within 4e-3 of JAX's (bf16 colours) and
    alpha within 5e-5; both within 1e-5 of the port's oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lichtfeld_studio_tpu.kernels import blend_pallas
from lichtfeld_studio_tpu.ops.rasterize import rasterize as j_rasterize
from lichtfeld_studio_tpu_torch.ops.rasterize import rasterize as t_rasterize
from tests.scene_utils import make_camera, make_random_splats
from tests.torch_parity import np_, to_torch_camera, to_torch_splats

# (width, height, n, spread, opacity range, capacity, instance cap, atol)
SCENES = {
    # test_pallas_gradients_match_oracle, with 8 dead slots past the live 32
    "match_oracle": (32, 32, 32, 1.2, (0.3, 0.95), 40, 4096, 2e-5),
    # test_pallas_gradients_deep_unaligned: deep tiles, many instances each
    "deep_unaligned": (64, 32, 400, 0.5, (0.6, 0.95), 400, 8192, 3e-5),
}


def _scene(name):
    w, h, n, spread, op_range, cap, icap, atol = SCENES[name]
    rng = np.random.default_rng(0)
    splats = make_random_splats(rng, n=n, spread=spread, opacity_range=op_range, capacity=cap)
    target = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    return splats, make_camera(w, h), target, icap, atol


def _jax_grads(splats, cam, target, icap):
    def loss(params):
        s = splats.replace_trainable(params)
        out = j_rasterize(s, cam.device_params(), jnp.zeros(3), mode="pallas",
                          instance_cap=icap, k_max=512)
        return jnp.mean((out.image - jnp.asarray(target)) ** 2)

    return {k: np.asarray(v) for k, v in jax.jit(jax.grad(loss))(splats.trainable_dict()).items()}


def _port_grads(sd, cam, target, icap, mode, tile_size=None):
    params = cam.device_params()
    out = t_rasterize(sd, params, torch.zeros(3), mode=mode, tile_size=tile_size,
                      instance_cap=icap)
    loss = ((out.image - torch.from_numpy(target)) ** 2).mean()
    grads = torch.autograd.grad(loss, list(sd.trainable_dict().values()))
    return out, {k: np_(g) for k, g in zip(sd.trainable_dict(), grads)}


@pytest.mark.parametrize("name", list(SCENES))
def test_gradients_match_jax_pallas(name, monkeypatch):
    splats, cam, target, icap, atol = _scene(name)
    monkeypatch.setattr(blend_pallas, "GRAD_SKIP_EPS", 0.0)
    g_j = _jax_grads(splats, cam, target, icap)
    _, g_t = _port_grads(to_torch_splats(splats), to_torch_camera(cam), target, icap, "cuda")
    for k in g_j:
        assert np.isfinite(g_t[k]).all(), k  # dead slots included
        np.testing.assert_allclose(g_t[k], g_j[k], rtol=2e-2, atol=atol, err_msg=k)


@pytest.mark.parametrize("name", list(SCENES))
@pytest.mark.parametrize("tile_size", [16, 32])
def test_gradients_match_port_oracle(name, tile_size):
    splats, cam, target, icap, _ = _scene(name)
    sd, tcam = to_torch_splats(splats), to_torch_camera(cam)
    out_c, g_c = _port_grads(sd, tcam, target, icap, "cuda", tile_size)
    out_o, g_o = _port_grads(sd, tcam, target, icap, "oracle")
    for k in g_o:
        assert np.isfinite(g_c[k]).all(), k
        assert np.abs(g_c[k] - g_o[k]).max() <= 1e-5 * np.abs(g_o[k]).max(), k
    assert float((out_c.image - out_o.image).detach().abs().max()) <= 1e-5
    assert float((out_c.alpha - out_o.alpha).detach().abs().max()) <= 1e-5


def test_training_forward_matches_jax():
    splats, cam, _, icap, _ = _scene("deep_unaligned")
    bg = np.array([0.2, 0.1, 0.4], np.float32)
    render = jax.jit(lambda s: j_rasterize(s, cam.device_params(), jnp.asarray(bg), mode="pallas",
                                           instance_cap=icap, k_max=512))
    out_j = render(splats)
    with torch.no_grad():
        out_t = t_rasterize(to_torch_splats(splats), to_torch_camera(cam).device_params(),
                            torch.from_numpy(bg), mode="cuda", instance_cap=icap)
    assert int(out_t.n_instances) == int(out_j.n_instances)
    np.testing.assert_allclose(np_(out_t.image), np.asarray(out_j.image), atol=4e-3)
    np.testing.assert_allclose(np_(out_t.alpha), np.asarray(out_j.alpha), atol=5e-5)


def test_default_tile_size_renders_and_differentiates():
    """rasterize(mode="cuda") with tile_size=None and without `inference`
    picks 16-px tiles (the JAX package's training default) and both
    renders and differentiates."""
    splats, cam, target, icap, _ = _scene("match_oracle")
    sd = to_torch_splats(splats)
    out, grads = _port_grads(sd, to_torch_camera(cam), target, icap, "cuda", tile_size=None)
    assert out.image.shape == (32, 32, 3) and float(out.image.detach().std()) > 0.01
    for k, g in grads.items():
        assert np.isfinite(g).all() and np.abs(g).max() > 0, k
