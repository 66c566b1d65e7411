"""Port parity for the training blend: rasterize(mode="cuda") of
lichtfeld_studio_tpu_torch (on the CPU: the plain P2, P3 and P4, binned
with the exact sort and slot layout) against the JAX package's
rasterize(mode="pallas") in interpret mode, and against the port's own
dense oracle differentiated by autograd.

The backward's tail trim (GRAD_SKIP_EPS, 1/255 by default in both
packages) is held to the JAX package's at 0 and at 1/255, with the same
eps on both sides: the port's tile_neff against the n_eff the JAX backward
recomputes from its forward's rows 6-7 (blend_pallas.py:956-971), and the
set of gaussians with a zero gradient against JAX's on the JAX package's
own trim scene (test_pallas_blend.py::test_grad_skip_eps_trim_bound).

Tolerances:
  * against JAX, the JAX package's own bar against its oracle
    (test_pallas_blend.py): grads rtol 2e-2, atol 2e-5 (3e-5 on the deep
    scene). The JAX side streams colours as bf16 and contracts the
    geometry moments in one bf16 pass; the port stays float32. On the trim
    scene, whose L1 loss sums 3072 terms of one sign each, that rounding
    (2^-9 of a colour) reaches 4e-3 of a group's largest gradient there,
    so its atol is 5e-3 of the group's largest JAX gradient, plus 1e-6 for
    the rotation, which is rounding noise on both sides (the gaussians are
    spheres). tile_neff
    equal, but where a window's JAX bound lies within 1e-6 of eps (the two
    sides round T in other orders);
  * against the port's oracle, at eps 0 (the oracle is the exact
    gradient): per group, max |cuda - oracle| <= 1e-5 x max |oracle| (the
    same float32 math, summed in another order): about 2000 times tighter;
  * the trim itself, port against port: at eps 0 the rows are the full
    replay's bits, at 1/255 the same bits with the trimmed tail's rows 0;
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
from lichtfeld_studio_tpu_torch.kernels import blend as kblend
from lichtfeld_studio_tpu_torch.ops.rasterize import rasterize as t_rasterize
from tests.scene_utils import make_camera, make_random_splats
from tests.torch_parity import np_, to_torch_camera, to_torch_splats

EPS = 1.0 / 255.0
# (width, height, n, spread, opacity range, capacity, instance cap, atol,
# atol as a share of the group's largest JAX gradient, log scale of every
# axis or None, loss)
SCENES = {
    # test_pallas_gradients_match_oracle, with 8 dead slots past the live 32
    "match_oracle": (32, 32, 32, 1.2, (0.3, 0.95), 40, 4096, 2e-5, 0.0, None, "l2"),
    # test_pallas_gradients_deep_unaligned: deep tiles, many instances each
    "deep_unaligned": (64, 32, 400, 0.5, (0.6, 0.95), 400, 8192, 3e-5, 0.0, None, "l2"),
    # test_grad_skip_eps_trim_bound: 512 faint gaussians far wider than the
    # image, so every pixel's T decays through the band the trim cuts
    "trim": (32, 32, 512, 0.05, (0.045, 0.055), 512, 8192, 1e-6, 5e-3, np.log(5.0), "l1"),
}


def _scene(name):
    w, h, n, spread, op_range, cap, icap, atol, atol_share, log_scale, loss = SCENES[name]
    rng = np.random.default_rng(0)
    splats = make_random_splats(rng, n=n, spread=spread, opacity_range=op_range, capacity=cap)
    if log_scale is not None:
        p0 = splats.trainable_dict()
        splats = splats.replace_trainable(
            dict(p0, scaling=jnp.full_like(p0["scaling"], log_scale)))
    target = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    return splats, make_camera(w, h), target, icap, atol, atol_share, loss


def _loss(diff, kind):
    return (diff ** 2).mean() if kind == "l2" else abs(diff).sum()


def _jax_grads(splats, cam, target, icap, loss_kind="l2", monkeypatch=None):
    """The JAX package's gradients; with `monkeypatch`, also the n_eff its
    backward computes (blend_pallas.py:956-971, recomputed here from the
    forward's rows 6-7 that it reads) and each tile's window bounds."""
    seen = {}
    if monkeypatch is not None:
        backward_call = blend_pallas._backward_call

        def spy(feat_t, tile_start, tile_count, out, *rest, **kw):
            jax.debug.callback(lambda rows: seen.update(rows=np.asarray(rows)), out[:, 6:8, :])
            return backward_call(feat_t, tile_start, tile_count, out, *rest, **kw)

        monkeypatch.setattr(blend_pallas, "_backward_call", spy)

    def loss(params):
        s = splats.replace_trainable(params)
        out = j_rasterize(s, cam.device_params(), jnp.zeros(3), mode="pallas",
                          instance_cap=icap, k_max=512)
        return _loss(out.image - jnp.asarray(target), loss_kind)

    grads = {k: np.asarray(v)
             for k, v in jax.jit(jax.grad(loss))(splats.trainable_dict()).items()}
    if monkeypatch is None:
        return grads
    rows = seen["rows"]
    n_pix = rows.shape[2]
    bounds = rows[:, 1, :]  # lane ci: chunk ci's largest weight
    lanes = np.arange(n_pix)[None, :]
    n_eff = np.maximum(np.max(np.where(bounds >= np.float32(blend_pallas.GRAD_SKIP_EPS),
                                       lanes + 1, 0), axis=1), 1)
    if not blend_pallas.GRAD_SKIP_EPS > 0.0:
        n_eff = np.full_like(n_eff, 2 ** 30)
    n_eff = np.where(rows[:, 0, 0] > n_pix, 2 ** 30, n_eff)
    return grads, n_eff, bounds


def _port_grads(sd, cam, target, icap, mode, tile_size=None, loss_kind="l2"):
    params = cam.device_params()
    out = t_rasterize(sd, params, torch.zeros(3), mode=mode, tile_size=tile_size,
                      instance_cap=icap)
    loss = _loss(out.image - torch.from_numpy(target), loss_kind)
    grads = torch.autograd.grad(loss, list(sd.trainable_dict().values()))
    return out, {k: np_(g) for k, g in zip(sd.trainable_dict(), grads)}


def _spy_tile_neff(monkeypatch):
    """Record the tile_neff of the port's training forward and the number
    of 128-instance windows each tile's range touches."""
    seen = {}
    forward = kblend.blend_forward

    def spy(*args, **kw):
        out = forward(*args, **kw)
        if kw.get("train"):
            start, count = args[0].long(), args[1].long()
            seen["tile_neff"] = out[4].numpy()
            seen["windows"] = ((start % 128 + count + 127) // 128).numpy()
        return out

    monkeypatch.setattr(kblend, "blend_forward", spy)
    return seen


@pytest.mark.parametrize("eps", [0.0, EPS], ids=["full_replay", "trim"])
@pytest.mark.parametrize("name", list(SCENES))
def test_gradients_match_jax_pallas(name, eps, monkeypatch):
    """Gradients within the JAX package's bar at one eps on both sides;
    tile_neff equal to JAX's n_eff. On the trim scene at 1/255 the trim
    engages and the port zeroes exactly the gaussians that JAX zeroes."""
    splats, cam, target, icap, atol, atol_share, loss_kind = _scene(name)
    monkeypatch.setattr(blend_pallas, "GRAD_SKIP_EPS", eps)
    monkeypatch.setattr(kblend, "GRAD_SKIP_EPS", eps)
    g_j, n_eff_j, bounds_j = _jax_grads(splats, cam, target, icap, loss_kind, monkeypatch)
    seen = _spy_tile_neff(monkeypatch)
    _, g_t = _port_grads(to_torch_splats(splats), to_torch_camera(cam), target, icap, "cuda",
                         loss_kind=loss_kind)
    for k in g_j:
        assert np.isfinite(g_t[k]).all(), k  # dead slots included
        np.testing.assert_allclose(g_t[k], g_j[k], rtol=2e-2,
                                   atol=atol + atol_share * np.abs(g_j[k]).max(), err_msg=k)
    n_eff_t = seen["tile_neff"]
    # a tile may differ only where a window's JAX bound lies within 1e-6 of eps
    near = (np.abs(bounds_j - np.float32(eps)) <= 1e-6).any(axis=1)
    assert ((n_eff_t == n_eff_j) | near).all(), (n_eff_t, n_eff_j)
    if eps == 0.0:
        assert (n_eff_t == kblend.FULL_REPLAY).all()
    if name == "trim" and eps > 0.0:
        assert (n_eff_t < seen["windows"]).any()  # the trim engages
        # rotation is left out: these gaussians are spheres, so its
        # gradient is rounding noise on both sides
        for k in ("means", "sh0", "shN", "scaling", "opacity"):
            zero_j = ~g_j[k].reshape(len(g_j[k]), -1).any(axis=1)
            zero_t = ~g_t[k].reshape(len(g_t[k]), -1).any(axis=1)
            assert (zero_j == zero_t).all(), (k, np.flatnonzero(zero_j != zero_t))
            assert zero_t.sum() > 0, k


@pytest.mark.parametrize("name", ["match_oracle", "deep_unaligned"])
@pytest.mark.parametrize("tile_size", [16, 32])
def test_gradients_match_port_oracle(name, tile_size, monkeypatch):
    """At eps 0: the oracle is the exact gradient, and the trim would drop
    rows of the deep scene."""
    monkeypatch.setattr(kblend, "GRAD_SKIP_EPS", 0.0)
    splats, cam, target, icap, *_ = _scene(name)
    sd, tcam = to_torch_splats(splats), to_torch_camera(cam)
    out_c, g_c = _port_grads(sd, tcam, target, icap, "cuda", tile_size)
    out_o, g_o = _port_grads(sd, tcam, target, icap, "oracle")
    for k in g_o:
        assert np.isfinite(g_c[k]).all(), k
        assert np.abs(g_c[k] - g_o[k]).max() <= 1e-5 * np.abs(g_o[k]).max(), k
    assert float((out_c.image - out_o.image).detach().abs().max()) <= 1e-5
    assert float((out_c.alpha - out_o.alpha).detach().abs().max()) <= 1e-5


def test_training_forward_matches_jax():
    splats, cam, _, icap, *_ = _scene("deep_unaligned")
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
    splats, cam, target, icap, *_ = _scene("match_oracle")
    sd = to_torch_splats(splats)
    out, grads = _port_grads(sd, to_torch_camera(cam), target, icap, "cuda", tile_size=None)
    assert out.image.shape == (32, 32, 3) and float(out.image.detach().std()) > 0.01
    for k, g in grads.items():
        assert np.isfinite(g).all() and np.abs(g).max() > 0, k


def _binned(name, tile_size):
    """The port's training binning of a scene and blend_backward's
    arguments but tile_neff, with a seeded cotangent."""
    from lichtfeld_studio_tpu_torch.ops.rasterize import _project
    from lichtfeld_studio_tpu_torch.ops.tiles import build_tile_assignment

    splats, cam, _, icap, *_ = _scene(name)
    sd, params = to_torch_splats(splats), to_torch_camera(cam).device_params()
    with torch.no_grad():
        proj = _project(sd, params, tile_size=tile_size)
        kw = dict(grid_w=-(-params.width // tile_size), grid_h=-(-params.height // tile_size),
                  tile_size=tile_size)
        a = build_tile_assignment(proj, grid_w=kw["grid_w"], grid_h=kw["grid_h"],
                                  instance_cap=icap, need_grad=True)
    args = (a.tile_start, a.tile_count, a.gaussian_idx, proj.mean2d, proj.conic, proj.opacity,
            proj.color)
    rng = np.random.default_rng(tile_size)
    hp, wp = kw["grid_h"] * tile_size, kw["grid_w"] * tile_size
    d_image = torch.from_numpy(rng.normal(size=(hp, wp, 3)).astype(np.float32))
    d_alpha = torch.from_numpy(rng.normal(size=(hp, wp)).astype(np.float32))
    return a, args, kw, d_image, d_alpha


# the deep scene trims at 16-px tiles only: its 32-px tiles keep every window
@pytest.mark.parametrize("name,tile_size", [("deep_unaligned", 16), ("trim", 16), ("trim", 32)])
def test_trim_zeroes_only_the_tail(name, tile_size, monkeypatch):
    """Port against port: at eps 0 the training forward keeps every
    window and the rows are the full replay's bits; at 1/255 they are the
    same bits with the rows past trim_extent 0, and some of those were not
    0 (the trim engages)."""
    a, args, kw, d_image, d_alpha = _binned(name, tile_size)
    rows = {}
    for eps in (0.0, EPS):
        monkeypatch.setattr(kblend, "GRAD_SKIP_EPS", eps)
        _, _, t_final, last, tile_neff = kblend.blend_forward(*args, train=True, **kw)
        bwd = (*args[:3], a.slot_layout, *args[3:], t_final, last)
        rows[eps] = kblend.blend_backward(*bwd, tile_neff, d_image, d_alpha, **kw)
        if eps == 0.0:
            assert (tile_neff == kblend.FULL_REPLAY).all()
            full = torch.full_like(tile_neff, kblend.FULL_REPLAY)
            assert torch.equal(rows[eps], kblend.blend_backward(*bwd, full, d_image, d_alpha, **kw))
        else:
            kept = kblend.trim_extent(args[0], args[1], tile_neff)
    tail_slots = kblend.trim_tail_slots(args[0], args[1], tile_neff, a.slot_layout)
    assert tail_slots.numel() == int((args[1].long() - kept).sum())
    expect = rows[0.0].clone()
    expect[tail_slots] = 0.0
    assert torch.equal(rows[EPS], expect)
    assert rows[0.0][tail_slots].abs().amax() > 0
