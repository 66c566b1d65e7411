"""The UT projection's kernels (kernels/ut_projection.py) on the CPU:
project_ut_backward_plain, the backward kernel's closed form in plain
PyTorch, against torch.autograd of ops/ut_projection.py::
project_gaussians_ut for every camera model and SH degree; the autograd
Function that binds the kernels, run on CPU tensors with the kernels' plain
versions, against the plain path; and the routing rule of
ops/rasterize.py::_project (ut_kernel_route). The kernels themselves run on
the card in tests/test_torch_kernels_cuda.py and chip_smoke.py's
[ut_projection] phase.

The scenes carry tests/torch_parity.py::PROJECTION_HAZARDS (gaussians
behind the camera and inside the near plane, a zero quaternion, opacities
at 1/255, dead slots). The backward differentiates depth, opacity and
colour alone, the outputs the exact world-space blend reads: in float64 its
closed form equals autograd to 1e-7 of each parameter's largest gradient,
and autograd gives the log-scales and the quaternion nothing."""

import dataclasses

import numpy as np
import pytest
import torch

from lichtfeld_studio_tpu_torch.kernels import projection as kproj
from lichtfeld_studio_tpu_torch.kernels import ut_projection as kut
from lichtfeld_studio_tpu_torch.ops import rasterize as rast
from lichtfeld_studio_tpu_torch.ops.ut_projection import project_gaussians_ut
from tests.torch_parity import (
    UT_CAMERA_MODELS,
    projection_inputs,
    projection_output_grads,
    random_scene,
    rolling_params,
    ut_camera_kwargs,
)

PARAMS = ("means", "log_scales", "quats", "logit_opacities", "sh0", "shN")
GRADS = ("means", "logit_opacities", "sh0", "shN")  # what the backward gives
W, H, N = 96, 64, 300
SH_CASES = [(0, 0), (3, 1), (8, 2), (15, 3)]  # (shN rows, active degree)


def _inputs(seed, model, *, n_rest=15, degree=3, dtype=torch.float32):
    args = projection_inputs(seed, n=N, n_rest=n_rest, degree=degree, dtype=dtype)
    K, kw = ut_camera_kwargs(model, args[10])
    return (*args[:10], K), kw


def _plain_backward(args, g_depth, g_opacity, g_color):
    means, _, _, logits, _, shn, _, degree, w2c, cam_pos, _ = args
    return kut.project_ut_backward_plain(means, logits, shn, degree, w2c, cam_pos, g_depth,
                                         g_opacity, g_color)


@pytest.mark.parametrize("with_depth", [False, True], ids=["rgb", "depth"])
@pytest.mark.parametrize("n_rest,degree", SH_CASES, ids=[f"deg{d}" for _, d in SH_CASES])
@pytest.mark.parametrize("model", UT_CAMERA_MODELS)
def test_ut_backward_plain_matches_autograd(model, n_rest, degree, with_depth):
    args, ckw = _inputs(3, model, n_rest=n_rest, degree=degree, dtype=torch.float64)
    g_depth, _, _, g_op, g_col = projection_output_grads(4, N, dtype=torch.float64)
    g_depth = g_depth if with_depth else None
    leaves = [a.clone().requires_grad_(True) for a in args[:6]]
    out = project_gaussians_ut(*leaves, *args[6:], width=W, height=H, **ckw)
    outs, gs = [out.opacity, out.color], [g_op, g_col]
    if with_depth:
        outs.append(out.depth)
        gs.append(g_depth)
    want = dict(zip(PARAMS, torch.autograd.grad(outs, leaves, gs, allow_unused=True)))
    # no gradient reaches the log-scales or the quaternion through these outputs
    assert want["log_scales"] is None and want["quats"] is None
    got = _plain_backward(args, g_depth, g_op, g_col)
    for name, g in zip(GRADS, got):
        a = args[PARAMS.index(name)]
        w = torch.zeros_like(a) if want[name] is None else want[name]
        assert g.shape == a.shape and g.dtype == a.dtype, name
        assert torch.isfinite(g).all() and torch.isfinite(w).all(), name
        scale = float(w.abs().max()) if w.numel() else 0.0
        err = float((g - w).abs().max()) if w.numel() else 0.0
        assert err <= 1e-7 * scale, f"{name}: {err} > 1e-7 of {scale}"


@pytest.mark.parametrize("exact", [True, False], ids=["exact-tiles", "bbox"])
@pytest.mark.parametrize("model", UT_CAMERA_MODELS)
def test_ut_function_matches_plain_path(model, exact):
    """The Function on CPU tensors (the kernels' plain versions): the plain
    path's outputs bit for bit, and its gradients the closed form's; mean2d
    stays in the graph (the ADC statistics name it) with no gradient."""
    args, ckw = _inputs(5, model)
    kw = dict(width=W, height=H, tile_size=16, exact_tile_test=exact, **ckw)
    with torch.no_grad():
        ref = project_gaussians_ut(*args, **kw)
    assert int(ref.valid.sum()) > N // 2
    leaves = [a.clone().requires_grad_(True) for a in args[:6]]
    out = kut.project_ut(*leaves, *args[6:], **kw)
    for f in dataclasses.fields(ref):
        torch.testing.assert_close(getattr(out, f.name), getattr(ref, f.name), rtol=0, atol=0,
                                   msg=f.name)
    assert out.mean2d.requires_grad and out.color.requires_grad
    assert not (out.bbox.requires_grad or out.valid.requires_grad or out.tile_mask.requires_grad)
    g_depth, _, _, g_op, g_col = projection_output_grads(6, N)
    loss = (out.depth * g_depth).sum() + (out.opacity * g_op).sum() + (out.color * g_col).sum()
    got = dict(zip((*PARAMS, "mean2d"),
                   torch.autograd.grad(loss, [*leaves, out.mean2d], allow_unused=True)))
    assert got["log_scales"] is None and got["quats"] is None and got["mean2d"] is None
    for name, w in zip(GRADS, _plain_backward(args, g_depth, g_op, g_col)):
        torch.testing.assert_close(got[name], w, rtol=0, atol=0, msg=name)


def test_ut_function_refuses_a_gradient_through_mean2d():
    """The kernels give none: a loss on mean2d or conic is the plain path's
    to differentiate, and the Function says so instead of returning zeros."""
    args, ckw = _inputs(7, "pinhole")
    leaves = [a.clone().requires_grad_(True) for a in args[:6]]
    out = kut.project_ut(*leaves, *args[6:], width=W, height=H, **ckw)
    for field in ("mean2d", "conic"):
        with pytest.raises(RuntimeError, match="mean2d or conic"):
            torch.autograd.grad(getattr(out, field).sum(), [leaves[0]])


# case -> (rasterize's keyword arguments, what changes on the camera, takes the kernels)
ROUTE_CASES = {
    "gut_exact": (dict(gut_exact=True), None, True),
    "inference": (dict(inference=True), None, True),
    "2d_blend_training": ({}, None, False),
    "rolling_shutter": (dict(gut_exact=True), "rolling", False),
    "antialiasing": (dict(gut_exact=True, antialiasing=True), None, False),
    "pose_gradient": (dict(gut_exact=True), "pose", False),
    "cpu": (dict(gut_exact=True), "cpu", False),
}


@pytest.mark.parametrize("case", ROUTE_CASES)
def test_ut_projection_route(monkeypatch, case):
    """rasterize's UT projection on a routed device (every device but the
    CPU's is made to look like the card): the exact path and an inference
    render take the Function; the 2D blend's training path, a rolling
    shutter, antialiasing, a camera that needs a gradient and CPU tensors
    keep the plain path. Where the Function is taken, the render's gradients
    are the plain route's."""
    kw, change, expect = ROUTE_CASES[case]
    sd, cam = random_scene(np.random.default_rng(9), n=200)
    params = cam.device_params("cpu")
    if change == "rolling":
        params = rolling_params(params)
    elif change == "pose":
        params = dataclasses.replace(params, w2c=params.w2c.clone().requires_grad_(True))
    if change != "cpu":
        monkeypatch.setattr(kproj, "_on_cuda", lambda t: True)
    calls = []
    real = rast.project_ut

    def spy(*a, **k):
        calls.append(k)
        return real(*a, **k)

    monkeypatch.setattr(rast, "project_ut", spy)
    bg = torch.tensor([0.1, 0.2, 0.3])
    leaves = [sd.means, sd.scaling, sd.rotation, sd.opacity, sd.sh0, sd.shN]

    def render():
        return rast.rasterize(sd, params, bg, mode="cuda", projection="ut", with_depth=True, **kw)

    if kw.get("inference"):
        with torch.no_grad():
            render()
        assert len(calls) == int(expect)
        return
    out = render()
    assert len(calls) == int(expect)
    loss = out.image.square().sum() + out.depth.sum()
    got = torch.autograd.grad(loss, leaves)
    if expect:  # the same render through the plain path
        monkeypatch.setattr(rast, "ut_kernel_route", lambda *a, **k: False)
        out = render()
        want = torch.autograd.grad(out.image.square().sum() + out.depth.sum(), leaves)
        assert len(calls) == 1
        for name, g, w in zip(PARAMS, got, want):  # float32 in another order
            assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max()), name
