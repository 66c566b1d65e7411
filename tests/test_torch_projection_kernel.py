"""The EWA projection's kernels (kernels/projection.py) on the CPU:
project_ewa_backward_plain, the backward kernel's closed form in plain
PyTorch, against torch.autograd of ops/projection.py::project_gaussians;
the autograd Function that binds the kernels, run on CPU tensors with the
kernels' plain versions, against the plain path; and the routing rule of
ops/rasterize.py::_project (the UT projection's: tests/
test_torch_ut_projection_kernel.py). The kernels themselves run on the card in
tests/test_torch_kernels_cuda.py and chip_smoke.py's [projection] phase.

Every scene carries the hazards of tests/torch_parity.py::
PROJECTION_HAZARDS: gaussians behind the camera, inside the near plane and
outside the clamped frustum, a zero quaternion, opacities just under and
just over 1/255, zero variances (the compensation's determinant is 0, so
_safe_sqrt's gradient must be 0, not NaN), needles whose determinant comes
from cancellation (the only way below the 1e-8 cut: the +0.3 dilation keeps
a covariance's determinant above 0.09) and zeroed dead slots. In float64
the closed form equals autograd to 1e-7 of each output's largest gradient.
In float32 both are held to the float64 gradient, each gaussian to 1e-4 of
its largest, but for the needles and the gaussians inside the near plane,
whose gradients float32 does not resolve."""

import dataclasses

import numpy as np
import pytest
import torch

from lichtfeld_studio_tpu_torch.core.camera import CameraParams
from lichtfeld_studio_tpu_torch.kernels import projection as kproj
from lichtfeld_studio_tpu_torch.ops import rasterize as rast
from lichtfeld_studio_tpu_torch.ops.projection import project_gaussians
from tests.torch_parity import (
    PROJECTION_CASES,
    PROJECTION_HAZARDS,
    PROJECTION_ILL_CONDITIONED,
    projection_case_id,
    projection_inputs,
    projection_output_grads,
    random_scene,
)

OUTPUTS = ("depth", "mean2d", "conic", "opacity", "color")
PARAMS = ("means", "log_scales", "quats", "logit_opacities", "sh0", "shN")
W, H, N = 96, 64, 300


def _autograd(args, grads, **kw):
    """torch.autograd of the plain path: the gradients of PARAMS."""
    leaves = [a.clone().requires_grad_(True) for a in args[:6]]
    out = project_gaussians(*leaves, *args[6:], **kw)
    return torch.autograd.grad([getattr(out, k) for k in OUTPUTS], leaves, grads,
                               allow_unused=True)


def _plain_backward(args, grads, aa):
    means, log_s, quats, logits, _, shn, _, degree, w2c, cam_pos, k = args
    return kproj.project_ewa_backward_plain(means, log_s, quats, logits, shn, degree, w2c,
                                            cam_pos, k, *grads, width=W, height=H,
                                            antialiasing=aa)


def _per_gaussian_err(got, want, truth):
    """Largest |got - want| of each gaussian over its largest |truth|."""
    flat = lambda t: t.reshape(t.shape[0], -1).double()  # noqa: E731
    scale = flat(truth).abs().amax(-1).clamp(min=1e-30)
    return (flat(got) - flat(want)).abs().amax(-1) / scale


@pytest.mark.parametrize("case", PROJECTION_CASES, ids=projection_case_id)
def test_projection_backward_plain_matches_autograd(case):
    n_rest, degree, aa, ts, cap, dilate = case
    kw = dict(width=W, height=H, tile_size=ts, antialiasing=aa, exact_tile_cap=cap,
              dilate_px=dilate)
    # float64: the closed form is autograd's algebra
    args = projection_inputs(3, n=N, n_rest=n_rest, degree=degree, dtype=torch.float64)
    grads = projection_output_grads(4, N, dtype=torch.float64)
    want = _autograd(args, grads, **kw)
    got = _plain_backward(args, grads, aa)
    truth = {}
    for name, g, w, a in zip(PARAMS, got, want, args):
        w = torch.zeros_like(a) if w is None else w  # shN with no rows
        assert g.shape == a.shape and g.dtype == a.dtype, name
        assert torch.isfinite(g).all() and torch.isfinite(w).all(), name
        scale = float(w.abs().max()) if w.numel() else 0.0
        err = float((g - w).abs().max()) if w.numel() else 0.0
        assert err <= 1e-7 * scale, f"{name}: {err} > 1e-7 of {scale}"
        truth[name] = w
    # the zero-variance slots: _safe_sqrt's branch gives 0 to the log-scales, not NaN
    zero_var = list(PROJECTION_HAZARDS["zero variance (det_raw 0)"])
    assert (got[1][zero_var] == 0).all()
    # float32: both held to the float64 gradient, gaussian by gaussian
    args32 = tuple(a.float() if a.is_floating_point() else a for a in args)
    grads32 = tuple(g.float() for g in grads)
    got32 = _plain_backward(args32, grads32, aa)
    want32 = _autograd(args32, grads32, **kw)
    keep = torch.ones(N, dtype=torch.bool)
    keep[PROJECTION_ILL_CONDITIONED] = False
    for name, g, w in zip(PARAMS, got32, want32):
        if truth[name].numel() == 0:
            continue
        assert torch.isfinite(g).all(), name
        for which, x in (("closed form", g), ("autograd", w)):
            err = _per_gaussian_err(x, truth[name], truth[name])[keep]
            assert float(err.max()) <= 1e-4, f"{name}, {which} in float32: {float(err.max())}"


@pytest.mark.parametrize("case", PROJECTION_CASES, ids=projection_case_id)
def test_projection_function_matches_plain_path(case):
    """The Function on CPU tensors (the kernels' plain versions): the plain
    path's outputs, and gradients through it, d mean2d (the ADC statistics'
    input) among them."""
    n_rest, degree, aa, ts, cap, dilate = case
    kw = dict(width=W, height=H, tile_size=ts, antialiasing=aa, exact_tile_cap=cap,
              dilate_px=dilate)
    args = projection_inputs(5, n=N, n_rest=n_rest, degree=degree)
    grads = projection_output_grads(6, N)
    with torch.no_grad():
        ref = project_gaussians(*args, **kw)
    leaves = [a.clone().requires_grad_(True) for a in args[:6]]
    out = kproj.project_ewa(*leaves, *args[6:], **kw)
    for f in dataclasses.fields(ref):
        torch.testing.assert_close(getattr(out, f.name), getattr(ref, f.name), rtol=0, atol=0,
                                   msg=f.name)
    assert not (out.bbox.requires_grad or out.valid.requires_grad)
    loss = sum((getattr(out, k) * g).sum() for k, g in zip(OUTPUTS, grads))
    got = torch.autograd.grad(loss, [*leaves, out.mean2d])
    want = _plain_backward(args, grads, aa)
    for name, g, w in zip(PARAMS, got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)
    torch.testing.assert_close(got[-1], grads[1], rtol=0, atol=0, msg="d mean2d")


@pytest.mark.parametrize("needs_grad,expect", [
    (None, True), ("w2c", False), ("cam_position", False), ("K", False)])
def test_projection_kernel_route(monkeypatch, needs_grad, expect):
    """The kernels take the EWA projection on the card unless the camera
    needs a gradient; CPU tensors keep the plain path."""
    args = projection_inputs(7, n=40)
    cam = dict(zip(("w2c", "cam_position", "K"), (t.clone() for t in args[8:])))
    if needs_grad:
        cam[needs_grad].requires_grad_(True)
    assert kproj.kernel_route(args[0], **cam) is False  # CPU tensors
    monkeypatch.setattr(kproj, "_on_cuda", lambda t: True)
    assert kproj.kernel_route(args[0], **cam) is expect


@pytest.mark.parametrize("projection", ["ewa", "ut"])
def test_projection_render_route(monkeypatch, projection):
    """rasterize's projection on a routed device, through its Function with
    gradients equal to the plain path's: EWA on the 2D blend's training
    path, UT on the exact world-space path (--gut-exact, where mean2d takes
    no gradient on either route); a posed camera (w2c requiring grad)
    through the plain path."""
    route, name, extra = (("kernel_route", "project_ewa", {}) if projection == "ewa"
                          else ("ut_kernel_route", "project_ut", dict(gut_exact=True)))
    sd, cam = random_scene(np.random.default_rng(8), n=200)
    params = cam.device_params("cpu")
    calls = []
    real = getattr(rast, name)

    def spy(*a, **k):
        calls.append(k)
        return real(*a, **k)

    bg = torch.tensor([0.1, 0.2, 0.3])

    def grads_of(routed, camera):
        monkeypatch.setattr(rast, route,
                            lambda *a, **k: routed and not camera.w2c.requires_grad)
        monkeypatch.setattr(rast, name, spy)
        out = rast.rasterize(sd, camera, bg, mode="cuda", projection=projection, with_depth=True,
                             **extra)
        loss = out.image.square().sum() + out.depth.sum()
        return torch.autograd.grad(loss, [sd.means, sd.scaling, sd.rotation, sd.opacity, sd.sh0,
                                          sd.shN, out.mean2d], allow_unused=True)

    plain = grads_of(False, params)
    assert calls == []
    routed = grads_of(True, params)
    assert len(calls) == 1
    for name_, p, r in zip((*PARAMS, "mean2d"), plain, routed):  # float32 in another order
        if projection == "ut" and name_ == "mean2d":
            assert p is None and r is None
            continue
        assert float((r - p).abs().max()) <= 1e-4 * float(p.abs().max()), name_
    calls.clear()
    posed = CameraParams(**{**params.__dict__, "w2c": params.w2c.clone().requires_grad_(True)})
    grads_of(True, posed)
    assert calls == []
