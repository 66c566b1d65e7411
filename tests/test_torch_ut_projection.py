"""Port parity of the UT projection (lichtfeld_studio_tpu_torch/ops/
ut_projection.py) against the JAX package, for every camera model and both
rolling-shutter directions, on one scene made with numpy from a seed.

Tolerances: integer outputs (bbox, n_touched, valid, tile_mask) equal;
float outputs within 1e-5 relative; the gradients of a scalar function of
mean2d, conic and colour within 1e-4 of the largest, per parameter group
(the sums over sigma points run in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lichtfeld_studio_tpu.core.camera import ShutterType
from lichtfeld_studio_tpu.ops.ut_projection import project_gaussians_ut as j_project_ut
from lichtfeld_studio_tpu_torch.ops.ut_projection import project_gaussians_ut as t_project_ut
from tests.gut_cases import CASES, H, W, camera_case
from tests.scene_utils import make_camera, make_random_splats
from tests.torch_parity import np_, to_torch_params, to_torch_splats

GROUPS = ("means", "scaling", "rotation", "sh0", "shN")
INT_FIELDS = ("bbox", "n_touched", "valid", "tile_mask")
FLOAT_FIELDS = ("depth", "mean2d", "conic", "opacity", "color")


def _weights(n, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n, k)).astype(np.float32) for k in (2, 3, 3)]


def _scalar(proj, w, where):
    """sum of weighted mean2d, conic and colour over valid gaussians."""
    m = proj.valid[:, None]
    return sum((where(m, x * wi, 0.0)).sum() for x, wi in zip((proj.mean2d, proj.conic, proj.color), w))


def _jax_project(sd, params, **kw):
    args = (sd.active_mask(), sd.active_sh_degree, params.w2c, params.cam_position, params.K)
    extra = dict(width=params.width, height=params.height, camera_model=params.camera_model,
                 radial=params.radial, tangential=params.tangential, w2c_end=params.w2c_end,
                 shutter_type=params.shutter_type, **kw)

    def run(p):
        return j_project_ut(p["means"], p["scaling"], p["rotation"], sd.opacity, p["sh0"], p["shN"],
                            *args, **extra)
    return run


def _torch_project(ts, params, **kw):
    def run(p):
        return t_project_ut(
            p["means"], p["scaling"], p["rotation"], ts.opacity, p["sh0"], p["shN"],
            ts.active_mask(), ts.active_sh_degree, params.w2c, params.cam_position, params.K,
            width=params.width, height=params.height, camera_model=params.camera_model,
            radial=params.radial, tangential=params.tangential, w2c_end=params.w2c_end,
            shutter_type=params.shutter_type, **kw)
    return run


@pytest.mark.parametrize("exact_tile_test", [True, False], ids=["exact", "bbox"])
@pytest.mark.parametrize("case", CASES)
def test_ut_projection_matches_jax(case, exact_tile_test):
    rng = np.random.default_rng(CASES.index(case))
    sd = make_random_splats(rng, n=48, spread=1.0, sh_degree=2)
    params = camera_case(case)
    w = _weights(sd.capacity)
    kw = dict(tile_size=16, exact_tile_test=exact_tile_test)

    run_j = _jax_project(sd, params, **kw)
    p_j = {k: getattr(sd, k) for k in GROUPS}
    proj_j = run_j(p_j)
    grads_j = jax.grad(lambda p: _scalar(run_j(p), [jnp.asarray(x) for x in w], jnp.where))(p_j)

    ts = to_torch_splats(sd)
    run_t = _torch_project(ts, to_torch_params(params), **kw)
    p_t = {k: getattr(ts, k) for k in GROUPS}
    proj_t = run_t(p_t)
    grads_t = torch.autograd.grad(
        _scalar(proj_t, [torch.from_numpy(x) for x in w], torch.where), list(p_t.values()))

    valid = np.asarray(proj_j.valid)
    assert valid.sum() >= 10, "fixture: too few gaussians in view"
    for f in INT_FIELDS:
        np.testing.assert_array_equal(np_(getattr(proj_t, f)), np.asarray(getattr(proj_j, f)), err_msg=f)
    for f in FLOAT_FIELDS:
        a, b = np_(getattr(proj_t, f))[valid], np.asarray(getattr(proj_j, f))[valid]
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max(), err_msg=f)
    for k, g in zip(GROUPS, grads_t):
        ref = np.asarray(grads_j[k])
        scale = np.abs(ref).max()
        assert scale > 0 and np.isfinite(np_(g)).all(), k
        assert np.abs(np_(g) - ref).max() <= 1e-4 * scale, k


def test_rolling_shutter_identity_pose_matches_global():
    """Identical start and end poses: every rolling shutter reproduces the
    global projection (the fixed point is pose-independent)."""
    sd = to_torch_splats(make_random_splats(np.random.default_rng(1), n=48))
    p = to_torch_params(make_camera(W, H).device_params())
    args = (sd.means, sd.scaling, sd.rotation, sd.opacity, sd.sh0, sd.shN, sd.active_mask(),
            sd.active_sh_degree, p.w2c, p.cam_position, p.K)
    with torch.no_grad():
        base = t_project_ut(*args, width=W, height=H)
        for st in (ShutterType.ROLLING_TOP_TO_BOTTOM, ShutterType.ROLLING_LEFT_TO_RIGHT,
                   ShutterType.ROLLING_BOTTOM_TO_TOP, ShutterType.ROLLING_RIGHT_TO_LEFT):
            rs = t_project_ut(*args, width=W, height=H, w2c_end=p.w2c, shutter_type=st)
            v = base.valid & rs.valid
            assert int(v.sum()) > 10
            assert float((rs.mean2d[v] - base.mean2d[v]).abs().max()) <= 1e-3
