"""Port parity: EWA projection, SH colour and cov3d of
lichtfeld_studio_tpu_torch against the JAX package on the same numpy
inputs. Floats to rtol 1e-5 / atol 1e-5 (float32 arithmetic in another
order); bbox, n_touched, valid and tile_mask exactly equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lichtfeld_studio_tpu.ops import gaussians as jgauss
from lichtfeld_studio_tpu.ops import sh as jsh
from lichtfeld_studio_tpu.ops.projection import project_gaussians as j_project
from lichtfeld_studio_tpu_torch.ops import gaussians as tgauss
from lichtfeld_studio_tpu_torch.ops import sh as tsh
from lichtfeld_studio_tpu_torch.ops.projection import project_gaussians as t_project
from tests.scene_utils import make_camera, make_random_splats
from tests.torch_parity import np_, to_torch_splats

TOL = dict(rtol=1e-5, atol=1e-5)


def _scene(rng):
    """Random splats plus hazards: dead slots, gaussians behind the
    camera, one degenerate quaternion."""
    sd = make_random_splats(rng, n=80, capacity=96, spread=1.5)
    means = np.asarray(sd.means).copy()
    means[70:75, 2] = -6.0  # behind the camera (eye at z = -4)
    rot = np.asarray(sd.rotation).copy()
    rot[5] = 0.0
    return dataclasses.replace(sd, means=jnp.asarray(means), rotation=jnp.asarray(rot))


@pytest.mark.parametrize("tile_size,exact_cap", [(16, 32), (32, 16)])
def test_project_gaussians_matches_jax(rng, tile_size, exact_cap):
    sd = _scene(rng)
    cam = make_camera(96, 64)
    cp = cam.device_params()
    common = dict(width=cam.width, height=cam.height, tile_size=tile_size,
                  exact_tile_cap=exact_cap)
    pj = jax.jit(j_project, static_argnames=tuple(common))(
        sd.means, sd.scaling, sd.rotation, sd.opacity, sd.sh0, sd.shN,
        sd.active_mask(), sd.active_sh_degree, cp.w2c, cp.cam_position, cp.K, **common,
    )
    ts = to_torch_splats(sd)
    with torch.no_grad():
        pt = t_project(
            ts.means, ts.scaling, ts.rotation, ts.opacity, ts.sh0, ts.shN,
            ts.active_mask(), ts.active_sh_degree,
            torch.tensor(np.asarray(cp.w2c)), torch.tensor(np.asarray(cp.cam_position)),
            torch.tensor(np.asarray(cp.K)), **common,
        )
    for name in ("valid", "bbox", "n_touched", "tile_mask"):
        np.testing.assert_array_equal(np_(getattr(pt, name)), np_(getattr(pj, name)), err_msg=name)
    assert np_(pt.valid).sum() > 40  # the scene really exercises the path
    valid = np_(pj.valid)
    for name in ("depth", "opacity", "color"):
        np.testing.assert_allclose(np_(getattr(pt, name)), np_(getattr(pj, name)), err_msg=name, **TOL)
    for name in ("mean2d", "conic"):  # only defined where valid
        np.testing.assert_allclose(
            np_(getattr(pt, name))[valid], np_(getattr(pj, name))[valid], err_msg=name, **TOL
        )


def test_sh_matches_jax(rng):
    dirs = rng.normal(size=(50, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    np.testing.assert_allclose(
        np_(tsh.eval_sh_bases(torch.from_numpy(dirs))),
        np_(jsh.eval_sh_bases(jnp.asarray(dirs))), **TOL,
    )
    sh0 = rng.normal(size=(50, 1, 3)).astype(np.float32)
    shn = rng.normal(size=(50, 15, 3)).astype(np.float32)
    means = rng.normal(size=(50, 3)).astype(np.float32)
    cam = np.array([0.5, -1.0, 3.0], np.float32)
    for degree in range(4):
        np.testing.assert_allclose(
            np_(tsh.sh_to_color(*map(torch.from_numpy, (sh0, shn, means, cam)), degree)),
            np_(jsh.sh_to_color(*map(jnp.asarray, (sh0, shn, means, cam)), jnp.int32(degree))),
            err_msg=f"degree {degree}", **TOL,
        )


def test_cov3d_matches_jax(rng):
    quat = rng.normal(size=(40, 4)).astype(np.float32)
    log_s = rng.uniform(-4, 0, (40, 3)).astype(np.float32)
    np.testing.assert_allclose(
        np_(tgauss.quat_to_rotmat(torch.from_numpy(quat))),
        np_(jgauss.quat_to_rotmat(jnp.asarray(quat))), **TOL,
    )
    np.testing.assert_allclose(
        np_(tgauss.quat_scale_to_cov3d(torch.from_numpy(quat), torch.from_numpy(log_s))),
        np_(jgauss.quat_scale_to_cov3d(jnp.asarray(quat), jnp.asarray(log_s))), **TOL,
    )
