"""Port parity for SplatData.from_point_cloud (host numpy + cKDTree on both
sides: 1e-6) and the shapes, ranges and padding of SplatData.random_init
(the two packages' random streams differ: statistics, not bits)."""

import jax
import numpy as np
import pytest
import torch

from lichtfeld_studio_tpu.core.splat_data import SplatData as JSplatData
from lichtfeld_studio_tpu_torch.core.splat_data import SplatData as TSplatData
from tests.torch_parity import np_

GROUPS = ("means", "sh0", "shN", "scaling", "rotation", "opacity")


@pytest.mark.parametrize("n,capacity,degree", [(300, 512, 3), (1, 4, 0), (64, 64, 2)])
def test_from_point_cloud_matches_jax(rng, n, capacity, degree):
    pos = rng.normal(0, 1.5, (n, 3)).astype(np.float32)
    if n > 10:
        pos[5] = pos[4]  # a coincident pair: d^2 <= 1e-8 is no neighbour
    col = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    center = rng.normal(0, 0.1, 3).astype(np.float32)
    kw = dict(capacity=capacity, max_sh_degree=degree, init_opacity=0.3, init_scaling=0.2)
    want = JSplatData.from_point_cloud(pos, col, center, **kw)
    got = TSplatData.from_point_cloud(pos, col, center, **kw)
    for k in GROUPS:
        assert getattr(got, k).shape == getattr(want, k).shape, k
        np.testing.assert_allclose(np_(getattr(got, k)), np.asarray(getattr(want, k)),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    assert int(got.n_active) == int(want.n_active) == n
    assert int(got.active_sh_degree) == int(want.active_sh_degree) == 0
    assert got.max_sh_degree == want.max_sh_degree == degree
    np.testing.assert_allclose(got.scene_scale, want.scene_scale, rtol=1e-6)
    # the dead slots are padded as the JAX package pads them
    assert (np_(got.scaling[n:]) == -10.0).all() and (np_(got.opacity[n:]) == -15.0).all()
    assert (np_(got.rotation[n:]) == [1.0, 0.0, 0.0, 0.0]).all()


def test_from_point_cloud_refuses_overflow(rng):
    with pytest.raises(ValueError, match="exceeds capacity"):
        TSplatData.from_point_cloud(np.zeros((5, 3), np.float32), np.zeros((5, 3), np.float32),
                                    np.zeros(3), capacity=4)


def test_random_init_shapes_ranges_and_padding():
    n, cap, extent = 2000, 4096, 3.0
    kw = dict(num_points=n, extent=extent, capacity=cap, max_sh_degree=3, init_opacity=0.5,
              init_scaling=0.1)
    got = TSplatData.random_init(torch.Generator().manual_seed(0), **kw)
    want = JSplatData.random_init(jax.random.PRNGKey(0), **kw)
    for k in GROUPS:
        assert getattr(got, k).shape == getattr(want, k).shape, k
        assert getattr(got, k).dtype == torch.float32
    assert int(got.n_active) == n and int(got.active_sh_degree) == 0 and got.capacity == cap
    # scene_scale: the median norm of the UNSCALED uniform cloud; positions stretched by it
    assert abs(got.scene_scale / want.scene_scale - 1.0) < 0.05
    means = np_(got.means[:n])
    assert np.abs(means).max() <= extent * got.scene_scale
    assert np.abs(means).max() > 0.9 * extent * got.scene_scale
    np.testing.assert_allclose(means.mean(0), 0.0, atol=0.15 * extent * got.scene_scale)
    np.testing.assert_allclose(means.std(0), np.asarray(want.means[:n]).std(0), rtol=0.1)
    colors = np_(got.sh0[:n, 0]) * 0.28209479177387814 + 0.5
    assert colors.min() >= 0.0 and colors.max() <= 1.0 and abs(colors.mean() - 0.5) < 0.05
    np.testing.assert_allclose(np_(got.opacity[:n]), 0.0, atol=1e-6)  # logit(0.5)
    np.testing.assert_allclose(np_(got.scaling[:n]).mean(), np.asarray(want.scaling[:n]).mean(),
                               atol=0.1)
    assert (np_(got.means[n:]) == 0).all() and (np_(got.opacity[n:]) == -15.0).all()
    assert (np_(got.scaling[n:]) == -10.0).all() and (np_(got.shN) == 0).all()
    # the same seed gives the same model; another seed another
    again = TSplatData.random_init(torch.Generator().manual_seed(0), **kw)
    other = TSplatData.random_init(torch.Generator().manual_seed(1), **kw)
    assert torch.equal(again.means, got.means) and not torch.equal(other.means, got.means)
