"""The port's k-means and SOG format against the JAX package's: k-means
labels and centroids on the same inputs (the N-D init injected from
jax.random.choice), Morton codes and quaternion packing bit for bit, SOG
files read both ways across the packages, and the reference's SOG cases of
tests/test_io_formats.py on the port."""

import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lichtfeld_studio_tpu.io import sog as j_sog
from lichtfeld_studio_tpu.ops.kmeans import kmeans_1d as j_kmeans_1d
from lichtfeld_studio_tpu.ops.kmeans import kmeans_nd as j_kmeans_nd
from lichtfeld_studio_tpu_torch.core.point_cloud import PointCloud
from lichtfeld_studio_tpu_torch.io import sog as t_sog
from lichtfeld_studio_tpu_torch.ops.kmeans import kmeans_1d, kmeans_nd
from tests.scene_utils import make_random_splats

FIELDS = ("means", "sh0", "shN", "opacity", "scaling", "rotation")


def _pc(rng, n=200) -> PointCloud:
    j = make_random_splats(rng, n=n).to_point_cloud()
    return PointCloud(**{k: getattr(j, k) for k in FIELDS})


def _assert_roundtrip(pc, pc2):
    """tests/test_io_formats.py::test_sog_roundtrip's bounds (SOG is lossy)."""
    assert pc2.size == pc.size
    o1 = np.argsort(pc.means[:, 0] + 1e-3 * pc.means[:, 1])
    o2 = np.argsort(pc2.means[:, 0] + 1e-3 * pc2.means[:, 1])
    np.testing.assert_allclose(pc2.means[o2], pc.means[o1], atol=5e-3)
    np.testing.assert_allclose(
        np.sort(pc2.scaling.reshape(-1)), np.sort(pc.scaling.reshape(-1)), atol=0.1
    )
    s1 = 1 / (1 + np.exp(-np.sort(pc.opacity.reshape(-1))))
    s2 = 1 / (1 + np.exp(-np.sort(pc2.opacity.reshape(-1))))
    np.testing.assert_allclose(s2, s1, atol=0.01)


# --- k-means -------------------------------------------------------------

@pytest.mark.parametrize("n,k", [(1000, 64), (600, 256)])
def test_kmeans_1d_matches_jax(n, k):
    values = np.random.default_rng(n).normal(0, 1, n).astype(np.float32)
    c_j, l_j = j_kmeans_1d(jnp.asarray(values), k=k, iterations=10)
    c_t, l_t = kmeans_1d(torch.from_numpy(values), k=k, iterations=10)
    np.testing.assert_array_equal(l_t.numpy(), np.asarray(l_j))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n,d,k", [(300, 45, 32), (200, 9, 200)])
def test_kmeans_nd_matches_jax_with_its_init(n, d, k):
    points = np.random.default_rng(d).normal(0, 1, (n, d)).astype(np.float32)
    c_j, l_j = j_kmeans_nd(jnp.asarray(points), k=k, iterations=10, seed=0)
    # the JAX package's init draw (ops/kmeans.py:46-47), injected
    init = np.array(jax.random.choice(jax.random.PRNGKey(0), n, (k,), replace=False))
    c_t, l_t = kmeans_nd(torch.from_numpy(points), k, iterations=10,
                         init_idx=torch.from_numpy(init))
    np.testing.assert_array_equal(l_t.numpy(), np.asarray(l_j))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-5, atol=1e-5)


def test_kmeans_nd_chunks_and_default_init(monkeypatch):
    """The distance chunks (a handful of points per chunk here) give the
    labels of one piece; the default init draws k distinct points."""
    from lichtfeld_studio_tpu_torch.ops import kmeans as t_kmeans

    points = torch.from_numpy(np.random.default_rng(5).normal(0, 1, (257, 6)).astype(np.float32))
    whole = kmeans_nd(points, 16, iterations=4, seed=3)
    monkeypatch.setattr(t_kmeans, "_DIST_CHUNK_ELEMS", 16 * 7)
    chunked = kmeans_nd(points, 16, iterations=4, seed=3)
    torch.testing.assert_close(chunked[0], whole[0], rtol=0, atol=0)
    assert torch.equal(chunked[1], whole[1])
    assert len(torch.unique(chunked[1])) > 1
    gen = torch.Generator().manual_seed(3)
    init = torch.randperm(257, generator=gen)[:16]
    assert len(set(init.tolist())) == 16


# --- the SOG helpers --------------------------------------------------------

def test_morton_and_quat_packing_match_jax(rng):
    pts = rng.uniform(-2, 3, (500, 3)).astype(np.float32)
    np.testing.assert_array_equal(t_sog.morton_encode(pts), j_sog.morton_encode(pts))
    q = rng.normal(0, 1, (500, 4)).astype(np.float32)
    q[::7, 2] = 0.0  # ties and zeros among the components
    packed = t_sog._pack_quats(q)
    np.testing.assert_array_equal(packed, j_sog._pack_quats(q))
    np.testing.assert_array_equal(t_sog._unpack_quats(packed), j_sog._unpack_quats(packed))
    v = rng.normal(0, 3, 100).astype(np.float32)
    np.testing.assert_array_equal(t_sog._inv_log_transform(t_sog._log_transform(v)),
                                  j_sog._inv_log_transform(j_sog._log_transform(v)))


def test_quat_pack_roundtrip(rng):
    q = rng.normal(0, 1, (128, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q2 = t_sog._unpack_quats(t_sog._pack_quats(q))
    # sign-canonicalised comparison (q and -q are the same rotation)
    dots = np.abs(np.sum(q * q2, axis=1))
    assert np.all(dots > 0.9995), dots.min()


def test_morton_locality(rng):
    pts = rng.uniform(-1, 1, (256, 3)).astype(np.float32)
    order = np.argsort(t_sog.morton_encode(pts))
    d = np.linalg.norm(np.diff(pts[order], axis=0), axis=1)
    d_rand = np.linalg.norm(np.diff(pts, axis=0), axis=1)
    assert d.mean() < d_rand.mean()  # sorted order is spatially coherent


# --- SOG files across the packages ---------------------------------------------

@pytest.mark.slow
def test_sog_roundtrip(rng, tmp_path):
    pc = _pc(rng, n=200)
    path = tmp_path / "splat.sog"
    t_sog.write_sog(pc, path, kmeans_iterations=8, device="cpu")
    _assert_roundtrip(pc, t_sog.read_sog(path))


def test_sog_roundtrip_directory(rng, tmp_path):
    """The port alone, n = 200, into a directory bundle: is_sog, the
    round-trip bounds, the rotations up to sign and the SH-1 palette."""
    pc = _pc(rng, n=200)
    out = tmp_path / "bundle"
    t_sog.write_sog(pc, out, kmeans_iterations=8, device="cpu")
    assert t_sog.is_sog(out) and not t_sog.is_sog(tmp_path)
    pc2 = t_sog.read_sog(out)
    _assert_roundtrip(pc, pc2)
    order = np.argsort(t_sog.morton_encode(pc.means))  # the writer's order
    dots = np.abs(np.sum(pc.rotation[order] * pc2.rotation, axis=1))
    assert np.all(dots > 0.9995), dots.min()
    assert pc2.shN.shape == pc.shN.shape
    assert np.abs(pc2.shN - pc.shN[order]).max() < 0.05


def test_port_reads_a_jax_sog_as_jax_does(rng, tmp_path):
    pc = _pc(rng, n=200)
    path = tmp_path / "jax.sog"
    j_sog.write_sog(pc, path, kmeans_iterations=8)
    assert t_sog.is_sog(path)
    got, want = t_sog.read_sog(path), j_sog.read_sog(path)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)


def test_jax_reads_a_port_sog_within_the_roundtrip_bounds(rng, tmp_path):
    pc = _pc(rng, n=200)
    t_path, j_path = tmp_path / "port.sog", tmp_path / "jax.sog"
    t_sog.write_sog(pc, t_path, kmeans_iterations=8, device="cpu")
    back = j_sog.read_sog(t_path)
    _assert_roundtrip(pc, back)
    # the SH palette's pixels are in the order the readers read (the JAX
    # package's writer scrambles them: see io/sog.py's palette comment)
    order = np.argsort(t_sog.morton_encode(pc.means))
    assert np.abs(back.shN - pc.shN[order]).max() < 0.05
    # the same ZIP names and meta.json keys as the JAX package's, and the
    # same bytes for every image that no N-D k-means draw decides
    j_sog.write_sog(pc, j_path, kmeans_iterations=8)
    with zipfile.ZipFile(t_path) as zt, zipfile.ZipFile(j_path) as zj:
        assert zt.namelist() == zj.namelist()
        mt, mj = json.loads(zt.read("meta.json")), json.loads(zj.read("meta.json"))
        assert {k: sorted(v) if isinstance(v, dict) else v for k, v in mt.items()} == \
            {k: sorted(v) if isinstance(v, dict) else v for k, v in mj.items()}
        for name in ("means_l.webp", "means_u.webp", "quats.webp", "scales.webp", "sh0.webp"):
            assert zt.read(name) == zj.read(name), name
        np.testing.assert_allclose(mt["scales"]["codebook"], mj["scales"]["codebook"],
                                   rtol=1e-6, atol=1e-7)


def test_sog_without_webp_raises(rng, tmp_path, monkeypatch):
    from PIL import features

    monkeypatch.setattr(features, "check", lambda name: False)
    with pytest.raises(RuntimeError, match="WebP"):
        t_sog.write_sog(_pc(rng, n=20), tmp_path / "x.sog", kmeans_iterations=1, device="cpu")
    assert not (tmp_path / "x.sog").exists()


def test_cli_reports_a_corrupt_sog(tmp_path, capsys):
    from lichtfeld_studio_tpu_torch import cli

    bad = tmp_path / "bad.sog"
    bad.write_bytes(b"not a zip")
    assert cli.main(["-v", str(bad), "--render-output", str(tmp_path / "x.png")]) == 2
    assert "could not load" in capsys.readouterr().err
    assert not (tmp_path / "x.png").exists()
