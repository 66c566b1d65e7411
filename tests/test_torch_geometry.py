"""The port's geometry, project registry and scene edits against the JAX
package's: BoundingBox, EuclideanTransform, SplatData.crop_by_bbox and
transformed on the same inputs within 1e-6; the reference's cases of
tests/test_geometry_project.py and tests/test_splat_edit.py on the port;
SplatData.version counts every in-place write."""

import json

import numpy as np
import pytest
import torch

from lichtfeld_studio_tpu.core import geometry as j_geo
from lichtfeld_studio_tpu_torch.core.geometry import BoundingBox, EuclideanTransform
from lichtfeld_studio_tpu_torch.core.project import CURRENT_VERSION, Project
from lichtfeld_studio_tpu_torch.ops.gaussians import quat_to_rotmat
from tests.scene_utils import make_random_splats
from tests.torch_parity import np_, to_torch_splats

SPLAT_FIELDS = ("means", "sh0", "shN", "scaling", "rotation", "opacity")


# --- tests/test_geometry_project.py on the port --------------------------------

def test_se3_roundtrip(rng):
    for _ in range(8):
        q = rng.normal(0, 1, 4)
        q /= np.linalg.norm(q)
        t = rng.normal(0, 2, 3)
        tf = EuclideanTransform(q, t)
        m = tf.to_matrix()
        np.testing.assert_allclose(EuclideanTransform.from_matrix(m).to_matrix(), m, atol=1e-10)
        ident = tf.compose(tf.inverse()).to_matrix()
        np.testing.assert_allclose(ident, np.eye(4), atol=1e-10)


def test_se3_apply(rng):
    tf = EuclideanTransform.from_euler(0.0, 0.0, np.pi / 2, [1.0, 0.0, 0.0])
    out = tf.apply(np.array([[1.0, 0.0, 0.0]]))
    np.testing.assert_allclose(out, [[1.0, 1.0, 0.0]], atol=1e-12)


def test_bbox(rng):
    pts = rng.uniform(-2, 2, (64, 3))
    bb = BoundingBox.from_points(pts)
    assert bb.contains(pts).all()
    inner = BoundingBox(np.array([-1.0, -1.0, -1.0]), np.array([1.0, 1.0, 1.0]))
    frac = inner.contains(pts).mean()
    assert 0 < frac < 1


def test_project_roundtrip(tmp_path):
    p = Project.create(tmp_path / "proj", "myproj", "data", "out", {"iterations": 100})
    p.add_ply("splat_100", "out/splat_100.ply", 100)
    p2 = Project.load(p.path)
    assert p2.data["project_name"] == "myproj"
    assert p2.data["version"] == CURRENT_VERSION
    assert p2.plys()[0].iteration == 100


def test_project_v1_migration(tmp_path):
    path = tmp_path / "legacy.lfs"
    path.write_text(json.dumps({"version": 1, "project_name": "legacy",
                                "outputs": ["a.ply", "b.ply"]}))
    p = Project.load(path)
    assert p.data["version"] == CURRENT_VERSION
    assert [r.name for r in p.plys()] == ["a", "b"]


def test_temp_project_cleanup(tmp_path):
    p = Project.create_temp()
    assert p.path.exists()
    (p.path.parent / ".lock").write_text("999999999")  # dead pid
    assert Project.remove_temp_unlocked(p.path.parent.parent) >= 1
    assert not p.path.exists()


# --- against the JAX package ---------------------------------------------------

def test_geometry_matches_jax(rng):
    for _ in range(6):
        q = rng.normal(0, 1, 4)
        t = rng.normal(0, 2, 3)
        pts = rng.normal(0, 2, (50, 3))
        a, b = EuclideanTransform(q, t), j_geo.EuclideanTransform(q, t)
        a2 = EuclideanTransform.from_euler(*rng.normal(0, 1, 3), translation=t)
        b2 = j_geo.EuclideanTransform(a2.quat, a2.translation)
        for got, want in ((a.apply(pts), b.apply(pts)), (a.to_matrix(), b.to_matrix()),
                          (a.inverse().to_matrix(), b.inverse().to_matrix()),
                          (a.compose(a2).to_matrix(), b.compose(b2).to_matrix()),
                          (EuclideanTransform.from_matrix(a.to_matrix()).quat,
                           j_geo.EuclideanTransform.from_matrix(b.to_matrix()).quat)):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    euler = rng.normal(0, 1, 3)
    np.testing.assert_allclose(EuclideanTransform.from_euler(*euler).quat,
                               j_geo.EuclideanTransform.from_euler(*euler).quat, atol=1e-6)
    pts = rng.uniform(-2, 2, (100, 3)).astype(np.float32)
    lo, hi = np.full(3, -0.5, np.float32), np.array([1.0, 0.5, 2.0], np.float32)
    np.testing.assert_array_equal(BoundingBox(lo, hi).contains(pts),
                                  j_geo.BoundingBox(lo, hi).contains(pts))
    got, want = BoundingBox.from_points(pts).expanded(0.1), j_geo.BoundingBox.from_points(pts).expanded(0.1)
    np.testing.assert_allclose([got.min, got.max, got.center, got.size],
                               [want.min, want.max, want.center, want.size], atol=1e-6)


def _edit_pair(rng, n=64, capacity=80):
    j = make_random_splats(rng, n=n, capacity=capacity, spread=1.5)
    j.scene_scale = 1.7
    return j, to_torch_splats(j)


def _assert_same_model(t, j):
    assert t.capacity == j.capacity and int(t.n_active) == int(j.n_active)
    assert int(t.active_sh_degree) == int(j.active_sh_degree)
    assert t.max_sh_degree == j.max_sh_degree and t.scene_scale == j.scene_scale
    for k in SPLAT_FIELDS:
        np.testing.assert_allclose(np_(getattr(t, k)), np.asarray(getattr(j, k)), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


def test_crop_by_bbox_matches_jax(rng):
    j, t = _edit_pair(rng)
    box = (np.array([-0.5, -1.0, -0.2], np.float32), np.array([1.0, 0.7, 1.5], np.float32))
    _assert_same_model(t.crop_by_bbox(BoundingBox(*box)), j.crop_by_bbox(j_geo.BoundingBox(*box)))


@pytest.mark.parametrize("euler,shift", [((0.0, 0.0, np.pi / 2), (1.0, 0.0, 0.0)),
                                         ((0.3, -1.1, 2.0), (-0.5, 2.0, 0.25))])
def test_transformed_matches_jax(rng, euler, shift):
    j, t = _edit_pair(rng)
    out_t = t.transformed(EuclideanTransform.from_euler(*euler, translation=shift))
    out_j = j.transformed(j_geo.EuclideanTransform.from_euler(*euler, translation=shift))
    _assert_same_model(out_t, out_j)
    assert t.n_sh_bases == j.n_sh_bases == 16


# --- tests/test_splat_edit.py on the port -----------------------------------------

def test_crop_by_bbox(rng):
    splats = to_torch_splats(make_random_splats(rng, n=64, spread=1.5))
    bbox = BoundingBox(np.full(3, -0.5, np.float32), np.full(3, 0.5, np.float32))
    cropped = splats.crop_by_bbox(bbox)
    n = int(cropped.n_active)
    assert 0 < n < 64 and cropped.capacity == 64
    assert bbox.contains(np_(cropped.means[:n])).all()


def test_transform_rotation(rng):
    splats = to_torch_splats(make_random_splats(rng, n=16))
    tf = EuclideanTransform.from_euler(0, 0, np.pi / 2, [1.0, 0.0, 0.0])
    out = splats.transformed(tf)
    np.testing.assert_allclose(np_(out.means[:16]), tf.apply(np_(splats.means[:16])), atol=1e-5)
    # quats stay unit and rotations compose: R_new = R_t @ R_old
    with torch.no_grad():
        r_old = np_(quat_to_rotmat(splats.get_rotation()[:16]))
        r_new = np_(quat_to_rotmat(out.rotation[:16]))
    for i in range(16):
        np.testing.assert_allclose(r_new[i], tf.rotation @ r_old[i], atol=1e-5)


# --- the version counter --------------------------------------------------------

def test_every_in_place_write_bumps_the_version(rng):
    from lichtfeld_studio_tpu_torch.train.capacity import grow_capacity
    from lichtfeld_studio_tpu_torch.train.state import init_train_state, make_lrs

    splats = to_torch_splats(make_random_splats(rng, n=40, capacity=64))
    seen = [splats.version]

    def bumped():
        seen.append(splats.version)
        return seen[-1] > seen[-2]

    splats.replace_trainable({"means": splats.means + 1e-3})
    assert bumped()
    splats.increment_sh_degree()
    assert bumped()
    state = init_train_state(splats, make_lrs(1.6e-4, 2.5e-3, 5e-3, 1e-3, 0.05, 1.0))
    grow_capacity(state, 128)
    assert bumped() and splats.capacity == 128
    # the edits return new models; the original is not written
    v = splats.version
    splats.crop_by_bbox(BoundingBox(np.full(3, -9.0), np.full(3, 9.0)))
    assert splats.version == v
