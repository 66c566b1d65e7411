"""Port parity for lichtfeld_studio_tpu_torch.train.metrics against the JAX
package: MetricsEvaluator.evaluate on the same splats and dataset (PSNR and
SSIM within 1e-4: the port's eval render stops a pixel at T < 1/512, which
leaves out at most that much light), the csv's header and row format, the
report's text but for nothing (it carries no timing), depth dumps."""

import re

import numpy as np
import pytest
import torch

from lichtfeld_studio_tpu.io import dataset as j_dataset
from lichtfeld_studio_tpu.train.metrics import MetricsEvaluator as JEvaluator
from lichtfeld_studio_tpu_torch.io import dataset as t_dataset
from lichtfeld_studio_tpu_torch.ops import ssim as t_ssim
from lichtfeld_studio_tpu_torch.train.metrics import EvalMetrics, MetricsEvaluator
from tests.scene_utils import make_random_splats
from tests.test_trainer_e2e import _make_dataset
from tests.torch_parity import to_torch_splats


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("metrics_scene")
    rng = np.random.default_rng(3)
    _make_dataset(rng, root / "scene", n_views=6)
    # the model under evaluation: another random scene, so PSNR is finite and low
    splats = make_random_splats(rng, n=48, spread=0.8)
    return root, splats


def test_evaluate_matches_jax(scene):
    root, splats = scene
    cams_j, _, _ = j_dataset.load_dataset(str(root / "scene"))
    cams_t, _, _ = t_dataset.load_dataset(str(root / "scene"))
    ev_j = JEvaluator(j_dataset.CameraDataset(cams_j, "val", 3), root / "out_j", save_images=True,
                      raster_mode="tiles", instance_cap=4096, k_max=64)
    ev_t = MetricsEvaluator(t_dataset.CameraDataset(cams_t, "val", 3), root / "out_t",
                            save_images=True, raster_mode="cuda", instance_cap=4096)
    sd = to_torch_splats(splats)
    for it in (10, 20):
        m_j, m_t = ev_j.evaluate(splats, it), ev_t.evaluate(sd, it)
        assert isinstance(m_t, EvalMetrics)
        np.testing.assert_allclose(m_t.psnr, m_j.psnr, atol=1e-4)
        np.testing.assert_allclose(m_t.ssim, m_j.ssim, atol=1e-4)
        assert (m_t.lpips, m_t.num_gaussians, m_t.iteration) == (-1.0, m_j.num_gaussians, it)
        assert m_t.elapsed > 0
    ev_j.write_report()
    ev_t.write_report()
    rows_j = (root / "out_j" / "metrics.csv").read_text().splitlines()
    rows_t = (root / "out_t" / "metrics.csv").read_text().splitlines()
    assert rows_t[0] == rows_j[0] == "iteration,psnr,ssim,lpips,time_per_image,num_gaussians"
    assert len(rows_t) == len(rows_j) == 3
    row = re.compile(r"^\d+,-?\d+\.\d{6},-?\d+\.\d{6},-1\.000000,\d+\.\d{6},\d+$")
    for r_t, r_j in zip(rows_t[1:], rows_j[1:]):
        assert row.match(r_t) and row.match(r_j), (r_t, r_j)
        f_t, f_j = r_t.split(","), r_j.split(",")
        assert (f_t[0], f_t[3], f_t[5]) == (f_j[0], f_j[3], f_j[5])
    # the report: equal text (PSNR to 4 decimals within the 1e-4 above: compare the numbers)
    rep_t = (root / "out_t" / "report.txt").read_text()
    rep_j = (root / "out_j" / "report.txt").read_text()
    number = re.compile(r"-?\d+\.\d+")
    assert number.sub("#", rep_t) == number.sub("#", rep_j)
    np.testing.assert_allclose([float(x) for x in number.findall(rep_t)],
                               [float(x) for x in number.findall(rep_j)], atol=2e-4)
    # one comparison image per val view and eval, none of depth
    for out in ("out_t", "out_j"):
        names = sorted(p.name for p in (root / out / "eval_step_20").iterdir())
        assert names == ["r_0_compare.png", "r_3_compare.png"], names


@pytest.mark.parametrize("render_mode,save_depth,dumps", [
    ("RGB", False, 0), ("RGB", True, 2), ("RGB_ED", False, 2), ("D", False, 2)])
def test_depth_dumps(scene, tmp_path, render_mode, save_depth, dumps):
    """--save-depth and the depth render modes write one depth colormap per
    view (metrics.cpp:454-480); plain RGB writes none."""
    root, splats = scene
    cams, _, _ = t_dataset.load_dataset(str(root / "scene"))
    ev = MetricsEvaluator(t_dataset.CameraDataset(cams, "val", 3), tmp_path, raster_mode="cuda",
                          instance_cap=4096, render_mode=render_mode, save_depth=save_depth)
    m = ev.evaluate(to_torch_splats(splats), 5)
    assert np.isfinite(m.psnr) and np.isfinite(m.ssim)
    assert len(list((tmp_path / "eval_step_5").glob("*_depth.png"))) == dumps


def test_lpips_weights_are_not_ported(scene, tmp_path):
    root, _ = scene
    with pytest.raises(NotImplementedError, match="item 5"):
        MetricsEvaluator(t_dataset.CameraDataset([], "val", 3), tmp_path, lpips_weights="w.npz")


def test_empty_report_and_psnr(tmp_path):
    ev = MetricsEvaluator(t_dataset.CameraDataset([], "val", 3), tmp_path)
    ev.write_report()
    assert not (tmp_path / "report.txt").exists()
    a = torch.full((16, 16, 3), 0.5)
    assert float(t_ssim.psnr(a, a)) == pytest.approx(120.0)  # the 1e-12 floor on the mse
    assert float(t_ssim.psnr(a, a + 0.1)) == pytest.approx(20.0, abs=1e-4)
