"""Port parity for lichtfeld_studio_tpu_torch.ops.lpips against the JAX
package's network on a random-weights fixture (real VGG weights need a
download; the loader and the architecture are what is under test), and the
LPIPS column of a short training run with --eval --lpips-weights."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lichtfeld_studio_tpu.ops.lpips import LPIPS as JLPIPS
from lichtfeld_studio_tpu_torch import cli as t_cli
from lichtfeld_studio_tpu_torch.ops import lpips as t_lpips
from lichtfeld_studio_tpu_torch.train.trainer import Trainer
from tests.test_trainer_e2e import _make_dataset


def write_random_lpips_npz(rng, path):
    """The fixture of tests/test_flags_wiring.py::test_lpips_weights_fixture:
    N(0, 0.1) convolutions, zero biases, |N(0, 1)| linear heads."""
    data = {}
    in_ch = 3
    for si, (out_ch, idxs) in enumerate(t_lpips._SLICES):
        for idx in idxs:
            data[f"net.slice{si + 1}.{idx}.weight"] = rng.normal(
                0, 0.1, (out_ch, in_ch, 3, 3)).astype(np.float32)
            data[f"net.slice{si + 1}.{idx}.bias"] = np.zeros(out_ch, np.float32)
            in_ch = out_ch
    for i, (out_ch, _) in enumerate(t_lpips._SLICES):
        data[f"lin{i}.model.1.weight"] = np.abs(rng.normal(0, 1, (1, out_ch, 1, 1))).astype(np.float32)
    np.savez(path, **data)
    return path


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return write_random_lpips_npz(np.random.default_rng(0),
                                  tmp_path_factory.mktemp("lpips") / "lpips_rand.npz")


@pytest.mark.parametrize("seed", [1, 2])
def test_lpips_matches_jax(weights, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (32, 40, 3)).astype(np.float32)
    b = rng.uniform(0, 1, (32, 40, 3)).astype(np.float32)
    want = float(JLPIPS.from_npz(str(weights))(jnp.asarray(a), jnp.asarray(b)))
    got = float(t_lpips.LPIPS.from_npz(str(weights))(torch.from_numpy(a), torch.from_numpy(b)))
    assert want > 0.0
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_lpips_of_an_image_with_itself_is_zero(weights):
    a = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (32, 40, 3)).astype(np.float32))
    assert float(t_lpips.LPIPS.from_npz(str(weights))(a, a)) < 1e-6


def test_training_with_lpips_weights_writes_the_column(weights, tmp_path):
    """--eval --lpips-weights through Trainer.setup on the CPU device (the CLI
    itself needs a GPU): a finite lpips column, no exit."""
    _make_dataset(np.random.default_rng(4), tmp_path / "scene")
    out = tmp_path / "out"
    argv = ["-d", str(tmp_path / "scene"), "-o", str(out), "--iterations", "4", "--headless",
            "--max-cap", "4096", "--instance-cap", "16384", "--num-workers", "1",
            "--random", "--init-num-pts", "200", "--eval", "--test-every", "3",
            "--eval-steps", "4", "--lpips-weights", str(weights)]
    t = Trainer.setup(t_cli.parse_args_and_params(argv), "cpu")
    assert t.evaluator is not None and t.evaluator._lpips is not None
    t.train()
    rows = (out / "metrics.csv").read_text().strip().splitlines()
    assert len(rows) == 2
    lp = float(rows[-1].split(",")[3])
    assert np.isfinite(lp) and lp >= 0.0
