"""The port runs without JAX: it renders a tiny scene, trains a few steps
and a few --gut-exact steps on the CPU in processes where `import jax`
fails, and no file of the package imports it."""

import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "lichtfeld_studio_tpu_torch"

_SCRIPT = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from lichtfeld_studio_tpu_torch.core.camera import look_at_camera
from lichtfeld_studio_tpu_torch.core.splat_data import SplatData
from lichtfeld_studio_tpu_torch.render.headless import render_view
import lichtfeld_studio_tpu_torch.cli  # noqa: F401

rng = np.random.default_rng(0)
n = 50
pos = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
sd = SplatData.from_arrays(
    pos, rng.normal(0, 1, (n, 1, 3)).astype(np.float32), np.zeros((n, 15, 3), np.float32),
    np.full((n, 3), np.log(0.1), np.float32), np.tile([[1.0, 0, 0, 0]], (n, 1)).astype(np.float32),
    np.zeros((n, 1), np.float32),
)
cam = look_at_camera(np.array([0.0, 0.0, -4.0]), np.zeros(3), np.array([0.0, -1.0, 0.0]),
                     60.0, 60.0, 48, 32)
img = render_view(sd, cam)
assert img.shape == (32, 48, 3) and img.std() > 0.01, img.std()
assert not any(m == "jax" or m.startswith("jax.") for m, v in sys.modules.items() if v is not None)
print("ok")
"""


_TRAIN_SCRIPT = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.path.insert(0, sys.argv[1])
import lichtfeld_studio_tpu_torch.train.state  # noqa: F401
from lichtfeld_studio_tpu_torch.bench_train import benchmark_train

r = benchmark_train("cpu", k_scan=2, warmup=0, dispatches=1, refine_warm=0, refine_timed=1,
                    n0=200, cap=300, width=64, height=48, instance_cap=4096)
assert r["all_losses_finite"] and r["n_active_after_refine"] > 200, r
assert not any(m == "jax" or m.startswith("jax.") for m, v in sys.modules.items() if v is not None)
print("ok")
"""


_GUT_SCRIPT = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.path.insert(0, sys.argv[1])
from lichtfeld_studio_tpu_torch.bench_gut import benchmark_gut

r = benchmark_gut("cpu", frames=1, k_scan=2, warmup=0, dispatches=1, refine_warm=0,
                  refine_timed=1, n0=200, cap=300, width=64, height=48, instance_cap=4096)
assert r["all_losses_finite"] and r["forward_finite"] and r["n_active_after_refine"] > 200, r
assert not any(m == "jax" or m.startswith("jax.") for m, v in sys.modules.items() if v is not None)
print("ok")
"""


def _run(script):
    proc = subprocess.run(
        [sys.executable, "-c", script, str(REPO)], capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_port_renders_without_jax():
    _run(_SCRIPT)


def test_port_trains_without_jax():
    _run(_TRAIN_SCRIPT)


def test_port_trains_gut_exact_without_jax():
    """A --gut-exact fisheye train step (UT projection, ray table, P5/P6
    plain versions) in a process where `import jax` fails."""
    _run(_GUT_SCRIPT)


def test_no_jax_import_in_package():
    pattern = re.compile(r"^\s*(import jax|from jax)\b", re.MULTILINE)
    files = list(PACKAGE.rglob("*.py"))
    assert files
    for f in files:
        assert not pattern.search(f.read_text()), f
