"""The port runs without JAX: it renders a tiny scene, trains a few steps
and a few --gut-exact steps on the CPU in processes where `import jax`
fails, imports every one of its modules and trains through the CLI where
jax, orbax and the JAX package are all blocked, and no file of the package
imports any of them."""

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


_CLI_SCRIPT = r"""
import importlib
import pkgutil
import sys
for blocked in ("jax", "orbax", "lichtfeld_studio_tpu"):
    sys.modules[blocked] = None  # importing it now raises ImportError
sys.path.insert(0, sys.argv[1])
from pathlib import Path
import torch
import lichtfeld_studio_tpu_torch as pkg

names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
         if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
for wanted in ("cli", "train.trainer", "train.checkpoint", "train.metrics", "train.capacity",
               "train.strategies.adc", "io.dataset", "io.colmap", "io.transforms", "io.native",
               "config.parameters", "core.events", "core.logging", "core.project",
               "kernels.microbench", "tools.selfcheck_train", "tools.microbench_bf16_vpu",
               "tools.microbench_dma_stream", "tools.microbench_scan_orient", "ops.kmeans",
               "io.sog", "core.geometry", "render.coherent", "render.live_server",
               "render.studio", "render.web_viewer", "bench_render"):
    assert f"lichtfeld_studio_tpu_torch.{wanted}" in names, wanted

from lichtfeld_studio_tpu_torch import cli
from lichtfeld_studio_tpu_torch.render import headless
from lichtfeld_studio_tpu_torch.tools.selfcheck_train import write_scene

root = Path(sys.argv[2])
write_scene(root / "scene", "cpu", width=48, height=32, n_views=6, n_gt=60, focal=60.0)
headless.default_device = lambda: torch.device("cpu")  # this test asks for the CPU
rc = cli.main(["-d", str(root / "scene"), "-o", str(root / "out"), "--headless", "--eval",
               "--test-every", "3", "--iterations", "5", "--eval-steps", "5", "--random",
               "--init-num-pts", "100", "--max-cap", "4096", "--instance-cap", "16384",
               "--start-refine", "1", "--refine-every", "2", "--stop-refine", "5",
               "--num-workers", "1", "--save-state-every", "5"])
assert rc == 0, rc
for name in ("splat_5.ply", "metrics.csv", "report.txt", "project.lfs", "state_5/state.pt",
             "viewer_live.html"):
    assert (root / "out" / name).exists(), name
# the viewer slice: the HTML export, a SOG written and rendered, two models
from lichtfeld_studio_tpu_torch.io.sog import write_sog
from lichtfeld_studio_tpu_torch.render.headless import splats_from_ply

ply = root / "out" / "splat_5.ply"
assert cli.main(["-v", str(ply), "--render-output", str(root / "v.html")]) == 0
write_sog(splats_from_ply(ply).to_point_cloud(), root / "m.sog", kmeans_iterations=2,
          device="cpu")
assert cli.main(["-v", f"{root / 'm.sog'},{ply}", "--render-output", str(root / "v.png"),
                 "--render-size", "48", "32"]) == 0
assert (root / "v.html").exists() and (root / "v.png").exists()
loaded = [m for m, v in sys.modules.items() if v is not None
          and m.split(".")[0] in ("jax", "jaxlib", "orbax", "lichtfeld_studio_tpu")]
assert not loaded, loaded
print("ok")
"""


def _run(script, *args):
    proc = subprocess.run(
        [sys.executable, "-c", script, str(REPO), *args], capture_output=True, text=True,
        timeout=900,
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


def test_every_module_imports_and_the_cli_trains_without_jax(tmp_path):
    """jax, orbax and lichtfeld_studio_tpu blocked: every module of the
    port imports, tools included, the CLI trains 5 iterations (a refine
    step, eval, PLY, snapshot, viewer_live.html) on the CPU device, exports
    the HTML viewer and renders a .sog beside the PLY."""
    _run(_CLI_SCRIPT, str(tmp_path))


def test_no_jax_import_in_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|orbax|lichtfeld_studio_tpu[. ])", re.MULTILINE)
    files = list(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert files
    for f in files:
        assert not pattern.search(f.read_text()), f
