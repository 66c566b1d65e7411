"""The port's 3DGUT train step (`--gut-exact`: the UT projection, the
per-pixel world rays, the stream and P5, P6/P4 under autograd) against the
benchmark's plain PyTorch reference (port_bench/reference/raster.py and
world.py), which imports neither JAX nor the port. On the CPU the port's
step runs the kernels' plain versions; the `cuda` case runs the card's
P5/P6/P4 against the same reference, the comparison that the
`garden4-gut.train` cell's `correct` makes at full size.

Scene: 300 seeded gaussians in front of a 96x64 camera, 16-px tiles, SH
degree 3, all slots live (the reference has no dead slots), seen through a
pinhole and through an OPENCV_FISHEYE test lens (k1 0.08, k2 -0.01; not a
published lens).

Tolerances, each over what the reference computes in float32:
  * image: 2e-5 absolute. Both sides composite in float32 in the same
    depth order; they differ in the order of the ray-space sums (the
    reference contracts its 3x3 products with einsum, the port
    accumulates per pair), a few ulps a term over up to 300 terms.
  * loss: 1e-6 relative, the image's difference through L1 and SSIM.
  * gradients: 1e-4 of each leaf's largest entry. The reference sums
    each gaussian's terms in float64 (index_add_), the port in float32 (P4
    over the instances of a tile range), so their orders differ by more
    than the image's.
  * instances: equal. Both bin each gaussian on the UT footprint's full
    screen bounds, from the same sigma points, without the exact tile test.
A planted fault in the reference's place (one of the seven sigma points
dropped from the UT sums, or the alpha threshold doubled) must fail them.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from lichtfeld_studio_tpu_torch.core.camera import CameraModelType, CameraParams
from lichtfeld_studio_tpu_torch.core.splat_data import SplatData
from lichtfeld_studio_tpu_torch.ops import rasterize as rasterize_mod
from lichtfeld_studio_tpu_torch.profiling import stage_times
from lichtfeld_studio_tpu_torch.train import state as t_state
from port_bench.reference import raster, world
from port_bench.scene import garden

N, W, H, TILE = 300, 96, 64, 16
FX = FY = 90.0
TEST_LENS = (0.08, -0.01, 0.0, 0.0)  # OPENCV_FISHEYE k1-k4 of a test lens
CFG = dict(lambda_dssim=0.2, scale_reg=0.01, opacity_reg=0.01, tile_size=TILE, gut_exact=True)
IMAGE_ATOL = 2e-5
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-4
GROUPS = raster.GROUPS


def make_params(seed: int = 7) -> dict:
    """Seeded gaussians in a box in front of the camera, SH degree 3."""
    g = torch.Generator().manual_seed(seed)

    def randn(*shape, std=1.0, mean=0.0):
        return mean + std * torch.randn(*shape, generator=g)

    means = torch.rand(N, 3, generator=g) * torch.tensor([2.4, 1.6, 3.0]) \
        - torch.tensor([1.2, 0.8, -1.5])
    return {"means": means, "sh0": randn(N, 1, 3), "shN": randn(N, 15, 3, std=0.1),
            "scaling": randn(N, 3, std=0.4, mean=-2.6), "rotation": randn(N, 4),
            "opacity": randn(N, 1, std=1.5)}


def make_views(fisheye: bool, device="cpu"):
    """(the port's CameraParams, the reference's View) of one camera."""
    r, t = garden.look_at(np.array([0.25, -0.15, -0.4]), np.array([0.0, 0.1, 3.0]),
                          up=(0.0, -1.0, 0.0))
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3], w2c[:3, 3] = r, t
    w2c_t = torch.from_numpy(w2c).to(device)
    model = CameraModelType.OPENCV_FISHEYE if fisheye else CameraModelType.PINHOLE
    cam = CameraParams(w2c=w2c_t, cam_position=-(w2c_t[:3, :3].T @ w2c_t[:3, 3]),
                       K=torch.tensor([FX, FY, W / 2, H / 2], device=device), uid=0, width=W,
                       height=H, camera_model=model,
                       radial=torch.tensor(TEST_LENS, device=device) if fisheye else None)
    view = raster.View(w2c_t[:3, :3].clone(), w2c_t[:3, 3].clone(), FX, FY, W / 2, H / 2, W, H,
                       "OPENCV_FISHEYE" if fisheye else "PINHOLE", TEST_LENS if fisheye else ())
    return cam, view


def make_gt(device="cpu") -> torch.Tensor:
    return torch.rand(H, W, 3, generator=torch.Generator().manual_seed(11)).to(device)


def port_step(params: dict, cam: CameraParams, gt: torch.Tensor, projection: str = "ut",
              gut_exact: bool = True):
    """The trainer's compute_grads on the kernel route ("cuda"; plain
    versions for CPU tensors): (loss, image, instances, gradients)."""
    splats = SplatData(**{k: v.clone() for k, v in params.items()}, n_active=N,
                       active_sh_degree=3)
    cfg = t_state.TrainConfig(raster_mode="cuda", tile_size=TILE, instance_cap=1 << 16,
                              projection=projection, gut_exact=gut_exact,
                              lambda_dssim=CFG["lambda_dssim"], scale_reg=CFG["scale_reg"],
                              opacity_reg=CFG["opacity_reg"])
    state = t_state.init_train_state(splats, t_state.make_lrs(1.6e-4, 2.5e-3, 5e-3, 1e-3, 0.05, 1.0))
    loss, out, grads = t_state.compute_grads(state, cam, gt, torch.zeros(3, device=gt.device), cfg)
    return float(loss), out.image, int(out.n_instances), {k: grads[k] for k in GROUPS}


def reference_step(params: dict, view: raster.View, gt: torch.Tensor):
    """The reference's step_grads and its image: (loss, image, instances,
    gradients)."""
    loss, grads, n_inst = raster.step_grads(params, view, gt, CFG)
    with torch.no_grad():
        pr = world.project_ut(params, view, TILE)
        b = raster.bin_tiles(pr, W, H, TILE)
        image, _ = world.render(world.features(params, pr), world.world_rays(view, TILE), b, W, H)
    return float(loss), image, n_inst, grads


def gaps(port, ref) -> dict:
    """Each compared number over its tolerance (a number above 1 fails)."""
    loss, image, n_inst, grads = port
    r_loss, r_image, r_inst, r_grads = ref
    out = {"image": float((image.cpu() - r_image.cpu()).abs().max()) / IMAGE_ATOL,
           "loss": abs(loss - r_loss) / abs(r_loss) / LOSS_RTOL,
           "instances": 2.0 * abs(n_inst - r_inst)}  # equal: any difference fails
    for k in GROUPS:
        g, r = grads[k].cpu(), r_grads[k].cpu()
        assert torch.isfinite(g).all(), k
        out[k] = float((g - r).abs().max()) / (GRAD_RTOL * max(float(r.abs().max()), 1e-30))
    return out


@pytest.fixture(scope="module")
def params():
    return make_params()


@pytest.mark.parametrize("fisheye", [False, True], ids=["pinhole", "fisheye"])
def test_gut_step_matches_the_plain_reference(params, fisheye):
    cam, view = make_views(fisheye)
    gt = make_gt()
    port = port_step(params, cam, gt)
    ref = reference_step(params, view, gt)
    assert ref[2] > 200  # the camera sees most of the scene
    g = gaps(port, ref)
    assert max(g.values()) <= 1.0, g


def _drop_last_sigma_point(monkeypatch):
    real = world._ordered_sum
    monkeypatch.setattr(world, "_ordered_sum", lambda x: real(x[:-1]))


def _double_alpha_threshold(monkeypatch):
    monkeypatch.setattr(raster, "ALPHA_MIN", 2.0 * raster.ALPHA_MIN)


@pytest.mark.parametrize("fault", [_drop_last_sigma_point, _double_alpha_threshold],
                         ids=["sigma_point_dropped", "alpha_threshold_doubled"])
def test_a_planted_fault_in_the_reference_fails_the_tolerance(params, fault, monkeypatch):
    cam, view = make_views(False)
    gt = make_gt()
    port = port_step(params, cam, gt)
    fault(monkeypatch)
    g = gaps(port, reference_step(params, view, gt))
    assert max(g.values()) > 1.0, g


def _stage_seconds(params, projection: str, gut_exact: bool) -> dict:
    cam, _ = make_views(False)
    gt = make_gt()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        port_step(params, cam, gt, projection=projection, gut_exact=gut_exact)
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    return stage_times(events, lambda e: e.self_cpu_time_total)


def test_the_ut_projection_stage_opens_on_the_ut_path_alone(params):
    """`ut_projection` (inside `projection`) holds the UT projection's
    forward, and its autograd nodes read as `ut_projection bwd`; the EWA
    path never opens it."""
    ut = _stage_seconds(params, "ut", True)
    assert ut.get("ut_projection", 0) > 0 and ut.get("ut_projection bwd", 0) > 0, ut
    ewa = _stage_seconds(params, "ewa", False)
    assert ewa.get("projection", 0) > 0, ewa
    assert not any(k.startswith("ut_projection") for k in ewa), ewa


def test_the_ut_projection_stage_nests_inside_projection(params, monkeypatch):
    opened = []
    real = rasterize_mod.stage

    def recording(name, *a, **kw):
        opened.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(rasterize_mod, "stage", recording)
    cam, _ = make_views(False)
    port_step(params, cam, make_gt())
    assert opened.index("ut_projection") == opened.index("projection") + 1, opened


@pytest.mark.cuda
def test_the_cards_p5_p6_route_matches_the_plain_reference(params):
    """The card's stream + P5 and P6/P4 under the trainer's compute_grads,
    against the reference on the card with TF32 off."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: P5, P6 and P4 are CUDA kernels")
    cam, view = make_views(False, "cuda")
    gt = make_gt("cuda")
    dev_params = {k: v.cuda() for k, v in params.items()}
    port = port_step(dev_params, cam, gt)
    ref = reference_step(dev_params, view, gt)
    g = gaps(port, ref)
    assert max(g.values()) <= 1.0, g
