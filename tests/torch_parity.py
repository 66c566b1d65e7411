"""Parity helpers for the PyTorch port: carry a JAX-package scene (splats,
camera) across to `lichtfeld_studio_tpu_torch` as numpy, so both packages
compute on identical parameters."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from chip_smoke import SEGMENT_COLUMNS, segment_cases, segment_inputs  # noqa: F401
from lichtfeld_studio_tpu_torch.core.camera import Camera as TorchCamera
from lichtfeld_studio_tpu_torch.core.camera import CameraParams as TorchCameraParams
from lichtfeld_studio_tpu_torch.core.splat_data import SplatData as TorchSplatData

SPLAT_FIELDS = (
    "means", "sh0", "shN", "scaling", "rotation", "opacity", "n_active", "active_sh_degree",
)


def to_torch_splats(sd, device="cpu") -> TorchSplatData:
    """JAX SplatData -> port SplatData with the same slots and values."""
    arrays = {k: np.asarray(getattr(sd, k)) for k in SPLAT_FIELDS}
    arrays["max_sh_degree"] = sd.max_sh_degree
    arrays["scene_scale"] = sd.scene_scale
    return TorchSplatData.from_numpy(arrays, device)


def to_torch_camera(cam) -> TorchCamera:
    """JAX host Camera -> port Camera from the same numpy R/T/K, camera
    model and distortion."""
    return TorchCamera(
        R=np.asarray(cam.R), T=np.asarray(cam.T), fx=cam.fx, fy=cam.fy,
        cx=cam.cx, cy=cam.cy, width=cam.width, height=cam.height, uid=cam.uid,
        image_path=cam.image_path, image_name=cam.image_name, camera_model=cam.camera_model,
        radial_distortion=np.asarray(cam.radial_distortion, np.float32),
        tangential_distortion=np.asarray(cam.tangential_distortion, np.float32),
    )


def to_torch_params(params, device="cpu") -> TorchCameraParams:
    """JAX CameraParams -> port CameraParams with the same tensors, camera
    model, distortion, end-of-frame pose and shutter."""

    def t(x):
        return None if x is None else torch.from_numpy(np.array(x, np.float32)).to(device)

    return TorchCameraParams(
        w2c=t(params.w2c), cam_position=t(params.cam_position), K=t(params.K),
        uid=int(np.asarray(params.uid)), width=params.width, height=params.height,
        camera_model=params.camera_model, radial=t(params.radial),
        tangential=t(params.tangential), w2c_end=t(params.w2c_end),
        shutter_type=params.shutter_type,
    )


def flat_aux(tree) -> dict:
    """The JAX package's aux tree ({"pose": {name: leaf}, "bilateral":
    leaf}) as the port's flat keys ("pose.<name>", "bilateral")."""
    out = {}
    for group, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{group}.{k}": leaf for k, leaf in v.items()})
        else:
            out[group] = v
    return out


def to_torch_train_state(state, device="cpu"):
    """JAX TrainState -> port TrainState: the splats, the Adam moments, step
    counts and LRs, the iteration, the binomial table, the ADC statistics,
    the components' parameters and Adam state (flat keys: the per-group
    step count and LR go to each leaf of the group) and the ADMM duals. The
    generator is fresh (seed 0): the two packages' random streams differ,
    tests inject the draws."""
    from lichtfeld_studio_tpu_torch.ops.adam import AdamState
    from lichtfeld_studio_tpu_torch.train.state import TrainState

    def t(x, dtype=np.float32):
        return torch.from_numpy(np.array(x, dtype)).to(device)

    def per_leaf(group_values):
        return {k: group_values[k.split(".")[0]] for k in flat_aux(state.aux_params)}

    aux_adam = AdamState(
        exp_avg={k: t(v) for k, v in flat_aux(state.aux_adam.exp_avg).items()},
        exp_avg_sq={k: t(v) for k, v in flat_aux(state.aux_adam.exp_avg_sq).items()},
        step_count={k: t(v, np.int32) for k, v in per_leaf(state.aux_adam.step_count).items()},
        lr={k: t(v) for k, v in per_leaf(state.aux_adam.lr).items()},
    )
    adam = AdamState(
        exp_avg={k: t(v) for k, v in state.adam.exp_avg.items()},
        exp_avg_sq={k: t(v) for k, v in state.adam.exp_avg_sq.items()},
        step_count={k: t(v, np.int32) for k, v in state.adam.step_count.items()},
        lr={k: t(v) for k, v in state.adam.lr.items()},
    )
    return TrainState(
        splats=to_torch_splats(state.splats, device), adam=adam,
        generator=torch.Generator(device=device).manual_seed(0),
        iteration=int(state.iteration), binoms=t(state.binoms),
        densify_count=t(state.densify_count), densify_grad=t(state.densify_grad),
        aux_params={k: t(v) for k, v in flat_aux(state.aux_params).items()}, aux_adam=aux_adam,
        admm_u=t(state.admm_u), admm_z=t(state.admm_z),
    )


def params_via_json(params, cls):
    """TrainingParameters of one package -> the other's (`cls`), through
    their JSON form."""
    data = params.to_json()
    out = cls()
    out.dataset = type(out.dataset)(**data["dataset"])
    out.optimization = type(out.optimization).from_json(data["optimization"])
    out.ply_path, out.init_ply, out.resume = data["ply_path"], data["init_ply"], params.resume
    return out


def np_(x) -> np.ndarray:
    """torch or jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def require_cuda() -> torch.device:
    """Skip the calling test unless a CUDA device is present (decided at
    run time, inside the test, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


# --- P1 expansion cases (the hazards of tests/test_expand_pallas.py) ---

def expand_inputs(nt, seed):
    """n_touched and a random [4, C] int32 payload whose word 1 packs the
    count at bit 10 (ops/tiles.py layout)."""
    nt = np.asarray(nt, np.int32)
    rng = np.random.default_rng(seed)
    payload = rng.integers(-(2**31), 2**31, size=(4, nt.shape[0]), dtype=np.int64).astype(np.int32)
    payload[1] = rng.integers(1, 1024, nt.shape[0]).astype(np.int32) | (nt << 10)
    return nt, payload


def _zero_floods():
    rng = np.random.default_rng(1)
    nt = rng.integers(0, 5, 400).astype(np.int32)
    nt[50:260] = 0  # a 210-gaussian culled run sharing one offset
    nt[0:3] = 0
    nt[-40:] = 0
    return nt


def _giant():
    nt = np.zeros(64, np.int32)
    nt[10] = 900
    return nt


def _random(seed):
    rng = np.random.default_rng(seed)
    c = int(rng.integers(10, 700))
    nt = rng.integers(0, 6, c).astype(np.int32)
    cap = int(rng.integers(1, 4)) * 256 + int(rng.integers(0, 200))
    return nt, cap


def _long_culled_run():
    """A run of culled gaussians sharing one offset that outgrows the merge
    piece of a block of csrc/expand.cu (kernels/expand.py PIECE: 1,024
    items) five times over, between live ones, and a culled tail."""
    rng = np.random.default_rng(2)
    nt = rng.integers(0, 4, 7000).astype(np.int32)
    nt[900:7000 - 300] = 0
    nt[-40:] = 0
    return nt, int(nt.sum()) + 700


def _cap_off_the_piece():
    """Several merge pieces, a cap that is no multiple of a piece or of a
    thread's steps, the total beyond the cap."""
    rng = np.random.default_rng(3)
    nt = rng.integers(0, 9, 2500).astype(np.int32)
    return nt, 9 * 1024 - 211


def _total_is_the_cap():
    """Every slot valid: the total of n_touched is exactly the cap."""
    rng = np.random.default_rng(4)
    nt = rng.integers(0, 5, 3000).astype(np.int32)
    nt[1000:1600] = 0
    return nt, int(nt.sum())


EXPAND_CASES = {
    "dense_segments": ([3, 1, 4, 1, 5, 9, 2, 6], 64),
    "interleaved_zero_floods": (_zero_floods(), 1024),
    "overflow_total_beyond_cap": (np.full(300, 7, np.int32), 512),
    "empty_view": (np.zeros(128, np.int32), 256),
    "single_giant_segment": (_giant(), 1024),
    "randomized_4": _random(4),
    "randomized_5": _random(5),
    "culled_run_longer_than_a_piece": _long_culled_run(),
    "cap_not_a_multiple_of_a_piece": _cap_off_the_piece(),
    "total_exactly_the_cap": _total_is_the_cap(),
}


# --- P4 segment layouts: what the kernel's blocks and chunks must survive ---
# (n_touched, cap) as EXPAND_CASES; chip_smoke.py holds the table, so that
# the check on the GPU and the tests run the same layouts.
SEGMENT_CASES = segment_cases()
# (case, columns): every case at P3's 9 and P6's 24, every width on two cases
SEGMENT_CASE_COLUMNS = sorted(
    {(name, f) for name in SEGMENT_CASES for f in (9, 24)}
    | {(name, f) for name in ("segment_longer_than_two_chunks", "n_not_a_multiple_of_the_block")
       for f in SEGMENT_COLUMNS})


def assert_expand_equal_on_valid(nt, out, ref, cap):
    """Same valid slots, and equal g / rank / payload on them; g in bounds
    everywhere."""
    g, rank, pl = map(np_, out)
    g_r, rank_r, pl_r = map(np_, ref)
    assert g.min() >= 0 and g.max() < nt.shape[0]

    def valid_of(g_, rank_):
        return (np.arange(cap) < min(int(nt.sum()), cap)) & (rank_ < nt[g_])

    valid = valid_of(g_r, rank_r)
    np.testing.assert_array_equal(valid_of(g, rank), valid)
    np.testing.assert_array_equal(g[valid], g_r[valid])
    np.testing.assert_array_equal(rank[valid], rank_r[valid])
    np.testing.assert_array_equal(pl[:, valid], pl_r[:, valid])


# --- a scene built with numpy alone (no JAX), for the tests on the GPU ---

def random_scene(rng, n=400, spread=0.8, width=96, height=64, device="cpu"):
    """Port splats with varied shape, rotation, opacity and SH, and a
    pinhole camera looking at them (the geometry of scene_utils)."""
    from lichtfeld_studio_tpu_torch.core.camera import look_at_camera

    quat = rng.normal(size=(n, 4)).astype(np.float32)
    op = rng.uniform(0.3, 0.95, (n, 1)).astype(np.float32)
    sd = TorchSplatData.from_arrays(
        rng.uniform(-spread, spread, (n, 3)).astype(np.float32),
        rng.normal(0, 1, (n, 1, 3)).astype(np.float32),
        (0.05 * rng.normal(size=(n, 15, 3))).astype(np.float32),
        rng.uniform(np.log(0.02), np.log(0.15), (n, 3)).astype(np.float32),
        quat / np.linalg.norm(quat, axis=1, keepdims=True),
        np.log(op / (1 - op)),
        device=device,
    )
    cam = look_at_camera(np.array([0.0, 0.0, -4.0]), np.zeros(3), np.array([0.0, -1.0, 0.0]),
                         60.0, 60.0, width, height)
    return sd, cam


def binned_blend_inputs(sd, cam, device, with_depth=True, instance_cap=16384):
    """Projection + binning at 32-px tiles: the arguments of blend_forward."""
    from lichtfeld_studio_tpu_torch.ops.rasterize import _project
    from lichtfeld_studio_tpu_torch.ops.tiles import build_tile_assignment

    with torch.no_grad():
        proj = _project(sd, cam.device_params(device), tile_size=32)
        gw, gh = -(-cam.width // 32), -(-cam.height // 32)
        a = build_tile_assignment(proj, grid_w=gw, grid_h=gh, instance_cap=instance_cap,
                                  need_grad=False)
    color = torch.cat([proj.color, proj.depth[:, None]], -1) if with_depth else proj.color
    args = (a.tile_start, a.tile_count, a.gaussian_idx, proj.mean2d, proj.conic,
            proj.opacity, color)
    return args, dict(grid_w=gw, grid_h=gh, tile_size=32)


def conics(sx, sy, theta):
    """Conic (a, b, c) = inverse of R diag(sx^2, sy^2) R^T."""
    c, s = np.cos(theta), np.sin(theta)
    ia, ib = 1.0 / sx**2, 1.0 / sy**2
    return np.stack([c * c * ia + s * s * ib, c * s * (ia - ib), s * s * ia + c * c * ib], -1)


def crafted_blend_inputs(kind, tile_size, n_ch, dev, size=64, n=60, uneven=False):
    """Projected gaussians made by hand, every one listed in every tile in
    index order (a valid binning: slots gaussian-major, rank = tile); with
    `uneven`, tile t lists only the first count[t] of them, counts drawn
    from 0..n with ties and empty tiles, slots a random permutation."""
    rng = np.random.default_rng(len(kind) + tile_size + n_ch)
    patch_w, patch_h = tile_size // 2, tile_size // 4  # a warp's patch, csrc/blend_common.cuh
    mean = rng.uniform(2, size - 2, (n, 2))
    opacity = rng.uniform(0.2, 0.9, n)
    if kind == "large":  # cover a whole tile and more
        sx, sy = rng.uniform(25, 60, n), rng.uniform(25, 60, n)
    elif kind == "tiny":  # inside one warp's patch
        sx, sy = rng.uniform(0.4, 0.9, n), rng.uniform(0.4, 0.9, n)
    elif kind == "patch_edge":  # centred exactly on patch edges, a pixel or two wide
        mean = np.stack([rng.integers(1, size // patch_w, n) * patch_w,
                         rng.integers(1, size // patch_h, n) * patch_h], -1).astype(np.float64)
        sx, sy = rng.uniform(0.5, 2.0, n), rng.uniform(0.5, 2.0, n)
    elif kind == "clamped":  # alpha reaches the 0.999 clamp around the mean
        opacity = np.ones(n)
        sx, sy = rng.uniform(2, 8, n), rng.uniform(2, 8, n)
    elif kind == "ill_conditioned":
        sx, sy = rng.uniform(2, 8, n), rng.uniform(2, 8, n)
    else:  # elongated, turned: the reach box is much larger than the ellipse
        sx, sy = rng.uniform(10, 30, n), rng.uniform(0.3, 0.6, n)
    conic = conics(sx, sy, rng.uniform(0, np.pi, n))
    if kind == "ill_conditioned":  # a*c - b*b near 0, below 0, and a non-finite conic
        root = np.sqrt(conic[:, 0] * conic[:, 2])
        third = n // 3
        conic[:third, 1] = root[:third] * (1.0 - 1e-5)
        conic[third:2 * third, 1] = root[third:2 * third] * 1.2
        conic[2 * third:2 * third + 3, 0] = np.inf
    color = rng.uniform(-0.2, 1.0, (n, n_ch))  # some below the colour clamp

    def t(x, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dtype).to(dev)

    gw = gh = size // tile_size
    tiles = gw * gh
    if uneven:
        count = rng.integers(0, n + 1, tiles) * rng.integers(0, 2, tiles)
        slots = rng.permutation(int(count.sum()))
    else:
        count = np.full(tiles, n)
        slots = (np.arange(n)[None, :] * tiles + np.arange(tiles)[:, None]).reshape(-1)
    tile_start = t(np.cumsum(count) - count, torch.int32)
    gaussian_idx = t(np.concatenate([np.arange(c) for c in count]), torch.int32)
    slot_layout = t(slots, torch.int32)
    args = (tile_start, t(count, torch.int32), gaussian_idx, t(mean), t(conic), t(opacity),
            t(color))
    return args, slot_layout, dict(grid_w=gw, grid_h=gh, tile_size=tile_size)


# --- the world-space blend's inputs (P5, P6), numpy and torch alone ---

def rolling_params(params, dx=0.2):
    """A rolling-shutter (top to bottom) copy of port CameraParams whose
    end-of-frame pose is translated by dx along camera x."""
    import dataclasses

    from lichtfeld_studio_tpu_torch.core.camera import ShutterType

    w2c_end = params.w2c.clone()
    w2c_end[0, 3] += dx
    return dataclasses.replace(params, w2c_end=w2c_end,
                               shutter_type=ShutterType.ROLLING_TOP_TO_BOTTOM)


def world_blend_inputs(sd, cam, device, *, tile_size=16, rolling=False, with_depth=False,
                       instance_cap=1 << 16):
    """The arguments rasterize's gut-exact training path hands its blend
    (ops/rasterize.py::capture_world_inputs) for a port Camera, optionally turned
    into a rolling shutter: (stream, rays_d, tau, assignment, kw)."""
    from lichtfeld_studio_tpu_torch.ops.rasterize import capture_world_inputs

    params = cam.device_params(device)
    if rolling:
        params = rolling_params(params)
    return capture_world_inputs(sd, params, tile_size=tile_size, instance_cap=instance_cap,
                                with_depth=with_depth)


def overfit_single_view(device, steps=250):
    """tests/test_overfit_quality.py on the port, with no JAX: a 40-gaussian
    ground truth drawn as scene_utils.make_random_splats draws it (spread
    0.9), its 64x48 render as the target, then `steps` MCMC train steps on
    the kernel path from 256 random points (capacity 512, refines at 150
    and 200). Returns (PSNR before, PSNR after, live gaussians after)."""
    from lichtfeld_studio_tpu_torch.core.camera import look_at_camera
    from lichtfeld_studio_tpu_torch.ops.rasterize import rasterize
    from lichtfeld_studio_tpu_torch.ops.ssim import psnr
    from lichtfeld_studio_tpu_torch.train.state import (
        TrainConfig, init_train_state, make_lrs, step_flags, train_step)
    from lichtfeld_studio_tpu_torch.train.strategies.mcmc import MCMCConfig

    rng, n = np.random.default_rng(0), 40
    positions = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    colors = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    gt = TorchSplatData.from_point_cloud(positions, colors, np.zeros(3, np.float32), capacity=n,
                                         device=device)
    quat = rng.normal(0, 1, (n, 4)).astype(np.float32)
    op = rng.uniform(0.3, 0.95, (n, 1)).astype(np.float32)
    gt.replace_trainable({
        "scaling": torch.from_numpy(rng.uniform(np.log(0.02), np.log(0.15), (n, 3))
                                    .astype(np.float32)),
        "rotation": torch.from_numpy(quat / np.linalg.norm(quat, axis=1, keepdims=True)),
        "opacity": torch.from_numpy(np.log(op / (1 - op)).astype(np.float32)),
        "shN": torch.from_numpy(0.05 * rng.normal(0, 1, (n, 15, 3)).astype(np.float32)),
    })
    cam = look_at_camera(np.array([0.0, 0.0, -4.0]), np.zeros(3), np.array([0.0, -1.0, 0.0]),
                         60.0, 60.0, 64, 48).device_params(device)
    bg = torch.zeros(3, device=device)
    kw = dict(mode="cuda", instance_cap=8192)
    with torch.no_grad():
        target = rasterize(gt, cam, bg, **kw).image
    sd = TorchSplatData.random_init(torch.Generator().manual_seed(1), num_points=256, extent=1.2,
                                    capacity=512, init_opacity=0.5, init_scaling=0.5,
                                    device=device)
    cfg = TrainConfig(iterations=steps, raster_mode="cuda", instance_cap=8192,
                      mcmc=MCMCConfig(max_cap=512, start_refine=100, stop_refine=240,
                                      refine_every=50),
                      lr_gamma=0.01 ** (1 / steps))
    state = init_train_state(sd, make_lrs(1.6e-4, 2.5e-3, 5e-3, 1e-3, 0.05, sd.scene_scale))
    with torch.no_grad():
        p0 = float(psnr(rasterize(state.splats, cam, bg, **kw).image, target))
    for i in range(steps):
        state, _ = train_step(state, cam, target, bg, cfg, step_flags(cfg, i + 1))
    with torch.no_grad():
        p1 = float(psnr(rasterize(state.splats, cam, bg, **kw).image, target))
    return p0, p1, int(state.splats.n_active)


# --- the golden fixture (tests/data/golden_splats.npz) without JAX -------

GOLDEN_FIELDS = ("means", "sh0", "shN", "scaling", "rotation", "opacity")


def golden_arrays() -> dict:
    from pathlib import Path

    d = np.load(Path(__file__).parent / "data" / "golden_splats.npz")
    return {k: d[k].astype(np.float32) for k in GOLDEN_FIELDS}


def golden_splats(device="cpu") -> TorchSplatData:
    """The fixture as the port's SplatData (SH degree 3 active)."""
    a = golden_arrays()
    return TorchSplatData.from_arrays(*(a[k] for k in GOLDEN_FIELDS), device=device)


def golden_camera(width, height, eye, f, device="cpu"):
    """The golden tests' look-at camera (target the origin, -y up)."""
    from lichtfeld_studio_tpu_torch.core.camera import look_at_camera

    return look_at_camera(eye, np.zeros(3), np.array([0.0, -1.0, 0.0]), fx=f, fy=f,
                          width=width, height=height).device_params(device)
