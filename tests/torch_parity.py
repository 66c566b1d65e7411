"""Parity helpers for the PyTorch port: carry a JAX-package scene (splats,
camera) across to `lichtfeld_studio_tpu_torch` as numpy, so both packages
compute on identical parameters."""

from __future__ import annotations

import numpy as np
import pytest
import torch

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


def to_torch_train_state(state, device="cpu"):
    """JAX TrainState -> port TrainState: the splats, the Adam moments, step
    counts and LRs, the iteration, the binomial table and the ADC
    statistics. The generator is fresh (seed 0): the two packages' random
    streams differ, tests inject the draws."""
    from lichtfeld_studio_tpu_torch.ops.adam import AdamState
    from lichtfeld_studio_tpu_torch.train.state import TrainState

    def t(x, dtype=np.float32):
        return torch.from_numpy(np.array(x, dtype)).to(device)

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


EXPAND_CASES = {
    "dense_segments": ([3, 1, 4, 1, 5, 9, 2, 6], 64),
    "interleaved_zero_floods": (_zero_floods(), 1024),
    "overflow_total_beyond_cap": (np.full(300, 7, np.int32), 512),
    "empty_view": (np.zeros(128, np.int32), 256),
    "single_giant_segment": (_giant(), 1024),
    "randomized_4": _random(4),
    "randomized_5": _random(5),
}


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
    (chip_smoke.capture_world_inputs) for a port Camera, optionally turned
    into a rolling shutter: (stream, rays_d, tau, assignment, kw)."""
    from chip_smoke import capture_world_inputs

    params = cam.device_params(device)
    if rolling:
        params = rolling_params(params)
    return capture_world_inputs(sd, params, tile_size=tile_size, instance_cap=instance_cap,
                                with_depth=with_depth)
