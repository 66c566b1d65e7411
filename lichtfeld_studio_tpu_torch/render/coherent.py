"""Frame-coherent interactive renderer: one tile binning reused across
several nearby cameras (counterpart of
lichtfeld_studio_tpu/render/coherent.py).

* BIN PASS (every K frames, or when the camera drifts): the projection with
  CONSERVATIVELY DILATED bounds (ops/projection.py dilate_px: every tile
  the gaussian could touch if its projected mean drifted up to `dilate_px`
  pixels), then the inference binning (kernel P1). The instance lists are
  a superset of the exact lists of every camera within the drift budget.
* FRAME PASS (every frame): the feature-only projection (no exact tile
  test: the binning is cached), then kernel P2's inference blend against
  the CACHED tile_start / tile_count / gaussian_idx. Alpha comes from the
  CURRENT camera's mean and conic, so coverage is exact; only the order
  within a tile is the bin camera's depth order, whose deviation over a
  sub-pixel drift is below the viewer's u8 quantisation. Gaussians culled
  by the current camera (behind it, degenerate) get opacity, mean2d, conic
  and colour 0 before P2, so no non-finite value reaches its reach test.
* RE-BIN TRIGGERS: another model object, or the same object written in
  place since the bin (SplatData.version: Adam and the strategies write
  the model in place, so the object alone never changes while it trains);
  an estimated pixel drift over drift_budget (a rotation and translation
  bound against the scene's nearest visible depth); `max_reuse` frames.

Error bound: a fragment missing from a stale list would need its mean to
have drifted past the dilation, which the drift trigger prevents.
"""

from __future__ import annotations

import numpy as np
import torch

from lichtfeld_studio_tpu_torch.core.camera import Camera, CameraParams
from lichtfeld_studio_tpu_torch.core.splat_data import SplatData
from lichtfeld_studio_tpu_torch.kernels.blend import blend_forward
from lichtfeld_studio_tpu_torch.ops.rasterize import _project, count_instances
from lichtfeld_studio_tpu_torch.ops.tiles import build_tile_assignment

MAX_INSTANCE_CAP = 1 << 22


class CoherentRenderer:
    """Stateful interactive renderer, one per viewer resolution.

    render(splats, camera) -> uint8 [H, W, 3]. Call it from one thread (the
    live server runs renders as jobs on the trainer's thread)."""

    def __init__(self, width: int, height: int, *, tile_size: int = 32,
                 instance_cap: int = 2 ** 21, dilate_px: float = 2.0,
                 drift_budget: float | None = None, max_reuse: int = 120):
        self.width, self.height = width, height
        self.tile_size = tile_size
        self.grid_w, self.grid_h = -(-width // tile_size), -(-height // tile_size)
        self.instance_cap = instance_cap
        self.dilate_px = float(dilate_px)
        # half the dilation is the margin for the drift ESTIMATE (a bound
        # from the rotation angle and the translation, not a reprojection)
        self.drift_budget = drift_budget if drift_budget is not None else 0.5 * dilate_px
        self.max_reuse = max_reuse
        self._cache = None  # dict: splats, version, w2c, pos, assignment, z_min
        self._reused = 0
        self.stats = {"bins": 0, "frames": 0, "instances": 0}

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _bin(self, splats: SplatData, params: CameraParams):
        """The dilated projection and the inference binning (P1): (tile
        assignment, the nearest visible depth)."""
        proj = _project(splats, params, tile_size=self.tile_size, dilate_px=self.dilate_px)
        assignment = build_tile_assignment(proj, grid_w=self.grid_w, grid_h=self.grid_h,
                                           instance_cap=self.instance_cap, need_grad=False)
        z_min = torch.where(proj.valid, proj.depth, float("inf")).min()
        return assignment, float(z_min)

    @torch.no_grad()
    def _frame(self, splats: SplatData, params: CameraParams, assignment, bg: torch.Tensor):
        """The feature-only projection and P2 against the cached binning:
        uint8 [H, W, 3] on the model's device."""
        proj = _project(splats, params, tile_size=self.tile_size, feature_only=True)
        v = proj.valid
        args = (torch.where(v[:, None], proj.mean2d, 0.0), torch.where(v[:, None], proj.conic, 0.0),
                torch.where(v, proj.opacity, 0.0), torch.where(v[:, None], proj.color, 0.0))
        image, alpha = blend_forward(assignment.tile_start, assignment.tile_count,
                                     assignment.gaussian_idx, *args, grid_w=self.grid_w,
                                     grid_h=self.grid_h, tile_size=self.tile_size)
        h, w = self.height, self.width
        image = image[:h, :w] + (1.0 - alpha[:h, :w, None]) * bg
        return torch.clamp(image * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)

    def _drift_px(self, w2c, pos, z_min: float, fx: float, fy: float) -> float:
        c = self._cache
        cosang = (np.trace(w2c[:3, :3] @ c["w2c"][:3, :3].T) - 1.0) * 0.5
        ang = float(np.arccos(np.clip(cosang, -1.0, 1.0)))
        dt = float(np.linalg.norm(pos - c["pos"]))
        f = max(fx, fy)
        # rotation sweeps <= (f + r^2/f) * ang at image radius r: bounded at
        # THIS image's corner radius; translation parallax <= f |dc| / z_nearest
        cx, cy = 0.5 * self.width, 0.5 * self.height
        corner = f + (cx * cx + cy * cy) / f
        return corner * ang + f * dt / max(z_min, 1e-3)

    def _grow(self, need: int) -> None:
        self.instance_cap = min(-(-need // 128) * 128, MAX_INSTANCE_CAP)

    @torch.no_grad()
    def render(self, splats: SplatData, camera: Camera | CameraParams,
               bg_color=(0.0, 0.0, 0.0), as_numpy: bool = True):
        """uint8 [H, W, 3]: numpy, or with as_numpy=False the tensor on the
        model's device. Raises when the dilated binning needs more than
        MAX_INSTANCE_CAP instances (the frame would be lossy)."""
        device = splats.means.device
        if isinstance(camera, Camera):
            w2c, pos = np.asarray(camera.w2c, np.float64), np.asarray(camera.cam_position, np.float64)
            fx, fy = float(camera.fx), float(camera.fy)
            params = camera.device_params(device)
        else:
            params = camera
            w2c = params.w2c.detach().cpu().numpy().astype(np.float64)
            pos = params.cam_position.detach().cpu().numpy().astype(np.float64)
            fx, fy = (float(x) for x in params.K[:2].tolist())
        c = self._cache
        new_model = c is None or c["splats"] is not splats
        need_bin = (
            new_model
            or c["version"] != splats.version
            or self._reused >= self.max_reuse
            or self._drift_px(w2c, pos, c["z_min"], fx, fy) > self.drift_budget
        )
        if need_bin:
            if new_model:
                # first bin of a model: probe the dilated instance count
                # (projection only) and seed a snug cap with 15% headroom
                probe = int(count_instances(splats, params, tile_size=self.tile_size,
                                            projection="ewa", dilate_px=self.dilate_px))
                if int(probe * 1.15) > self.instance_cap:
                    self._grow(int(probe * 1.15))
            assignment, z_min = self._bin(splats, params)
            n = int(assignment.n_instances)
            # the model grew since the probe: x1.25 steps, 128-aligned (every
            # binning and blend stage scales with the cap)
            while n > self.instance_cap and self.instance_cap < MAX_INSTANCE_CAP:
                self._grow(max(int(self.instance_cap * 1.25), int(n * 1.1)))
                assignment, z_min = self._bin(splats, params)
                n = int(assignment.n_instances)
            if n > self.instance_cap:
                raise RuntimeError(f"coherent renderer: {n} instances exceed the "
                                   f"{MAX_INSTANCE_CAP} cap ceiling")
            self._cache = {"splats": splats, "version": splats.version, "w2c": w2c, "pos": pos,
                           "assignment": assignment, "z_min": z_min}
            self._reused = 0
            self.stats["bins"] += 1
            self.stats["instances"] = n
        else:
            self._reused += 1
        bg = torch.tensor(bg_color, dtype=torch.float32, device=device)
        img = self._frame(splats, params, self._cache["assignment"], bg)
        self.stats["frames"] += 1
        return img.cpu().numpy() if as_numpy else img
