"""The Gaussian splat model as a torch `nn.Module` (counterpart of
lichtfeld_studio_tpu/core/splat_data.py).

Same layout as the JAX package: arrays sized to a static `capacity`, the
live slots a prefix of length `n_active`, raw parameterisations (`scaling`
is log(sigma), `opacity` is logit(alpha), `rotation` an unnormalised wxyz
quaternion, `sh0`/`shN` [C,1,3]/[C,K-1,3] SH coefficients).

The model is written in place (Adam, the strategies' refines, capacity
growth), so the object alone does not say whether it changed: `version`
counts the writes, each through `mark_changed`. A cache of anything derived
from the model (render/coherent.py's binning) keys on (object, version).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from lichtfeld_studio_tpu_torch.core.point_cloud import PointCloud

SH_C0 = 0.28209479177387814

_PARAM_NAMES = ("means", "sh0", "shN", "scaling", "rotation", "opacity")


class SplatData(nn.Module):
    def __init__(
        self,
        means: torch.Tensor,
        sh0: torch.Tensor,
        shN: torch.Tensor,
        scaling: torch.Tensor,
        rotation: torch.Tensor,
        opacity: torch.Tensor,
        n_active: int,
        active_sh_degree: int,
        max_sh_degree: int = 3,
        scene_scale: float = 1.0,
    ):
        super().__init__()
        for name, value in zip(
            _PARAM_NAMES, (means, sh0, shN, scaling, rotation, opacity)
        ):
            setattr(self, name, nn.Parameter(value.to(torch.float32)))
        device = means.device
        self.register_buffer("n_active", torch.tensor(int(n_active), dtype=torch.int32, device=device))
        self.register_buffer(
            "active_sh_degree",
            torch.tensor(int(active_sh_degree), dtype=torch.int32, device=device),
        )
        self.max_sh_degree = int(max_sh_degree)
        self.scene_scale = float(scene_scale)
        self.version = 0  # in-place writes so far (mark_changed)

    # ------------------------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    @property
    def n_sh_bases(self) -> int:
        return 1 + self.shN.shape[1]

    def mark_changed(self) -> None:
        """Record an in-place write of the model: every writer calls it."""
        self.version += 1

    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity)

    def get_rotation(self) -> torch.Tensor:
        norm = torch.linalg.norm(self.rotation, dim=-1, keepdim=True)
        return self.rotation / torch.clamp(norm, min=1e-12)

    def active_mask(self) -> torch.Tensor:
        """[C] bool — True for live slots."""
        idx = torch.arange(self.capacity, dtype=torch.int32, device=self.means.device)
        return idx < self.n_active

    def trainable_dict(self) -> dict[str, nn.Parameter]:
        """The six optimizable parameters, keyed by parameter-group name
        (order mirrors the reference optimizer groups, mcmc.cpp:487-492)."""
        return {name: getattr(self, name) for name in _PARAM_NAMES}

    def replace_trainable(self, params: dict[str, torch.Tensor]) -> "SplatData":
        """Write new values into the named parameters, in place (the
        Parameter objects stay, so autograd and the optimizer keep their
        leaves). Returns self."""
        with torch.no_grad():
            for name, value in params.items():
                getattr(self, name).copy_(value)
        self.mark_changed()
        return self

    def increment_sh_degree(self) -> "SplatData":
        """active_sh_degree += 1, capped at max_sh_degree, in place."""
        with torch.no_grad():
            self.active_sh_degree.copy_(
                torch.clamp(self.active_sh_degree + 1, max=self.max_sh_degree)
            )
        self.mark_changed()
        return self

    # ------------------------------------------------------------------
    @staticmethod
    def from_point_cloud(
        positions: np.ndarray,
        colors_rgb01: np.ndarray,
        scene_center: np.ndarray,
        *,
        capacity: int,
        max_sh_degree: int = 3,
        init_opacity: float = 0.5,
        init_scaling: float = 0.1,
        device: str | torch.device = "cpu",
    ) -> "SplatData":
        """Initialise from SfM points (reference splat_data.cpp:508-608):
        scene_scale = median distance of the points to scene_center;
        log-scales log(sqrt(mean 3-NN distance) * init_scaling); identity
        quaternions, logit(init_opacity), DC SH from RGB; the slots
        [N, capacity) are dead padding. Host numpy, as in the JAX package."""
        positions = np.asarray(positions, dtype=np.float32)
        colors_rgb01 = np.asarray(colors_rgb01, dtype=np.float32)
        n = positions.shape[0]
        if n > capacity:
            raise ValueError(f"point count {n} exceeds capacity {capacity}")

        dists = np.linalg.norm(positions - np.asarray(scene_center, np.float32)[None], axis=1)
        scene_scale = float(np.median(dists)) if n else 1.0
        nn_dist = np.clip(_mean_neighbor_distances(positions), 1e-7, None)
        log_scales = np.log(np.sqrt(nn_dist) * init_scaling).astype(np.float32)

        eps = 1e-7
        p = min(max(init_opacity, eps), 1 - eps)
        n_bases = (max_sh_degree + 1) ** 2
        sd = SplatData.from_arrays(
            positions,
            ((colors_rgb01 - 0.5) / SH_C0)[:, None, :],
            np.zeros((n, n_bases - 1, 3), np.float32),
            np.repeat(log_scales[:, None], 3, axis=1),
            np.tile(np.asarray([1.0, 0.0, 0.0, 0.0], np.float32), (n, 1)),
            np.full((n, 1), np.log(p / (1 - p)), np.float32),
            capacity=capacity, max_sh_degree=max_sh_degree, scene_scale=scene_scale,
            device=device,
        )
        sd.active_sh_degree.zero_()
        return sd

    @staticmethod
    def random_init(
        generator: torch.Generator,
        *,
        num_points: int,
        extent: float,
        capacity: int,
        max_sh_degree: int = 3,
        init_opacity: float = 0.5,
        init_scaling: float = 0.1,
        device: str | torch.device = "cpu",
    ) -> "SplatData":
        """Random init (reference splat_data.cpp:516-528): uniform positions
        in [-extent, extent]^3 stretched by scene_scale, random colours.
        `generator` is a CPU generator: the cloud is made on the host, where
        the kNN scale init runs. scene_scale is the median of the UNSCALED
        cloud (splat_data.cpp:528-531), kept as the model's scene_scale."""
        positions = ((torch.rand((num_points, 3), generator=generator) * 2.0 - 1.0) * extent).numpy()
        colors = torch.rand((num_points, 3), generator=generator).numpy()
        scene_center = np.zeros(3, np.float32)
        scene_scale = float(np.median(np.linalg.norm(positions - scene_center[None], axis=1)))
        sd = SplatData.from_point_cloud(
            positions * scene_scale, colors, scene_center, capacity=capacity,
            max_sh_degree=max_sh_degree, init_opacity=init_opacity, init_scaling=init_scaling,
            device=device,
        )
        sd.scene_scale = scene_scale
        return sd

    @staticmethod
    def from_arrays(
        means: np.ndarray,
        sh0: np.ndarray,
        shN: np.ndarray,
        scaling: np.ndarray,
        rotation: np.ndarray,
        opacity: np.ndarray,
        *,
        capacity: int | None = None,
        max_sh_degree: int | None = None,
        scene_scale: float = 1.0,
        device: str | torch.device = "cpu",
    ) -> "SplatData":
        """Build from host arrays (e.g. a loaded PLY); dead slots are padded
        exactly as the JAX package pads them."""
        n = means.shape[0]
        c = capacity or n
        if max_sh_degree is None:
            max_sh_degree = int(round(np.sqrt(shN.shape[1] + 1))) - 1

        def pad(x, fill=0.0):
            out = np.full((c,) + x.shape[1:], fill, np.float32)
            out[:n] = x
            return torch.from_numpy(out).to(device)

        rot_p = np.zeros((c, 4), np.float32)
        rot_p[:, 0] = 1.0
        rot_p[:n] = np.asarray(rotation, np.float32)
        return SplatData(
            means=pad(np.asarray(means, np.float32)),
            sh0=pad(np.asarray(sh0, np.float32)),
            shN=pad(np.asarray(shN, np.float32)),
            scaling=pad(np.asarray(scaling, np.float32), fill=-10.0),
            rotation=torch.from_numpy(rot_p).to(device),
            opacity=pad(np.asarray(opacity, np.float32), fill=-15.0),
            n_active=n,
            active_sh_degree=max_sh_degree,
            max_sh_degree=max_sh_degree,
            scene_scale=scene_scale,
        )

    @staticmethod
    def from_numpy(arrays: dict, device: str | torch.device = "cpu") -> "SplatData":
        """Carry a JAX SplatData across: `arrays` holds its fields as numpy
        (`means, sh0, shN, scaling, rotation, opacity, n_active,
        active_sh_degree`) plus `max_sh_degree` and `scene_scale`; the slots
        are taken as they are, without re-padding."""

        def t(name):
            return torch.from_numpy(np.array(arrays[name], np.float32)).to(device)

        return SplatData(
            *(t(name) for name in _PARAM_NAMES),
            n_active=int(arrays["n_active"]),
            active_sh_degree=int(arrays["active_sh_degree"]),
            max_sh_degree=int(arrays["max_sh_degree"]),
            scene_scale=float(arrays["scene_scale"]),
        )

    # ------------------------------------------------------------------
    def to_point_cloud(self) -> PointCloud:
        """Live slots as a host PointCloud in PLY attribute order (the JAX
        package's to_point_cloud: quaternions normalised)."""
        n = int(self.n_active)
        with torch.no_grad():
            def host(x):
                return x[:n].detach().cpu().numpy()

            means = host(self.means)
            return PointCloud(
                means=means,
                normals=np.zeros_like(means),
                sh0=host(self.sh0),
                shN=host(self.shN),
                opacity=host(self.opacity),
                scaling=host(self.scaling),
                rotation=host(self.get_rotation()),
                attribute_names=self.get_attribute_names(),
            )

    def _live_host(self):
        """The live slots' six parameters as host numpy, in from_arrays order."""
        n = int(self.n_active)
        with torch.no_grad():
            return [getattr(self, name)[:n].detach().cpu().numpy() for name in _PARAM_NAMES]

    def crop_by_bbox(self, bbox) -> "SplatData":
        """Keep only gaussians inside the box (reference
        SplatData::crop_by_cropbox, splat_data.cpp:616+). Compacts on the
        host; returns a new SplatData with the same capacity, on the same
        device."""
        arrays = self._live_host()
        idx = np.nonzero(bbox.contains(arrays[0]))[0]
        return SplatData.from_arrays(
            *(a[idx] for a in arrays), capacity=self.capacity,
            max_sh_degree=self.max_sh_degree, scene_scale=self.scene_scale,
            device=self.means.device)

    def transformed(self, transform) -> "SplatData":
        """Apply an SE(3) EuclideanTransform to the model (reference
        SplatData::transform): rotates means and composes quaternions, on
        the host; returns a new SplatData on the same device."""
        means, sh0, shN, scaling, rotation, opacity = self._live_host()
        r = transform.rotation.astype(np.float32)
        t = transform.translation.astype(np.float32)
        means = means @ r.T + t
        # q_new = q_transform * q_old (hamilton product, wxyz)
        q_t = transform.quat / np.linalg.norm(transform.quat)
        qn = rotation / np.maximum(np.linalg.norm(rotation, axis=1, keepdims=True), 1e-12)
        w1, x1, y1, z1 = q_t
        w2, x2, y2, z2 = qn[:, 0], qn[:, 1], qn[:, 2], qn[:, 3]
        q_new = np.stack(
            [
                w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            ],
            axis=1,
        ).astype(np.float32)
        return SplatData.from_arrays(
            means, sh0, shN, scaling, q_new, opacity, capacity=self.capacity,
            max_sh_degree=self.max_sh_degree, scene_scale=self.scene_scale,
            device=self.means.device)

    def get_attribute_names(self) -> list[str]:
        """PLY attribute order (reference splat_data.cpp:402-418)."""
        names = ["x", "y", "z", "nx", "ny", "nz"]
        names += [f"f_dc_{i}" for i in range(self.sh0.shape[1] * 3)]
        names += [f"f_rest_{i}" for i in range(self.shN.shape[1] * 3)]
        names += ["opacity"]
        names += [f"scale_{i}" for i in range(self.scaling.shape[1])]
        names += [f"rot_{i}" for i in range(self.rotation.shape[1])]
        return names


def _mean_neighbor_distances(points: np.ndarray) -> np.ndarray:
    """Mean distance to the 3 nearest neighbours (d^2 > 1e-8) per point;
    0.01 when no valid neighbour (reference splat_data.cpp:62-111)."""
    n = points.shape[0]
    if n <= 1:
        return np.full((n,), 0.01, np.float32)
    from scipy.spatial import cKDTree

    tree = cKDTree(points)
    k = min(4, n)
    dists, _ = tree.query(points, k=k)  # includes self at distance ~0
    valid = dists**2 > 1e-8
    # up to the first 3 valid neighbours per row
    take = valid & (np.cumsum(valid, axis=1) <= 3)
    counts = take.sum(axis=1)
    sums = (dists * take).sum(axis=1)
    return np.where(counts > 0, sums / np.maximum(counts, 1), 0.01).astype(np.float32)
