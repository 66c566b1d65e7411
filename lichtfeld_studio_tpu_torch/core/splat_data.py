"""The Gaussian splat model as a torch `nn.Module` (counterpart of
lichtfeld_studio_tpu/core/splat_data.py).

Same layout as the JAX package: arrays sized to a static `capacity`, the
live slots a prefix of length `n_active`, raw parameterisations (`scaling`
is log(sigma), `opacity` is logit(alpha), `rotation` an unnormalised wxyz
quaternion, `sh0`/`shN` [C,1,3]/[C,K-1,3] SH coefficients).
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

    # ------------------------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.means.shape[0]

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
        return self

    def increment_sh_degree(self) -> "SplatData":
        """active_sh_degree += 1, capped at max_sh_degree, in place."""
        with torch.no_grad():
            self.active_sh_degree.copy_(
                torch.clamp(self.active_sh_degree + 1, max=self.max_sh_degree)
            )
        return self

    # ------------------------------------------------------------------
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

    def get_attribute_names(self) -> list[str]:
        """PLY attribute order (reference splat_data.cpp:402-418)."""
        names = ["x", "y", "z", "nx", "ny", "nz"]
        names += [f"f_dc_{i}" for i in range(self.sh0.shape[1] * 3)]
        names += [f"f_rest_{i}" for i in range(self.shN.shape[1] * 3)]
        names += ["opacity"]
        names += [f"scale_{i}" for i in range(self.scaling.shape[1])]
        names += [f"rot_{i}" for i in range(self.rotation.shape[1])]
        return names
