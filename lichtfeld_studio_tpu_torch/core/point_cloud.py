"""Point cloud container (reference: include/core/point_cloud.hpp).

Host-side numpy container produced by the loaders and consumed by
SplatData.from_point_cloud. Attribute semantics match the reference:
`colors` are uint8-range floats in [0, 255].
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class PointCloud:
    means: np.ndarray  # [N, 3] float32
    colors: Optional[np.ndarray] = None  # [N, 3] float32 in [0, 255]
    normals: Optional[np.ndarray] = None  # [N, 3]
    # Optional full gaussian attributes (populated by the PLY splat loader)
    sh0: Optional[np.ndarray] = None  # [N, 1, 3]
    shN: Optional[np.ndarray] = None  # [N, K-1, 3]
    opacity: Optional[np.ndarray] = None  # [N, 1] (logit)
    scaling: Optional[np.ndarray] = None  # [N, 3] (log)
    rotation: Optional[np.ndarray] = None  # [N, 4] (quat wxyz)
    attribute_names: list[str] = field(default_factory=list)

    @property
    def size(self) -> int:
        return int(self.means.shape[0])
