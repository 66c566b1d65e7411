"""Geometry primitives: axis-aligned bounding box + SE(3) transform
(counterpart of lichtfeld_studio_tpu/core/geometry.py; host numpy, as there).

Reference: src/geometry/{bounding_box,euclidean_transform}.cpp,
include/geometry/*.hpp (glm-based). Used by scene cropping, the crop-box
tool and dataset transforms.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class BoundingBox:
    min: np.ndarray = field(default_factory=lambda: np.full(3, -1.0, np.float32))
    max: np.ndarray = field(default_factory=lambda: np.full(3, 1.0, np.float32))

    @property
    def center(self) -> np.ndarray:
        return 0.5 * (self.min + self.max)

    @property
    def size(self) -> np.ndarray:
        return self.max - self.min

    def contains(self, points: np.ndarray) -> np.ndarray:
        """[N, 3] -> [N] bool."""
        return np.all((points >= self.min) & (points <= self.max), axis=-1)

    def expanded(self, margin: float) -> "BoundingBox":
        return BoundingBox(self.min - margin, self.max + margin)

    @staticmethod
    def from_points(points: np.ndarray) -> "BoundingBox":
        return BoundingBox(points.min(axis=0), points.max(axis=0))


def _quat_to_rotmat_np(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float64,
    )


def _rotmat_to_quat_np(m: np.ndarray) -> np.ndarray:
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    return np.array([w, x, y, z])


@dataclass
class EuclideanTransform:
    """SE(3) as quaternion (wxyz) + translation (reference
    euclidean_transform.hpp)."""

    quat: np.ndarray = field(default_factory=lambda: np.array([1.0, 0, 0, 0]))
    translation: np.ndarray = field(default_factory=lambda: np.zeros(3))

    @property
    def rotation(self) -> np.ndarray:
        return _quat_to_rotmat_np(self.quat)

    def apply(self, points: np.ndarray) -> np.ndarray:
        return points @ self.rotation.T + self.translation

    def compose(self, other: "EuclideanTransform") -> "EuclideanTransform":
        """self * other (apply `other` first)."""
        r = self.rotation @ other.rotation
        t = self.rotation @ other.translation + self.translation
        return EuclideanTransform(_rotmat_to_quat_np(r), t)

    def inverse(self) -> "EuclideanTransform":
        r_inv = self.rotation.T
        return EuclideanTransform(
            _rotmat_to_quat_np(r_inv), -(r_inv @ self.translation)
        )

    def to_matrix(self) -> np.ndarray:
        m = np.eye(4)
        m[:3, :3] = self.rotation
        m[:3, 3] = self.translation
        return m

    @staticmethod
    def from_matrix(m: np.ndarray) -> "EuclideanTransform":
        return EuclideanTransform(_rotmat_to_quat_np(m[:3, :3]), m[:3, 3].copy())

    @staticmethod
    def from_euler(roll: float, pitch: float, yaw: float, translation=None) -> "EuclideanTransform":
        cr, sr = np.cos(roll / 2), np.sin(roll / 2)
        cp, sp = np.cos(pitch / 2), np.sin(pitch / 2)
        cy, sy = np.cos(yaw / 2), np.sin(yaw / 2)
        q = np.array(
            [
                cr * cp * cy + sr * sp * sy,
                sr * cp * cy - cr * sp * sy,
                cr * sp * cy + sr * cp * sy,
                cr * cp * sy - sr * sp * cy,
            ]
        )
        return EuclideanTransform(q, np.zeros(3) if translation is None else np.asarray(translation, np.float64))
