"""Sinusoidal background modulation (counterpart of
lichtfeld_studio_tpu/train/components/background.py; reference
trainer.cpp:474-577).

Phase-shifted RGB sines with coprime periods (37/41/43), jittered, mixed
into the base background with a piecewise schedule: full for the first
quarter of training, linear to 0.5 by the half, linear to 0 by three
quarters.

The step is a host integer, so the schedule and the sines are computed on
the host in float32, in the JAX package's order, and reach the device as
fill kernels (a pageable host-to-device copy would make the host wait for
the stream). The jitter is an argument: [3] draws of U[0, 1) on the device,
from the step's generator in the train step (tests inject the JAX
package's draws).
"""

from __future__ import annotations

import numpy as np
import torch

TWO_PI = 6.283185307179586
_PERIODS = (37, 41, 43)
_F32 = np.float32


def inv_weight_piecewise(step: int, max_steps: int) -> np.float32:
    """The sine's mixing weight at `step`: 1, then linear to 0.5 at the
    half, linear to 0 at three quarters (trainer.cpp:474-495)."""
    phase = np.clip(_F32(step) / _F32(max(max_steps, 1)), _F32(0.0), _F32(1.0))
    if phase < 0.25:
        return _F32(1.0)
    if phase < 0.5:
        return _F32(1.0) + _F32(0.5 - 1.0) * (phase - _F32(0.25)) / _F32(0.25)
    return _F32(0.5) + _F32(0.0 - 0.5) * (phase - _F32(0.5)) / _F32(0.25)


def _sines(step: int) -> np.ndarray:
    """0.5 (1 + sin(phase_c + c 2pi/3)) for c = r, g, b, float32 [3]."""
    out = []
    for c, p in enumerate(_PERIODS):
        phase = _F32(TWO_PI) * _F32(step % p) / _F32(p)
        if c:
            phase = phase + _F32(c * TWO_PI / 3.0)
        out.append(np.sin(phase, dtype=_F32))
    return _F32(0.5) * (_F32(1.0) + np.array(out, _F32))


def _on_device(values, like: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.full((), float(v), dtype=torch.float32, device=like.device)
                        for v in values])


def sine_background(step: int, jitter: torch.Tensor, jitter_amp: float = 0.03) -> torch.Tensor:
    """The jittered sine background [3] of `step`; `jitter` is [3] U[0, 1)."""
    eps = 1e-4
    bg = _on_device(_sines(step), jitter)
    return torch.clamp(bg + (jitter - 0.5) * (2.0 * jitter_amp), eps, 1.0 - eps)


def background_for_step(base_bg: torch.Tensor, step: int, max_steps: int,
                        jitter: torch.Tensor) -> torch.Tensor:
    """(1 - w) base_bg + w sine_background(step, jitter), w =
    inv_weight_piecewise(step, max_steps)."""
    w = inv_weight_piecewise(step, max_steps)
    return float(_F32(1.0) - w) * base_bg + float(w) * sine_background(step, jitter)
