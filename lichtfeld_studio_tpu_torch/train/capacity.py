"""Gaussian-capacity bucketing (counterpart of
lichtfeld_studio_tpu/train/capacity.py).

Every per-gaussian cost (projection, Adam, noise, relocation, the N side of
binning) scales with the static capacity, not the live count. The trainer
starts with a small capacity bucket and grows it (x2) as MCMC or ADC
density approaches it. The reference has no counterpart: its tensors are
exactly sized and pay reallocation and optimizer surgery on every refine
(mcmc.cpp:269-336).
"""

from __future__ import annotations

import torch
from torch import nn

from lichtfeld_studio_tpu_torch.ops.adam import AdamState
from lichtfeld_studio_tpu_torch.train.state import TrainState

# dead-slot fills, as SplatData.from_arrays pads (rotation: w = 1)
_FILL = {"scaling": -10.0, "opacity": -15.0}


def _pad_axis0(arr: torch.Tensor, new_c: int, fill: float = 0.0) -> torch.Tensor:
    c = arr.shape[0]
    if c >= new_c:
        return arr
    out = torch.full((new_c,) + tuple(arr.shape[1:]), fill, dtype=arr.dtype, device=arr.device)
    out[:c] = arr
    return out


@torch.no_grad()
def grow_capacity(state: TrainState, new_capacity: int) -> TrainState:
    """Pad every per-gaussian tensor of `state` to `new_capacity`, in place:
    new parameters (the old nn.Parameters are replaced), padded Adam moments,
    densification statistics and ADMM duals. Returns `state`."""
    splats = state.splats
    c = splats.capacity
    if new_capacity <= c:
        return state
    for name, p in splats.trainable_dict().items():
        padded = _pad_axis0(p.detach(), new_capacity, _FILL.get(name, 0.0))
        if name == "rotation":
            padded[c:, 0] = 1.0
        setattr(splats, name, nn.Parameter(padded))
    splats.mark_changed()

    def pad_tree(tree):
        return {k: _pad_axis0(a, new_capacity) for k, a in tree.items()}

    state.adam = AdamState(pad_tree(state.adam.exp_avg), pad_tree(state.adam.exp_avg_sq),
                           state.adam.step_count, state.adam.lr)
    state.densify_count = _pad_axis0(state.densify_count, new_capacity)
    state.densify_grad = _pad_axis0(state.densify_grad, new_capacity)
    state.admm_u = _pad_axis0(state.admm_u, new_capacity)
    state.admm_z = _pad_axis0(state.admm_z, new_capacity)
    return state


def initial_capacity(n_init: int, max_cap: int, headroom: float = 2.0) -> int:
    """First bucket: the power of two >= headroom * n_init, within
    [2^15, max_cap]."""
    target = max(int(n_init * headroom), 2**15)
    cap = 1 << (target - 1).bit_length()
    return min(cap, max_cap)
