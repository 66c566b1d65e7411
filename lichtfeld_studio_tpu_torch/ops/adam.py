"""Per-group Adam with the FusedAdam shN freeze (counterpart of
lichtfeld_studio_tpu/ops/adam.py; reference fused_adam.{cpp,hpp} and
fastgs/optimizer/adam_kernels.cuh:13-37).

Functional, as in the JAX package, and not torch.optim.Adam (whose step
count and skip semantics differ):

  * per-group learning rates (means/sh0/shN/scaling/rotation/opacity,
    mcmc.cpp:487-492) as tensors, so a schedule multiplies them on the
    device;
  * eps = 1e-15, betas = (0.9, 0.999) (mcmc.cpp:485-486);
  * `static_skip` freezes whole groups (the shN heuristic while
    iter <= 1000, fused_adam.cpp:69-71): the update is omitted, but the
    step count still advances (the reference counts before it skips);
  * per-group step counts for bias correction.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

BETA1 = 0.9
BETA2 = 0.999
EPS = 1e-15


@dataclass
class AdamState:
    exp_avg: dict[str, torch.Tensor]
    exp_avg_sq: dict[str, torch.Tensor]
    step_count: dict[str, torch.Tensor]  # per-group [] int32
    lr: dict[str, torch.Tensor]  # per-group [] float32


def init_adam(params: dict[str, torch.Tensor], lrs: dict[str, float]) -> AdamState:
    dev = next(iter(params.values())).device if params else torch.device("cpu")
    return AdamState(
        exp_avg={k: torch.zeros_like(p, requires_grad=False) for k, p in params.items()},
        exp_avg_sq={k: torch.zeros_like(p, requires_grad=False) for k, p in params.items()},
        step_count={k: torch.zeros((), dtype=torch.int32, device=dev) for k in params},
        lr={k: torch.tensor(v, dtype=torch.float32, device=dev) for k, v in lrs.items()},
    )


@torch.no_grad()
def adam_step(
    params: dict[str, torch.Tensor],
    grads: dict[str, torch.Tensor],
    state: AdamState,
    *,
    static_skip: tuple[str, ...] = (),
) -> tuple[dict[str, torch.Tensor], AdamState]:
    """One Adam step: new parameter values and a new state (the inputs are
    not modified)."""
    new_params, new_m, new_v, new_c = {}, {}, {}, {}
    for k, p in params.items():
        m, v = state.exp_avg[k], state.exp_avg_sq[k]
        c1 = state.step_count[k] + 1  # advances even when skipped
        new_c[k] = c1
        if k in static_skip:
            new_params[k], new_m[k], new_v[k] = p, m, v
            continue
        g = grads[k]
        t = c1.to(torch.float32)
        bc1 = 1.0 - BETA1**t
        bc2 = 1.0 - BETA2**t
        step_size = state.lr[k] * torch.sqrt(bc2) / bc1
        m1 = BETA1 * m + (1.0 - BETA1) * g
        v1 = BETA2 * v + (1.0 - BETA2) * g * g
        new_params[k] = p - step_size * m1 / (torch.sqrt(v1) + EPS)
        new_m[k], new_v[k] = m1, v1
    return new_params, AdamState(new_m, new_v, new_c, state.lr)


def scale_lrs(state: AdamState, gamma: float, groups: tuple[str, ...] | None = None) -> AdamState:
    """ExponentialLR step (reference scheduler.hpp:11-59): lr *= gamma for
    the selected groups (None = all)."""
    lr = {k: (v * gamma if groups is None or k in groups else v) for k, v in state.lr.items()}
    return AdamState(state.exp_avg, state.exp_avg_sq, state.step_count, lr)
