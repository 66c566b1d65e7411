"""ADMM opacity sparsification (counterpart of
lichtfeld_studio_tpu/train/components/sparsity.py; reference
src/training/components/sparsity_optimizer.{cpp,hpp}:21-145).

After base training, an ADMM penalty drives `prune_ratio` of the
opacities toward zero over `sparsify_steps` iterations, then the
lowest-opacity gaussians are pruned:

  loss      = rho/2 * || sigmoid(op) - z + u ||^2          (:58-62)
  z-update  = Pi_sparse(sigmoid(op) + u)   every 50 iters  (:85-90)
  u-update  = u + sigmoid(op) - z                          (:91)

Pi_sparse zeroes the smallest `prune_ratio` fraction of the live entries.
The ranks come from a stable sort, as jnp.argsort's: the dead slots tie at
+inf behind the live prefix.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

UPDATE_EVERY = 50  # reference trainer.cpp:744-754 dual update cadence


@dataclass
class ADMMState:
    u: torch.Tensor  # [C]
    z: torch.Tensor  # [C]


def _ranks(values: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Rank of each live value among the live values (ascending); the dead
    slots rank last."""
    key = torch.where(active, values, torch.inf)
    order = torch.argsort(key, stable=True)
    return torch.empty_like(order).scatter_(0, order, torch.arange(order.shape[0],
                                                                   device=order.device))


def _n_prune(prune_ratio: float, n_active: torch.Tensor) -> torch.Tensor:
    return (prune_ratio * n_active.to(torch.float32)).to(torch.int64)


def _prune_z(values: torch.Tensor, active: torch.Tensor, prune_ratio: float,
             n_active: torch.Tensor) -> torch.Tensor:
    """Project onto the sparsity set: zero the smallest prune_ratio
    fraction of the live entries (sparsity_optimizer.cpp prune_z)."""
    keep = _ranks(values, active) >= _n_prune(prune_ratio, n_active)
    return torch.where(keep & active, values, 0.0)


def _live_opacity(opacities_logit: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    return torch.where(active, torch.sigmoid(opacities_logit[:, 0]), 0.0)


@torch.no_grad()
def init_admm(opacities_logit: torch.Tensor, active: torch.Tensor, n_active: torch.Tensor,
              prune_ratio: float) -> ADMMState:
    opa = _live_opacity(opacities_logit, active)
    u = torch.zeros_like(opa)
    return ADMMState(u=u, z=_prune_z(opa + u, active, prune_ratio, n_active))


def sparsity_loss(opacities_logit: torch.Tensor, active: torch.Tensor, state: ADMMState,
                  rho: float) -> torch.Tensor:
    """rho / 2 * sum over the live slots of (sigmoid(op) - z + u)^2; z and
    u are constants of the step."""
    opa = torch.sigmoid(opacities_logit[:, 0])
    diff = torch.where(active, opa - state.z.detach() + state.u.detach(), 0.0)
    return 0.5 * rho * (diff * diff).sum()


@torch.no_grad()
def update_admm(opacities_logit: torch.Tensor, active: torch.Tensor, n_active: torch.Tensor,
                state: ADMMState, prune_ratio: float) -> ADMMState:
    opa = _live_opacity(opacities_logit, active)
    z = _prune_z(opa + state.u, active, prune_ratio, n_active)
    return ADMMState(u=state.u + opa - z, z=z)


@torch.no_grad()
def prune_mask(opacities_logit: torch.Tensor, active: torch.Tensor, n_active: torch.Tensor,
               prune_ratio: float) -> torch.Tensor:
    """True for the `prune_ratio` fraction of the live slots with the
    smallest opacity (sparsity_optimizer.cpp:107-135)."""
    opa = torch.sigmoid(opacities_logit[:, 0])
    return active & (_ranks(opa, active) < _n_prune(prune_ratio, n_active))
