"""MCMC densification strategy at static capacity (counterpart of
lichtfeld_studio_tpu/train/strategies/mcmc.py; reference
src/training/strategies/mcmc.cpp).

Capacity is fixed at `max_cap`; growth raises n_active and writes into the
fresh slots:

* relocate_gs (mcmc.cpp:112-190): dead = opacity <= min or degenerate
  quaternion; every dead slot takes a source sampled from the alive opacity
  distribution by inverse CDF;
* add_new_gs (mcmc.cpp:192-347): grow 5% toward max_cap, the new slots
  sample sources the same way;
* sources get the relocation-split opacity and scale, and targets copy the
  updated source parameters; relocation zeroes the sources' Adam moments
  (mcmc.cpp:86-110), growth keeps them;
* noise every step with the current means lr (mcmc.cpp:349-367).

The parameters of `splats` are updated in place (the port may where that
saves memory); the Adam state is returned anew. Every random draw comes
from a torch.Generator on the device, in the order of the JAX package's
key splits; `draws` injects them instead (the tests hand in JAX's).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from lichtfeld_studio_tpu_torch.core.splat_data import SplatData
from lichtfeld_studio_tpu_torch.ops.adam import AdamState
from lichtfeld_studio_tpu_torch.ops.mcmc_ops import add_noise, relocation

NOISE_LR = 5e5  # reference mcmc.hpp:79


@dataclass(frozen=True)
class MCMCConfig:
    max_cap: int = 1_000_000
    min_opacity: float = 0.005
    start_refine: int = 500
    stop_refine: int = 25_000
    refine_every: int = 100
    sh_degree_interval: int = 1_000
    grow_factor: float = 1.05


def _sample_multinomial(u: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """One sample per uniform draw u in [0, 1), with replacement, ~ probs by
    inverse CDF (probs need not be normalised; zero entries are never
    chosen)."""
    cdf = torch.cumsum(probs, 0)
    idx = torch.searchsorted(cdf, u * cdf[-1], right=True)
    return torch.clamp(idx, 0, probs.shape[0] - 1)


@torch.no_grad()
def _apply_relocation(
    splats: SplatData,
    adam: AdamState,
    target_mask: torch.Tensor,  # [C] bool — slots to overwrite (dead or new)
    src: torch.Tensor,  # [C] int64 — source per slot (read where target)
    binoms: torch.Tensor,
    min_opacity: float,
    *,
    zero_source_moments: bool,
) -> tuple[SplatData, AdamState]:
    """Split each source `1 + #targets` ways, write the new opacity and
    scale back to the source, copy every parameter from source to target.
    The relocation is evaluated for every slot and applied with selects."""
    c = splats.capacity
    opac = torch.sigmoid(splats.opacity[:, 0])
    # ratio per source = 1 + (#targets sampling it)  (mcmc.cpp:144-150)
    occ = torch.zeros(c, dtype=torch.int64, device=src.device).scatter_add_(
        0, src, target_mask.to(torch.int64))
    is_source = torch.zeros(c + 1, dtype=torch.bool, device=src.device)
    is_source.index_put_((torch.where(target_mask, src, c),), torch.tensor(True, device=src.device))
    is_source = is_source[:c]

    new_op, new_scales = relocation(opac, torch.exp(splats.scaling), 1 + occ, binoms)
    new_op = torch.clamp(new_op, min_opacity, 1.0 - 1e-7)
    new_logit = torch.log(new_op) - torch.log1p(-new_op)
    new_log_scales = torch.log(torch.clamp(new_scales, min=1e-20))

    # 1) the sources first (reference order), 2) targets copy the sources
    updated = {
        "opacity": torch.where(is_source[:, None], new_logit[:, None], splats.opacity),
        "scaling": torch.where(is_source[:, None], new_log_scales, splats.scaling),
    }

    def copy_to_targets(arr):
        return torch.where(target_mask.reshape((c,) + (1,) * (arr.ndim - 1)), arr[src], arr)

    splats.replace_trainable({
        k: copy_to_targets(updated.get(k, p)) for k, p in splats.trainable_dict().items()
    })
    if zero_source_moments:
        def zero_src(tree):
            return {k: torch.where(is_source.reshape((c,) + (1,) * (a.ndim - 1)), 0.0, a)
                    for k, a in tree.items()}

        adam = AdamState(zero_src(adam.exp_avg), zero_src(adam.exp_avg_sq),
                         adam.step_count, adam.lr)
    return splats, adam


def relocate_gs(
    u: torch.Tensor,  # [C] uniform draws
    splats: SplatData,
    adam: AdamState,
    binoms: torch.Tensor,
    cfg: MCMCConfig,
) -> tuple[SplatData, AdamState]:
    active = splats.active_mask()
    opac = torch.sigmoid(splats.opacity[:, 0].detach())
    qnorm = (splats.rotation.detach() ** 2).sum(-1)
    dead = active & ((opac <= cfg.min_opacity) | (qnorm < 1e-8))
    alive = active & ~dead
    src = _sample_multinomial(u, torch.where(alive, opac, 0.0))
    target = dead & alive.any()
    return _apply_relocation(splats, adam, target, src, binoms, cfg.min_opacity,
                             zero_source_moments=True)


def add_new_gs(
    u: torch.Tensor,  # [C] uniform draws
    splats: SplatData,
    adam: AdamState,
    binoms: torch.Tensor,
    cfg: MCMCConfig,
) -> tuple[SplatData, AdamState]:
    n = splats.n_active
    # float32 product, truncated, as the JAX package computes it
    n_target = torch.clamp((cfg.grow_factor * n.to(torch.float32)).to(torch.int32), max=cfg.max_cap)
    idx = torch.arange(splats.capacity, dtype=torch.int32, device=n.device)
    new_mask = (idx >= n) & (idx < n_target)
    opac = torch.sigmoid(splats.opacity[:, 0].detach())
    src = _sample_multinomial(u, torch.where(splats.active_mask(), opac, 0.0))
    splats, adam = _apply_relocation(splats, adam, new_mask, src, binoms, cfg.min_opacity,
                                     zero_source_moments=False)
    splats.n_active.copy_(n_target)
    splats.mark_changed()
    return splats, adam


def draw(generator: torch.Generator, capacity: int, refine: bool) -> dict[str, torch.Tensor]:
    """post_backward's random draws, in the order of the JAX package's key
    splits (mcmc.py:215): relocation and growth uniforms on refine steps,
    then the noise."""
    dev = generator.device
    out = {}
    if refine:
        out["relocate"] = torch.rand(capacity, generator=generator, device=dev)
        out["add"] = torch.rand(capacity, generator=generator, device=dev)
    out["noise"] = torch.randn((capacity, 3), generator=generator, device=dev)
    return out


@torch.no_grad()
def post_backward(
    generator: torch.Generator | None,
    splats: SplatData,
    adam: AdamState,
    binoms: torch.Tensor,
    cfg: MCMCConfig,
    *,
    refine: bool = False,
    sh_step: bool = False,
    draws: dict[str, torch.Tensor] | None = None,
) -> tuple[SplatData, AdamState]:
    """SH schedule + refine + noise (reference mcmc.cpp:369-393). `draws`
    (keys "relocate", "add", "noise") replaces the generator's draws."""
    if sh_step:
        splats.increment_sh_degree()
    if draws is None:
        draws = draw(generator, splats.capacity, refine)
    if refine:
        splats, adam = relocate_gs(draws["relocate"], splats, adam, binoms, cfg)
        splats, adam = add_new_gs(draws["add"], splats, adam, binoms, cfg)
    new_means = add_noise(
        splats.opacity, splats.scaling, splats.rotation, splats.means, splats.active_mask(),
        draws["noise"], adam.lr["means"] * NOISE_LR,
    )
    splats.replace_trainable({"means": new_means})
    return splats, adam
