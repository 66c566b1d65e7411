"""ADC ("default") densification strategy at static capacity (counterpart
of lichtfeld_studio_tpu/train/strategies/adc.py; reference
src/training/strategies/default_strategy.cpp).

Fixed capacity with an n_active prefix, as in the JAX package:

* duplicate: copies of the selected gaussians go into fresh slots;
* split: the original slot is overwritten in place with the first sample
  (scale / 1.6, resampled position) and the second sample is appended;
  the Adam moments of split gaussians are zeroed;
* prune: a stable partition moves the live slots to the front (one
  permutation applied to parameters and moments);
* densification statistics (visible count and pixel-scaled mean2d
  gradient-norm sums, kernels_backward.cuh:233-235) are two [C] tensors of
  TrainState, fed by d loss / d mean2d of the render.

Growth drops the candidates that would land beyond the capacity. The
parameters of `splats` are updated in place; the Adam state is returned
anew. The two normal draws of a split come from a torch.Generator on the
device; `draws` injects them instead (the tests hand in JAX's).
"""

from __future__ import annotations

import torch

from lichtfeld_studio_tpu_torch.core.splat_data import SplatData
from lichtfeld_studio_tpu_torch.ops.adam import AdamState
from lichtfeld_studio_tpu_torch.ops.gaussians import quat_to_rotmat


def _logit(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x) - torch.log1p(-x)


def _bcast(mask: torch.Tensor, arr: torch.Tensor) -> torch.Tensor:
    return mask.reshape((mask.shape[0],) + (1,) * (arr.ndim - 1))


def _scatter_params(splats: SplatData, src_mask: torch.Tensor, dest: torch.Tensor,
                    transform: dict[str, torch.Tensor] | None = None) -> None:
    """Copy each masked gaussian's parameters to slot dest[i], in place.
    Destinations beyond the capacity are dropped (masked, not clamped).
    `transform` replaces the copied values of the named parameters."""
    sel = src_mask & (dest < splats.capacity)
    to = dest[sel].long()
    for name, p in splats.trainable_dict().items():
        vals = transform[name] if transform and name in transform else p.detach()
        p.data[to] = vals[sel]
    splats.mark_changed()


def draw(generator: torch.Generator, capacity: int, refine: bool) -> dict[str, torch.Tensor]:
    """post_backward's random draws: on refine steps the split's two normal
    samples (the in-place one first, as the JAX package splits its key)."""
    if not refine:
        return {}
    dev = generator.device
    return {
        "split_a": torch.randn((capacity, 3), generator=generator, device=dev),
        "split_b": torch.randn((capacity, 3), generator=generator, device=dev),
    }


@torch.no_grad()
def grow_gs(
    draws: dict[str, torch.Tensor],  # "split_a", "split_b": [C, 3] normal draws
    splats: SplatData,
    adam: AdamState,
    densify_count: torch.Tensor,  # [C]
    densify_grad: torch.Tensor,  # [C]
    cfg,
) -> tuple[SplatData, AdamState]:
    """Duplicate small and split large high-gradient gaussians
    (default_strategy.cpp:164-192 grow_gs, :49-162 duplicate/split)."""
    c = splats.capacity
    n = splats.n_active
    active = splats.active_mask()

    grads = densify_grad / torch.clamp(densify_count, min=1.0)
    is_high = (grads > cfg.grad_threshold) & active
    max_scale = splats.get_scaling().max(dim=-1).values
    is_small = max_scale <= cfg.grow_scale3d * splats.scene_scale
    dup = is_high & is_small
    split = is_high & ~is_small

    # --- duplicate: append copies ---
    d_rank = torch.cumsum(dup.to(torch.int32), 0) - 1
    n_dup = dup.sum(dtype=torch.int32)
    _scatter_params(splats, dup, n + d_rank)

    # --- split: overwrite in place + append the second sample ---
    rot = quat_to_rotmat(splats.rotation.detach())  # [C, 3, 3]
    scale = splats.get_scaling()

    def sample(z):
        return (rot * (scale * z)[:, None, :]).sum(-1)  # R @ (s * z)

    new_log_scale = torch.log(torch.clamp(scale / 1.6, min=1e-20))
    if cfg.revised_opacity:
        # 1 - sqrt(1 - sigmoid(op))  (default_strategy.cpp:119-122)
        op = torch.sigmoid(splats.opacity.detach())
        new_opacity = _logit(torch.clamp(1.0 - torch.sqrt(1.0 - op), 1e-7, 1 - 1e-7))
    else:
        new_opacity = splats.opacity.detach().clone()

    s_rank = torch.cumsum(split.to(torch.int32), 0) - 1
    means = splats.means.detach()
    means_a = means + sample(draws["split_a"])
    means_b = means + sample(draws["split_b"])
    _scatter_params(splats, split, n + n_dup + s_rank,
                    transform={"means": means_b, "scaling": new_log_scale, "opacity": new_opacity})

    # the first sample in place
    split3 = split[:, None]
    splats.replace_trainable({
        "means": torch.where(split3, means_a, splats.means),
        "scaling": torch.where(split3, new_log_scale, splats.scaling),
        "opacity": torch.where(split3, new_opacity, splats.opacity),
    })

    # zero the Adam moments at the in-place split slots (the reference
    # removes the originals and appends copies with zero state)
    def zero_at(tree):
        return {k: torch.where(_bcast(split, a), 0.0, a) for k, a in tree.items()}

    adam = AdamState(zero_at(adam.exp_avg), zero_at(adam.exp_avg_sq), adam.step_count, adam.lr)
    n_split = split.sum(dtype=torch.int32)
    splats.n_active.copy_(torch.clamp(n + n_dup + n_split, max=c))
    splats.mark_changed()
    return splats, adam


@torch.no_grad()
def prune_gs(iteration: int, splats: SplatData, adam: AdamState, cfg
             ) -> tuple[SplatData, AdamState]:
    """Prune by opacity, degenerate quaternion and size, then move the live
    slots to the front with a stable partition
    (default_strategy.cpp:229-249 + remove :195-227)."""
    c = splats.capacity
    active = splats.active_mask()
    op = torch.sigmoid(splats.opacity[:, 0])
    qnorm = (splats.rotation**2).sum(-1)
    is_prune = (op < cfg.prune_opacity) | (qnorm < 1e-8)
    if iteration > cfg.reset_every:
        is_prune = is_prune | (splats.get_scaling().max(dim=-1).values
                               > cfg.prune_scale3d * splats.scene_scale)
    keep = active & ~is_prune

    # stable partition: keepers first, in order (a bool does not sort
    # stably on every backend: sort its uint8)
    perm = torch.sort((~keep).to(torch.uint8), stable=True).indices
    new_n = keep.sum(dtype=torch.int32)
    in_prefix = torch.arange(c, device=keep.device) < new_n

    fills = {"means": 0.0, "sh0": 0.0, "shN": 0.0, "scaling": -10.0, "opacity": -15.0}
    new = {}
    for name, p in splats.trainable_dict().items():
        if name == "rotation":
            fill = torch.tensor([1.0, 0.0, 0.0, 0.0], device=p.device)
        else:
            fill = fills[name]
        new[name] = torch.where(_bcast(in_prefix, p), p.detach()[perm], fill)
    splats.replace_trainable(new)
    splats.n_active.copy_(new_n)
    splats.mark_changed()

    def permute(tree):
        return {k: torch.where(_bcast(in_prefix, a), a[perm], 0.0) for k, a in tree.items()}

    adam = AdamState(permute(adam.exp_avg), permute(adam.exp_avg_sq), adam.step_count, adam.lr)
    return splats, adam


@torch.no_grad()
def reset_opacity(splats: SplatData, adam: AdamState, cfg) -> tuple[SplatData, AdamState]:
    """Clamp the opacities to 2 * prune_opacity and zero the opacity
    moments (default_strategy.cpp:251-290)."""
    threshold = _logit(torch.tensor(2.0 * cfg.prune_opacity, dtype=torch.float32,
                                    device=splats.opacity.device))
    splats.replace_trainable({"opacity": torch.clamp(splats.opacity, max=threshold)})
    adam = AdamState(
        {**adam.exp_avg, "opacity": torch.zeros_like(adam.exp_avg["opacity"])},
        {**adam.exp_avg_sq, "opacity": torch.zeros_like(adam.exp_avg_sq["opacity"])},
        adam.step_count, adam.lr,
    )
    return splats, adam


@torch.no_grad()
def post_backward(
    generator: torch.Generator | None,
    iteration: int,
    splats: SplatData,
    adam: AdamState,
    densify_count: torch.Tensor,
    densify_grad: torch.Tensor,
    cfg,
    *,
    refine: bool = False,
    sh_step: bool = False,
    reset: bool = False,
    draws: dict[str, torch.Tensor] | None = None,
) -> tuple[SplatData, AdamState, torch.Tensor, torch.Tensor]:
    """SH schedule + grow, prune and reset (default_strategy.cpp:292-326).
    Returns (splats, adam, densify_count, densify_grad), the statistics
    zeroed after each refine. `draws` (keys "split_a", "split_b") replaces
    the generator's draws."""
    if sh_step:
        splats.increment_sh_degree()
    if refine:
        if draws is None:
            draws = draw(generator, splats.capacity, True)
        splats, adam = grow_gs(draws, splats, adam, densify_count, densify_grad, cfg)
        splats, adam = prune_gs(iteration, splats, adam, cfg)
        densify_count = torch.zeros_like(densify_count)
        densify_grad = torch.zeros_like(densify_grad)
    if reset:
        splats, adam = reset_opacity(splats, adam, cfg)
    return splats, adam, densify_count, densify_grad
