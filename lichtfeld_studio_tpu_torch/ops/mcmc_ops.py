"""MCMC densification ops: relocation (Eq. 9 of "3DGS as MCMC") and
opacity-gated noise (counterpart of lichtfeld_studio_tpu/ops/mcmc_ops.py;
reference gsplat/RelocationCUDA.cu:12-111 and :113-180).

Relocation is the JAX package's [N, 51] term table contracted with the
binomial matrix, a float32 matmul (TF32 is off, ops/rasterize.py), then a
cumulative sum and a gather at `ratio`. The noise takes its standard-normal
draws as a tensor, so a caller (or a test) chooses the random stream."""

from __future__ import annotations

from math import comb

import torch

from lichtfeld_studio_tpu_torch.ops.gaussians import quat_to_rotmat

N_MAX = 51  # binomial table size (reference mcmc.cpp:459-472)

torch.backends.cuda.matmul.allow_tf32 = False  # relocation's contraction stays float32


def make_binoms(n_max: int = N_MAX, device: str | torch.device = "cpu") -> torch.Tensor:
    """[n_max, n_max] float32 table of C(n, k)."""
    b = [[float(comb(n, k)) if k <= n else 0.0 for k in range(n_max)] for n in range(n_max)]
    return torch.tensor(b, dtype=torch.float32, device=device)


def relocation(
    opacities: torch.Tensor,  # [N] activated opacity
    scales: torch.Tensor,  # [N, 3] activated (exp) scales
    ratios: torch.Tensor,  # [N] int split counts, clipped to [1, n_max]
    binoms: torch.Tensor,  # [n_max, n_max]
) -> tuple[torch.Tensor, torch.Tensor]:
    """New (opacity, scale) when a gaussian is split into `ratio` copies:
    new_op = 1 - (1 - op)^(1/ratio); new_scale = op / denom * scale with
    denom = sum_{i=1..ratio} sum_{k<i} C(i-1,k) (-1)^k / sqrt(k+1)
    new_op^(k+1) (RelocationCUDA.cu:27-42)."""
    n_max = binoms.shape[0]
    ratios = torch.clamp(ratios, 1, n_max).long()
    r = ratios.to(torch.float32)
    new_op = 1.0 - torch.pow(torch.clamp(1.0 - opacities, 1e-12, 1.0), 1.0 / r)
    k = torch.arange(n_max, dtype=torch.float32, device=opacities.device)
    sign = 1.0 - 2.0 * (torch.arange(n_max, device=opacities.device) % 2).to(torch.float32)
    terms = sign / torch.sqrt(k + 1.0) * torch.pow(new_op[:, None], k[None, :] + 1.0)
    inner = terms @ binoms.T  # [N, n_max]: column i-1 holds inner_i
    denom_cum = torch.cumsum(inner, dim=1)
    denom = torch.gather(denom_cum, 1, (ratios - 1)[:, None])[:, 0]
    coeff = opacities / torch.where(denom.abs() > 1e-12, denom, 1e-12)
    return new_op, coeff[:, None] * scales


def add_noise(
    logit_opacities: torch.Tensor,  # [C] or [C, 1]
    log_scales: torch.Tensor,  # [C, 3]
    quats: torch.Tensor,  # [C, 4]
    means: torch.Tensor,  # [C, 3]
    active: torch.Tensor,  # [C] bool
    noise: torch.Tensor,  # [C, 3] standard-normal draws
    current_lr: torch.Tensor,  # scheduler lr * noise_lr (5e5), mcmc.cpp:349-367
) -> torch.Tensor:
    """Updated means with covariance-shaped, opacity-gated noise
    (RelocationCUDA.cu add_noise_kernel:113-145):
    means += lr sigmoid(-100 (sigmoid(op) - 0.005)) (R S^2 R^T) noise."""
    if logit_opacities.ndim == 2:
        logit_opacities = logit_opacities[:, 0]
    rot = quat_to_rotmat(quats)
    var = torch.exp(2.0 * log_scales)
    # cov @ n = R @ (var * (R^T @ n)): two matvecs, no [C, 3, 3] covariance
    t = (rot * noise[:, :, None]).sum(1)
    transformed = (rot * (var * t)[:, None, :]).sum(2)
    gate = torch.sigmoid(-(100.0 * torch.sigmoid(logit_opacities) - 0.5))
    factor = current_lr * gate
    # a select, not a multiply by zero: inactive slots stay as they are even
    # where their parameters make `transformed` non-finite
    return torch.where(active[:, None], means + factor[:, None] * transformed, means)
