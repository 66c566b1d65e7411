"""Plain PyTorch reference of one MCMC refine ("3D Gaussian Splatting as
Markov Chain Monte Carlo", Kheradmand et al. 2024, as gsplat's and
LichtFeld-Studio's MCMC strategy state it), for judging the program's
refine from the state it started from.

A refine relocates every dead gaussian (activated opacity at or below
min_opacity, or a degenerate quaternion) onto a source drawn from the
alive gaussians by opacity, grows toward `grow_factor` times the active
count (up to the cap) onto sources drawn from every active gaussian, and
then adds the step's noise to every mean. A source drawn r - 1 times
splits r ways: opacity 1 - (1 - o)^(1 / r) and scale o / D * s (eq. 9 of
the paper), written to the source and copied, with every other parameter
of the source, to its targets; relocation zeroes the sources' Adam
moments, growth keeps them.

The draws are uniforms, one a slot, and a source is where the uniform
falls in the cumulative weights. The program's choices are read from its
output (a target holds its source's parameters bit for bit) and judged
against where the uniform falls; the reference then applies the refine
with those choices and its own arithmetic (float64), so that the whole
state after the refine can be compared.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from port_bench.reference.raster import GROUPS, mcmc_noise

N_MAX = 51  # the largest split (gsplat's relocation table)
GROW_FACTOR = 1.05


def draws(gen: torch.Generator, capacity: int, refine: bool, device) -> dict:
    """A step's draws in the strategy's order: on a refine step the
    relocation and growth uniforms, then the noise."""
    out = {}
    if refine:
        out["relocate"] = torch.rand(capacity, generator=gen, device=device)
        out["add"] = torch.rand(capacity, generator=gen, device=device)
    out["noise"] = torch.randn((capacity, 3), generator=gen, device=device)
    return out


def split(opacity: torch.Tensor, scale: torch.Tensor, ratio: torch.Tensor):
    """(opacity, scale) of a gaussian split `ratio` ways (float64):
    o' = 1 - (1 - o)^(1/r), s' = o / D s with
    D = sum_{i=1..r} sum_{k<i} C(i-1, k) (-1)^k o'^(k+1) / sqrt(k+1)."""
    r = torch.clamp(ratio, 1, N_MAX).to(torch.float64)
    o = opacity.to(torch.float64)
    new_o = 1.0 - torch.pow(torch.clamp(1.0 - o, min=1e-12), 1.0 / r)
    denom = torch.zeros_like(o)
    for i in range(1, int(r.max()) + 1 if r.numel() else 1):
        inner = torch.zeros_like(o)
        for k in range(i):
            inner = inner + (math.comb(i - 1, k) * (-1.0) ** k / math.sqrt(k + 1.0)
                             * new_o ** (k + 1))
        denom = denom + torch.where(r >= i, inner, 0.0)
    return new_o, (o / denom)[:, None] * scale.to(torch.float64)


def _rows(p: dict) -> torch.Tensor:
    """What a split leaves alone and a copy carries over: rotation and SH,
    as one row a gaussian (float32)."""
    n = p["rotation"].shape[0]
    return torch.cat([p[k].reshape(n, -1) for k in ("rotation", "sh0", "shN")], 1)


def draw_sources(u: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The slot where each uniform falls in the cumulative weights."""
    cdf = torch.cumsum(weights.to(torch.float64), 0)
    idx = torch.searchsorted(cdf, u.to(torch.float64) * cdf[-1], right=True)
    return torch.clamp(idx, max=weights.shape[0] - 1)


def _spans(weights: torch.Tensor):
    cdf = torch.cumsum(weights.to(torch.float64), 0)
    return cdf - weights.to(torch.float64), cdf, cdf[-1]


def read_sources(after: dict, targets: torch.Tensor, candidates: torch.Tensor, u: torch.Tensor,
                 weights: torch.Tensor):
    """For each target slot, the candidate slot whose rotation and SH it
    holds bit for bit after the refine (of several alike, the one nearest
    where the target's uniform falls), and that uniform's distance from
    the source's span of cumulative weight, as a share of the total (0
    inside it; 1 where no candidate matches)."""
    rows = _rows(after).contiguous()
    # an exact hash of each row's bits (integer sums do not depend on order)
    mult = torch.randint(1, 1 << 20, (rows.shape[1],), generator=torch.Generator().manual_seed(1))
    h = (rows.view(torch.int32).to(torch.int64) * mult.to(rows.device)).sum(1)
    cand = candidates.nonzero()[:, 0]
    near = cand[torch.isin(h[cand], h[targets])]
    lo, hi, total = _spans(weights)
    x = u.to(torch.float64) * total
    src = torch.full_like(targets, -1)
    gap = torch.ones(targets.shape[0], dtype=torch.float64, device=targets.device)
    for j, t in enumerate(targets.tolist()):
        same = near[(rows[near] == rows[t]).all(1)]
        if same.numel():
            d = torch.clamp(torch.maximum(lo[same] - x[j], x[j] - hi[same]), min=0.0) / total
            k = int(torch.argmin(d))
            src[j], gap[j] = same[k], d[k]
    return src, gap


def _relocate(p: dict, m: dict, v: dict, targets: torch.Tensor, src: torch.Tensor,
              min_opacity: float, zero_source_moments: bool, split_sources: bool = True):
    """Split each source 1 + (its draws) ways and copy it to its targets."""
    ok = src >= 0
    targets, src = targets[ok], src[ok]
    if not targets.numel():
        return p, m, v
    n = p["opacity"].shape[0]
    sources, count = torch.unique(src, return_counts=True)
    o = torch.sigmoid(p["opacity"][sources, 0].to(torch.float64))
    new_o, new_s = split(o, torch.exp(p["scaling"][sources].to(torch.float64)), 1 + count)
    new_o = torch.clamp(new_o, min_opacity, 1.0 - 1e-7)
    p = {k: t.clone() for k, t in p.items()}
    if split_sources:
        p["opacity"][sources, 0] = (torch.log(new_o) - torch.log1p(-new_o)).to(torch.float32)
        p["scaling"][sources] = torch.log(torch.clamp(new_s, min=1e-20)).to(torch.float32)
    for k in GROUPS:
        p[k][targets] = p[k][src]
    if zero_source_moments:
        keep = torch.ones(n, dtype=torch.float32, device=sources.device)
        keep[sources] = 0.0
        m = {k: t * keep.reshape((n,) + (1,) * (t.ndim - 1)) for k, t in m.items()}
        v = {k: t * keep.reshape((n,) + (1,) * (t.ndim - 1)) for k, t in v.items()}
    return p, m, v


def apply(before: dict, dr: dict, lr_means: float, cfg: dict, choose, *,
          relocate: bool = True, zero_moments: bool = True, split_sources: bool = True):
    """The refine and the step's noise from the state `before` ({"params",
    "exp_avg", "exp_avg_sq", "n_active"}) with the step's draws `dr`; each
    round's sources come from choose(targets, uniforms, weights,
    candidates) -> (sources, pick gaps). Returns (the state after, every
    pick gap)."""
    p, m, v = before["params"], before["exp_avg"], before["exp_avg_sq"]
    n_cap = p["opacity"].shape[0]
    dev = p["opacity"].device
    n = int(before["n_active"])
    active = torch.arange(n_cap, device=dev) < n
    op = torch.sigmoid(p["opacity"][:, 0])
    dead = active & ((op <= cfg["min_opacity"]) | ((p["rotation"] ** 2).sum(-1) < 1e-8))
    alive = active & ~dead
    targets = (dead & alive.any()).nonzero()[:, 0]
    src, gap = choose(targets, dr["relocate"][targets], torch.where(alive, op, 0.0), alive)
    gaps = [gap]
    if relocate:
        p, m, v = _relocate(p, m, v, targets, src, cfg["min_opacity"], zero_moments,
                            split_sources)
    n_new = min(int(np.float32(GROW_FACTOR) * np.float32(n)), n_cap)
    grow = torch.arange(n, n_new, device=dev)
    if grow.numel():
        w = torch.where(active, torch.sigmoid(p["opacity"][:, 0]), 0.0)
        g_src, g_gap = choose(grow, dr["add"][grow], w, active)
        gaps.append(g_gap)
        p, m, v = _relocate(p, m, v, grow, g_src, cfg["min_opacity"], False, split_sources)
    active = torch.arange(n_cap, device=dev) < n_new
    moved = mcmc_noise(p, dr["noise"], torch.tensor(lr_means, dtype=torch.float32, device=dev))
    p = dict(p, means=torch.where(active[:, None], moved, p["means"]))
    return {"params": p, "exp_avg": m, "exp_avg_sq": v, "n_active": n_new}, gaps


def judge(before: dict, after: dict, dr: dict, lr_means: float, cfg: dict):
    """The program's refine, from the state `before` it to the state
    `after` it: (the largest pick gap, 1 where the active count differs;
    the reference's state after the refine with the program's sources)."""

    def read(targets, u, weights, candidates):
        return read_sources(after["params"], targets, candidates, u, weights)

    ref, gaps = apply(before, dr, lr_means, cfg, read)
    gap = max((float(g.max()) for g in gaps if g.numel()), default=0.0)
    return (1.0 if int(after["n_active"]) != ref["n_active"] else gap), ref


def planted(before: dict, dr: dict, lr_means: float, cfg: dict, fault: str | None) -> dict:
    """The state a refine leaves when the reference, put in the program's
    place, draws its own sources, with `fault` planted: "skip" (nothing
    relocated), "uniform" (sources drawn with equal weights), "moments"
    (the sources' moments kept), "nosplit" (sources copied unsplit); None
    plants nothing."""

    def draw(targets, u, weights, candidates):
        w = candidates.to(torch.float32) if fault == "uniform" else weights
        return draw_sources(u, w), torch.zeros(targets.shape[0], dtype=torch.float64)

    out, _ = apply(before, dr, lr_means, cfg, draw, relocate=fault != "skip",
                   zero_moments=fault != "moments", split_sources=fault != "nosplit")
    return out


def leaf_diff(prog: dict, ref: dict, base: dict | None) -> float:
    """Worst leaf's ||prog - ref|| over the larger of ||ref - base|| (the
    change the refine made; ||ref|| where `base` is None) and the median
    leaf's."""
    scale = {k: float(torch.linalg.norm((ref[k] - base[k] if base else ref[k]).double()))
             for k in ref}
    med = float(np.median(list(scale.values())))
    return max(float(torch.linalg.norm((prog[k].to(ref[k].device) - ref[k]).double()))
               / max(scale[k], med, 1e-30) for k in ref)
