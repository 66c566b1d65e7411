"""The work counts on a tiny scene, against a walk written pixel by pixel
and instance by instance; and the least time's arithmetic."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from port_bench.reference import raster
from port_bench.scene import garden
from port_bench.work import counts


def tiny_scene(seed: int, n: int = 300):
    scene = {"gaussians": n, "sh_degree": 3, "log_scale_spread": 0.5, "opacity_logit_mean": 1.0,
             "opacity_logit_std": 1.5, "sh0_std": 1.0, "shN_std": 0.1,
             "groups": [{"name": "ball", "share": 1.0, "kind": "ball", "center": [0.0, 0.0, 0.0],
                         "radius": 1.0, "log_scale": -2.5}]}
    params = garden.make_splats(scene, seed, "cpu")
    r, t = garden.look_at(np.array([0.0, -3.5, 0.5]), np.zeros(3))
    view = raster.View(torch.tensor(r, dtype=torch.float32), torch.tensor(t, dtype=torch.float32),
                       60.0, 60.0, 40.0, 30.0, 80, 60)
    return params, view


def pixel_walk(pr, b, stop, eps):
    """The same counts, one pixel and one instance at a time."""
    out = dict(walked=0, counted=0, back=0, back_counted=0)
    ts = b.tile_size
    for tile in range(b.grid_w * b.grid_h):
        s, c = int(b.tile_start[tile]), int(b.tile_count[tile])
        gs = b.gaussian[s:s + c].tolist()
        tx, ty = tile % b.grid_w, tile // b.grid_w
        t_after = np.ones((ts * ts, c + 1))
        counted = np.zeros((ts * ts, c), bool)
        for p in range(ts * ts):
            px, py = tx * ts + p % ts + 0.5, ty * ts + p // ts + 0.5
            t, done, walked = 1.0, False, 0
            for k, g in enumerate(gs):
                if not done:
                    walked += 1
                    dx, dy = float(pr.mean2d[g, 0]) - px, float(pr.mean2d[g, 1]) - py
                    a_, b_, c_ = (float(v) for v in pr.conic[g])
                    pw = 0.5 * (a_ * dx * dx + c_ * dy * dy) + b_ * dx * dy
                    al = min(float(pr.opacity[g]) * math.exp(-max(pw, 0.0)), raster.ALPHA_MAX)
                    if pw < 0 or al < raster.ALPHA_MIN:
                        al = 0.0
                    nt = t * (1.0 - al)
                    if al > 0 and nt >= raster.T_DONE and (stop == 0 or t >= stop):
                        counted[p, k] = True
                    if nt < max(stop, raster.T_DONE):
                        done = True
                    t = nt
                t_after[p, k + 1] = t if not done or t_after[p, k] >= raster.T_DONE else t_after[p, k]
            out["walked"] += walked
        out["counted"] += int(counted.sum())
        if eps > 0 and c:
            off = s % raster.TRIM_WINDOW
            last_heavy = -1
            for w in range((off + c + raster.TRIM_WINDOW - 1) // raster.TRIM_WINDOW):
                k0 = max(w * raster.TRIM_WINDOW - off, 0)
                k1 = min((w + 1) * raster.TRIM_WINDOW - off, c)
                if (t_after[:, k0] - t_after[:, k1]).max() >= eps:
                    last_heavy = w
            kept = min(raster.TRIM_WINDOW * max(last_heavy + 1, 1) - off, c)
            for p in range(ts * ts):
                idx = np.nonzero(counted[p])[0]
                last = int(idx[-1]) if idx.size else -1
                out["back"] += min(last + 1, kept)
                out["back_counted"] += int(counted[p, :kept].sum())
    return out


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("stop,eps", [(0.0, raster.TRIM_EPS), (raster.INFERENCE_STOP, 0.0)])
def test_walk_counts_match_a_pixel_by_pixel_walk(seed, stop, eps):
    params, view = tiny_scene(seed)
    pr = raster.project(params, view, 32)
    b = raster.bin_tiles(pr, view.width, view.height, 32)
    assert b.n_instances > 100
    got = counts.walk(pr, b, stop=stop, trim_eps=eps)
    want = pixel_walk(pr, b, stop, eps)
    assert got["walked"] == want["walked"]
    assert got["counted"] == want["counted"]
    if eps > 0:
        assert got["back"] == want["back"] and got["back_counted"] == want["back_counted"]
        assert 0 < got["back_counted"] <= got["counted"]


def test_least_seconds_is_the_larger_bound():
    assert counts.least_seconds(67e12, 0) == pytest.approx(1.0)
    assert counts.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert counts.least_seconds(67e9, 3.35e12) == pytest.approx(1.0)
