"""A cell at a size the CPU runs in seconds: the garden configuration with
few small views and gaussians, for the harness's own tests."""

from __future__ import annotations

import copy
import json
from pathlib import Path

from port_bench.harness import HERE, Context


def tiny_config(gaussians: int = 3000, config: str = "garden4-mcmc", fisheye: bool = False) -> dict:
    """`fisheye` sees the scene through an OPENCV_FISHEYE test lens and
    trains it with --gut-exact (the reference's UT and world-space blend)."""
    cfg = copy.deepcopy(json.loads((HERE / "configs" / f"{config}.json").read_text()))
    cfg["name"] = "tiny"
    cfg["dataset"].update(views=6, width=96, height=64, fx=90.0, fy=90.0, sfm_points=100)
    if fisheye:
        cfg["dataset"].update(camera_model="OPENCV_FISHEYE", radial=[0.08, -0.01, 0.0, 0.0])
        cfg["train"]["gut_exact"] = True
    cfg["scene"]["gaussians"] = gaussians
    cfg["train"]["max_cap"] = gaussians
    cfg["scene"]["opacity_logit_std"] = 3.0  # some gaussians dead at the refine
    for g in cfg["scene"]["groups"]:
        g["log_scale"] += 2.0
    return cfg


def tiny_context(traffic: str, cache: Path, seed: int = 5, seconds: float = 0.5) -> Context:
    tr = json.loads((HERE / "traffic" / f"{traffic}.json").read_text())
    tr["params"].update(trace_iterations=4, trace_frames=4)
    if traffic == "view":
        tr["params"].update(width=96, height=64, fx=80.0)
    limits = json.loads((HERE / "limits" / f"garden4-mcmc.{traffic}.json").read_text())
    return Context(cell={"name": f"tiny.{traffic}", "chips": 1}, config=tiny_config(),
                   traffic=tr, limits=limits, seed=seed, seconds=seconds, trace=False,
                   device="cpu", cache=cache)
