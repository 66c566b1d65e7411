"""The per-stage attribution of a profiled train step
(profiling.stage_times), on the CPU: every stage range of the step and the
backward of the projection and of the loss receive time, the stages add up
to all of the step's host time, and the backward of the blend counts
toward P2 and no backward toward the binning, which has no gradient."""

import pytest
import torch

from lichtfeld_studio_tpu_torch.bench_train import bench_setup
from lichtfeld_studio_tpu_torch.profiling import device_summary, stage_times
from lichtfeld_studio_tpu_torch.train.state import StepFlags, init_train_state, train_step

STAGES = ("projection", "binning", "P2", "composite", "loss", "P3", "P4", "MCMC", "Adam",
          "projection bwd", "loss bwd")


@pytest.fixture(scope="module")
def profiled_step():
    splats, cam, gt, bg, cfg, lrs = bench_setup("cpu", n0=300, cap=400, width=96, height=64,
                                                instance_cap=8192)
    state = init_train_state(splats, lrs)
    train_step(state, cam, gt, bg, cfg, StepFlags())  # warm-up
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        train_step(state, cam, gt, bg, cfg, StepFlags(refine=True))
    return prof


def test_every_stage_of_the_step_gets_time(profiled_step):
    events = profiled_step.events()
    times = stage_times(events, lambda e: e.self_cpu_time_total)
    missing = [s for s in STAGES if not times.get(s, 0.0) > 0.0]
    assert not missing, (missing, times)
    assert sum(times.values()) == pytest.approx(sum(e.self_cpu_time_total for e in events))
    assert times["P2 bwd"] > 0.0 and "binning bwd" not in times, times
    # the blend's backward is P3 and P4, not the forward's stage
    assert times["P3"] > times["P2 bwd"]


def test_device_summary_without_device_events(profiled_step):
    assert device_summary(profiled_step) is None
