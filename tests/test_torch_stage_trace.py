"""The per-stage attribution of a profiled train step
(profiling.stage_times), on the CPU: every stage range of the step and the
backward of the projection and of the loss receive time, the stages add up
to all of the step's host time, and the backward of the blend counts
toward P2 and no backward toward the binning, which has no gradient."""

import pytest
import torch

from lichtfeld_studio_tpu_torch.profiling import (
    device_summary,
    device_trace,
    lost_device_events,
    stage,
    stage_times,
)
from lichtfeld_studio_tpu_torch.tools.scenes import train_scene
from lichtfeld_studio_tpu_torch.train.state import StepFlags, init_train_state, train_step

STAGES = ("projection", "binning", "P2", "composite", "loss", "P3", "P4", "MCMC", "Adam",
          "projection bwd", "loss bwd")


@pytest.fixture(scope="module")
def profiled_step():
    splats, cam, gt, bg, cfg, lrs = train_scene("cpu", n0=300, cap=400, width=96, height=64,
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


def test_device_trace_keeps_the_body_alone():
    """device_trace turns tracing on a cycle early, on a lead-in it does not
    keep: the body's ops and stage are in the trace, the lead-in's are
    not."""
    with device_trace("cpu") as prof:
        with stage("body"):
            torch.ones(5).mul_(3.0)
    names = {e.name for e in prof.events()}
    assert {"lfs.body", "aten::ones", "aten::mul_"} <= names and "aten::add_" not in names, names
    assert "body" in stage_times(prof.events(), lambda e: e.self_cpu_time_total)


def test_lost_device_events_of_a_host_trace(profiled_step):
    lost = lost_device_events(profiled_step)
    assert (lost["launches"], lost["missing"], lost["ops"]) == (0, 0, [])
    assert lost["lead_us"] != lost["lead_us"]  # nan: no op launched on a device
