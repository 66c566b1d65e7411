"""The port's host spans (profiling.record_spans) and the benchmark's
reduction of them (port_bench/spans.py, the span readers), on the CPU:
what `stage()` is with recording off, nesting, parents, units and threads,
the spans against the profiler's own ranges, the trainer's loop recorded
end to end with a profiler started in its control poll, the stage
attribution a dispatch keeps under the new ranges, and the reduction's
totals, self times, host-device offset, idle split and readers on
hand-made records."""

from __future__ import annotations

import threading
import time
from types import SimpleNamespace

import pytest
import torch

from lichtfeld_studio_tpu_torch import profiling
from lichtfeld_studio_tpu_torch.profiling import record_spans, stage
from port_bench import spans as red
from port_bench.harness import HERE

CPU = torch.profiler.ProfilerActivity.CPU


def test_stage_with_recording_off_is_the_plain_range_and_records_nothing():
    with record_spans() as rec:
        pass
    assert profiling._record is None
    r = stage("x")
    assert type(r) is torch._C._profiler._RecordFunctionFast
    with stage("x", 3):
        pass
    assert rec.spans == [] and profiling._record is None
    with record_spans():
        with pytest.raises(RuntimeError, match="already recording"):
            with record_spans():
                pass


def test_spans_nest_with_parents_units_and_threads():
    seen = {}

    def other(key):
        seen[key] = threading.get_ident()
        with stage("c"):
            with stage("c2"):
                pass

    with record_spans() as rec:
        with stage("a", 7):
            with stage("b"):
                t = threading.Thread(target=other, args=("in_b",))
                t.start()
                t.join(timeout=30)
        with stage("d"):
            with stage("e"):
                pass
        t = threading.Thread(target=other, args=("alone",))
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    names = [s.name for s in rec.spans]
    assert names == ["a", "b", "c", "c2", "d", "e", "c", "c2"]
    main = threading.get_ident()
    a, b, c, c2, d, e, c_, c2_ = rec.spans
    assert (a.parent, b.parent, c.parent, c2.parent) == (-1, 0, 1, 2)
    assert (d.parent, e.parent, c_.parent, c2_.parent) == (-1, 4, -1, 6)
    # units: given, inherited, or a span's own index where it has neither
    assert [s.unit for s in rec.spans] == [7, 7, 7, 7, 4, 4, 6, 6]
    assert rec.thread == main and [s.thread for s in rec.spans] == [
        main, main, seen["in_b"], seen["in_b"], main, main, seen["alone"], seen["alone"]]
    assert rec.start <= a.start <= b.start <= c.start <= c.end <= b.end <= a.end <= d.start
    assert e.end <= d.end <= c_.start and c2_.end <= rec.end


def test_spans_line_up_with_the_profilers_ranges():
    """Each span's start and end on the profiler's clock lie within 200 us
    of its "lfs.<name>" range in a CPU trace."""
    with torch.profiler.profile(activities=[CPU]) as prof:
        with record_spans() as rec:
            for k in range(3):
                with stage("outer", k):
                    time.sleep(0.002)
                    with stage("inner"):
                        torch.ones(64).mul_(2.0)
                        time.sleep(0.001)
    ranges = sorted((e.start_ns(), e.end_ns(), e.name())
                    for e in prof.profiler.kineto_results.events() if e.name().startswith("lfs."))
    mine = sorted((s.start, s.end, "lfs." + s.name) for s in rec.spans)
    assert [r[2] for r in ranges] == [m[2] for m in mine] and len(mine) == 6
    for (s0, e0, _), (s1, e1, _) in zip(ranges, mine):
        assert abs(s1 - s0) < 200_000 and abs(e1 - e0) < 200_000, (s0, s1, e0, e1)


@pytest.fixture(scope="module")
def trainer(tmp_path_factory):
    """The benchmark's garden cell at a size the CPU trains in a second a
    dispatch: 400 gaussians, six 96x64 views, from iteration 1000 (from
    there on a plain step's flags are the default ones, so the trainer
    runs dispatches of dispatch_steps)."""
    from lichtfeld_studio_tpu_torch.cli import parse_args_and_params
    from lichtfeld_studio_tpu_torch.train.trainer import Trainer
    from port_bench.drivers.train import cli_argv
    from port_bench.scene import garden
    from port_bench.tests.tiny import tiny_config

    root = tmp_path_factory.mktemp("host_spans")
    cfg = tiny_config(gaussians=400)
    data = garden.build(root / "data", cfg, 5, "cpu")
    argv = cli_argv(cfg, data, root / "out", ("--instance-cap", "16384", "--num-workers", "1"))
    trainer = Trainer.setup(parse_args_and_params(argv), "cpu")
    trainer.state.iteration = 1000
    return trainer


class _RecordingControl:
    """A live control as the benchmark's window is: at its first poll it
    turns recording on and starts a profiler, at its third it stops both
    and the run."""

    paused = False

    def __init__(self):
        self.stop_requested, self.polls = False, 0
        self.rec = self.prof = None

    def run_pending(self, trainer):
        if not trainer.training_active or self.stop_requested:
            return
        self.polls += 1
        if self.polls == 1:
            self._rec = record_spans()
            self.rec = self._rec.__enter__()
            self.prof = torch.profiler.profile(activities=[CPU])
            self.prof.__enter__()
        elif self.polls == 3:
            self.prof.__exit__(None, None, None)
            self._rec.__exit__(None, None, None)
            self.stop_requested = True

    def consume_save_request(self):
        return False


def test_the_trainer_loop_records_its_spans(trainer):
    trainer.control = control = _RecordingControl()
    it0 = trainer.state.iteration
    try:
        trainer.train()
    finally:
        trainer.control = None
    spans = control.rec.spans
    k = trainer.params.optimization.dispatch_steps
    steps = [s for s in spans if s.name == "step"]
    assert k > 1 and [s.unit for s in steps] == list(range(it0 + k + 1, it0 + 3 * k + 1))
    by = {i: s for i, s in enumerate(spans)}
    for s in spans:
        parent = by[s.parent].name if s.parent >= 0 else None
        assert parent == {"dispatch": None, "readback": None, "step": "dispatch",
                          "loader_wait": "step", "h2d": "step",
                          "backward": "step"}.get(s.name, parent), (s, parent)
    assert {"dispatch", "step", "loader_wait", "h2d", "backward", "readback", "projection",
            "binning", "P2", "loss", "P3", "P4", "MCMC", "Adam"} <= {s.name for s in spans}
    assert [s.unit for s in spans if s.name == "dispatch"] == [it0 + k + 1, it0 + 2 * k + 1]
    assert all(s.unit == by[s.parent].unit for s in spans if s.parent >= 0 and s.name != "step")
    # the profiler started in the control poll names the same ranges
    names = {e.name for e in control.prof.events()}
    assert {"lfs.dispatch", "lfs.step", "lfs.readback", "lfs.backward"} <= names

    r = red.reduce({"start": control.rec.start, "end": control.rec.end,
                    "thread": control.rec.thread, "spans": [list(s) for s in spans]}, "step")
    assert r["units"] == 2 * k
    host = r["host_ms"]
    assert 0 < host["dispatch"] + host["readback"] <= 1e3 * r["wall_s"] / r["units"]


def test_a_dispatch_keeps_every_stage_where_it_was(trainer):
    """The new ranges around a dispatch take device time only from
    "other": every event port_bench/trace.py::stage_device_us put under a
    stage keeps that stage. Each host event stands in for a kernel of its
    own weight; autograd's nodes get a thread of their own, as on the
    card (on the CPU autograd runs them on the calling thread, inside
    `step` and `backward`)."""
    from lichtfeld_studio_tpu_torch.train.state import step_flags

    trainer.start_loader()
    try:
        flags = step_flags(trainer.cfg, trainer.state.iteration + 1)
        with torch.profiler.profile(activities=[CPU]) as prof:
            trainer.run_dispatch(2, flags, torch.zeros(3))
    finally:
        trainer.stop_loader()
    cpu = list(prof.events())
    weight = {id(e): float(i + 1) for i, e in enumerate(cpu)}
    moved = red.moved_stages(cpu, kernels=lambda e: [SimpleNamespace(duration=weight[id(e)])],
                             own_thread_backward=True)
    assert moved["changed"] == {}
    assert {"projection", "binning", "P2", "loss", "P3", "P4", "MCMC", "Adam",
            "projection bwd", "loss bwd"} <= set(moved["without"])
    assert {"dispatch", "step", "loader_wait", "h2d", "backward"} <= set(moved["with"])
    assert moved["with"]["other"] < moved["without"]["other"]
    assert sum(moved["with"].values()) == sum(moved["without"].values())


def _record(spans, start=0, end=100, thread=1):
    return {"start": start, "end": end, "thread": thread, "spans": [list(s) for s in spans]}


# two units: `step` spans under `loop` spans, with a child on another thread
HAND = [
    ("loop", 0, 50, 1, -1, 1),      # 0
    ("dispatch", 2, 40, 1, 0, 1),   # 1
    ("step", 2, 40, 1, 1, 1),       # 2
    ("loader_wait", 2, 6, 1, 2, 1),  # 3
    ("backward", 10, 30, 1, 2, 1),  # 4
    ("P3", 12, 20, 2, 4, 1),        # 5: autograd's thread
    ("P3", 14, 16, 2, 5, 1),        # 6: nested under a span of its own name
    ("readback", 40, 48, 1, 0, 1),  # 7
    ("loop", 55, 95, 1, -1, 2),     # 8
    ("dispatch", 55, 90, 1, 8, 2),  # 9
    ("step", 55, 90, 1, 9, 2),      # 10
]


def test_reduce_totals_and_self_times():
    r = red.reduce(_record(HAND), "step")
    assert r["units"] == 2 and r["wall_s"] == pytest.approx(100e-9)
    ms = 1e-6 / 2
    assert r["host_ms"] == pytest.approx({k: v * ms for k, v in {
        "loop": 90, "dispatch": 73, "step": 73, "loader_wait": 4, "backward": 20, "P3": 8,
        "readback": 8}.items()})
    assert r["self_ms"] == pytest.approx({k: v * ms for k, v in {
        "loop": 50 - 38 - 8 + 40 - 35, "dispatch": 0, "step": 38 - 4 - 20 + 35,
        "loader_wait": 4, "backward": 20 - 8, "P3": 8 - 2 + 2, "readback": 8}.items()})
    assert "idle_ms" not in r
    assert red.reduce(_record(HAND), "frame") is None


def test_reduce_splits_the_device_idle_by_the_innermost_span():
    """The device runs over [3, 12] and [20, 60], so [0, 3), (12, 20) and
    (60, 100] are idle: [0, 2) in loop's self time, [2, 3) in loader_wait,
    (12, 20) in backward (autograd's thread's P3 never counts), (60, 90)
    in the second step, (90, 95) in the second loop, (95, 100] in none."""
    busy = [(3, 8), (6, 12), (20, 60)]
    r = red.reduce(_record(HAND), "step", busy, None)
    ms = 1e-6 / 2
    expect = {"loop": 2 + 5, "loader_wait": 1, "backward": 8, "step": 30, "none": 5}
    assert r["idle_self_ms"] == pytest.approx({k: v * ms for k, v in expect.items()})
    assert r["idle_total_ms"] == pytest.approx((3 + 8 + 40) * ms)
    assert r["busy_ms"] == pytest.approx((100 - 3 - 8 - 40) * ms)
    assert r["idle_ms"] == pytest.approx({k: v * ms for k, v in {
        "loop": 2 + 1 + 8 + 30 + 5, "dispatch": 1 + 8 + 30, "step": 1 + 8 + 30,
        "loader_wait": 1, "backward": 8, "none": 5}.items()})


class _Event:
    def __init__(self, kind, name, corr, start, end=None):
        self.kind, self._name, self.corr, self.s, self.e = kind, name, corr, start, end or start

    def device_type(self):
        return self.kind

    def name(self):
        return self._name

    def correlation_id(self):
        return self.corr

    def start_ns(self):
        return self.s

    def end_ns(self):
        return self.e


def _profile(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def test_device_events_are_moved_by_the_least_lead_of_a_launch():
    """The device's clock reads 7 ns behind the host's here: the least
    (device start - launch call) is -7, and every device event moves 7 ns
    later; a trace without launch calls is left as it is."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = [_Event(cpu, "cudaLaunchKernel", 1, 10), _Event(cuda, "k1", 1, 3, 9),
              _Event(cpu, "cudaMemcpyAsync", 2, 20), _Event(cuda, "Memcpy HtoD", 2, 15, 30),
              _Event(cuda, "ProfilerStep#1", 3, 0, 100), _Event(cpu, "aten::add", 4, 1, 2)]
    intervals, leads = red.device_intervals(_profile(events))
    assert intervals == [(10, 16), (22, 37)]
    assert leads == {"windows_ns": [-7], "step_ns": 0, "offset_ns": -7, "least_ns": -7,
                     "least_event": "k1", "median_ns": -5, "negative": 2, "leads": 2}
    intervals, leads = red.device_intervals(_profile([e for e in events if e.kind == cuda]))
    assert leads is None and intervals == [(3, 9), (15, 30)]
    r = red.reduce(_record(HAND), "step", intervals, leads)
    assert r["leads"] is None and "refused" not in r


@pytest.mark.parametrize("case", ["steady", "mismatched", "moved", "drifting"])
def test_the_offset_is_a_low_lead_and_a_moving_clock_is_refused(case):
    """2000 launches, two windows of offsets, whose device events start 5
    ns after them on a device clock 1000 ns behind the host's. One launch
    matched to a far earlier device event ("mismatched") does not set the
    offset, though it is the least lead; a clock that steps by more than
    DRIFT_NS halfway through ("moved") leaves the idle unsplit, and its
    readers read None; one that drifts by 40 us over the trace
    ("drifting") is corrected window by window, to within a window's
    drift."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = []
    for i in range(2000):
        t = 10_000 * (i + 1)
        shift = -1000 - (red.DRIFT_NS + 1 if case == "moved" and i >= 1000 else 0)
        shift -= 20 * i if case == "drifting" else 0
        lead = -9_000 if case == "mismatched" and i == 700 else shift + 5
        events += [_Event(cpu, "cudaLaunchKernel", i, t), _Event(cuda, f"k{i}", i, t + lead,
                                                                 t + lead + 2_000)]
    intervals, leads = red.device_intervals(_profile(events))
    assert leads["leads"] == 2000 and leads["negative"] == 2000
    if case == "moved":
        assert leads["windows_ns"] == [-995, -995 - red.DRIFT_NS - 1]
    elif case == "drifting":
        assert leads["step_ns"] == 20_000 and leads["offset_ns"] == -40_935
        assert max(abs(s - 10_000 * (i + 1)) for i, (s, _) in enumerate(intervals)) <= 20_000
    else:
        assert leads["windows_ns"] == [-995, -995] and intervals[0] == (10_000, 12_000)
        assert leads["least_ns"] == (-9_000 if case == "mismatched" else -995)
        assert leads["least_event"] == ("k700" if case == "mismatched" else "k0")
    spans = [("step", 10_000 * i, 10_000 * (i + 1), 1, -1, i) for i in range(1, 2001)]
    r = red.reduce(_record(spans, 0, 20_010_000), "step", intervals, leads)
    assert ("refused" in r) == (case == "moved") and ("idle_ms" in r) == (case != "moved")
    host = {"units": 2000, "wall_s": 0.02001, "host_ms": {}, "self_ms": {}}
    assert (red.idle_ms({"spans": {"host": host, "idle": r}}, "step") is None) == (case == "moved")


# the spans stretch: 40 ms a unit; the attribution stretch: 46 ms a unit,
# 34 busy and 12 idle, so its shares of idle divide 40 - 34 = 6 ms
READINGS = {"spans": {
    "host": {"units": 4, "wall_s": 0.16,
             "host_ms": {"dispatch": 34.0, "step": 34.0, "loader_wait": 0.5, "h2d": 0.25,
                         "readback": 3.0, "frame": 9.5},
             "self_ms": {"dispatch": 0.0}},
    "idle": {"units": 4, "wall_s": 0.184, "busy_ms": 34.0, "idle_total_ms": 12.0,
             "idle_ms": {"dispatch": 9.0, "loader_wait": 1.0, "h2d": 0.5, "frame": 2.5,
                         "none": 1.0},
             "idle_self_ms": {}}}}


@pytest.mark.parametrize("metric, value", [
    ("feed_ms.train", 0.75), ("enqueue_ms.train", 33.25), ("readback_wait_ms.train", 3.0),
    ("loop_ms.train", 3.0), ("idle_enqueue_ms.train", 7.5 / 2),
    ("idle_outside_enqueue_ms.train", 4.5 / 2), ("frame_enqueue_ms.view", 9.5),
    ("idle_enqueue_ms.view", 2.5 / 2),
])
def test_each_span_reader_reads_its_stretch(metric, value):
    from port_bench.run import load_json, load_module

    entries = {m["name"]: m for m in load_json(HERE / "host_spans.json")["per_layer"]}
    path = HERE / "metrics" / f"{metric}.py"
    assert metric in entries and path.exists()
    read = load_module(path, "span_reader_" + metric.replace(".", "_")).read
    assert read(READINGS) == pytest.approx(value)
    stretch = "idle" if entries[metric]["source"] == "device_trace" else "host"
    assert read({}) is None and read({"trace": {}}) is None
    assert read({"spans": {k: v for k, v in READINGS["spans"].items() if k != stretch}}) is None
