"""The port's live training server: the reference's cases of
tests/test_live_server.py on the port (control flags and events, the HTTP
surface, a real Trainer paused, saved and stopped through it), where a
render runs while a run is active (on the trainer's thread, between
dispatches), a render error as 500 with its message, and the viewer
re-binning after the trainer writes the model in place."""

import io
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from lichtfeld_studio_tpu_torch.core.events import (
    PauseTraining,
    StopTraining,
    TrainingPaused,
    TrainingStopped,
    bus,
)
from lichtfeld_studio_tpu_torch.render import live_server
from lichtfeld_studio_tpu_torch.render.live_server import LiveTrainingServer, TrainingControl
from tests.scene_utils import make_random_splats
from tests.torch_parity import to_torch_splats


def _get(port, path, timeout=60):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
            return r.status, r.read(), r.headers.get("Content-Type", "")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type", "")


def _post(port, path):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method="POST", data=b"")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


class _FakeState:
    def __init__(self, splats):
        self.splats = splats


class _FakeTrainer:
    def __init__(self, splats):
        self.state = _FakeState(splats)
        self.last_progress = (123, 0.25, int(splats.n_active))


def _png(body) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(body)))


def test_training_control_flags_and_events():
    seen = []
    h1 = bus().when(PauseTraining, lambda e: seen.append("pause"))
    h2 = bus().when(StopTraining, lambda e: seen.append("stop"))
    try:
        c = TrainingControl()
        assert not c.paused and not c.stop_requested
        assert not c.consume_save_request()
        c.pause()
        assert c.paused
        c.resume()
        assert not c.paused
        c.request_save()
        c.request_save()
        assert c.consume_save_request()
        assert c.consume_save_request()
        assert not c.consume_save_request()
        c.request_stop()
        assert c.stop_requested and not c.paused  # stop unblocks a pause
        assert seen == ["pause", "stop"]
        c.reset()
        assert not c.stop_requested
    finally:
        bus().off(PauseTraining, h1)
        bus().off(StopTraining, h2)


def test_live_server_http_surface(rng):
    splats = to_torch_splats(make_random_splats(rng, n=48, capacity=64))
    server = LiveTrainingServer(_FakeTrainer(splats), port=0).start()
    try:
        code, body, ctype = _get(server.port, "/")
        assert code == 200 and b"live training" in body and "text/html" in ctype

        code, body, _ = _get(server.port, "/state.json")
        st = json.loads(body)
        assert st["iteration"] == 123 and st["num_gaussians"] == 48
        assert st["status"] == "training"

        code, body, ctype = _get(server.port, "/render.png?w=64&h=48&yaw=0.5")
        assert code == 200 and "image/png" in ctype
        img = _png(body)
        assert img.shape[:2] == (48, 64)
        assert img.max() > 0  # rendered content, not a black frame

        code, body = _post(server.port, "/control?cmd=pause")
        assert code == 200 and json.loads(body)["ok"]
        code, body, _ = _get(server.port, "/state.json")
        assert json.loads(body)["status"] == "paused"
        _post(server.port, "/control?cmd=resume")

        code, _ = _post(server.port, "/control?cmd=bogus")
        assert code == 400
        code, _, _ = _get(server.port, "/nope")
        assert code == 404
        code, _, _ = _get(server.port, "/session.json")
        assert code == 404  # no studio session behind this server
    finally:
        server.stop()


def test_render_runs_on_the_trainer_thread_while_training(rng, monkeypatch):
    """While a run is active the HTTP thread only queues the render; the
    trainer's loop runs it between dispatches. The viewer keeps one
    coherent renderer per resolution and re-bins after the trainer writes
    the model in place."""
    splats = to_torch_splats(make_random_splats(rng, n=48, capacity=64))
    source = _FakeTrainer(splats)
    source.training_active = True
    server = LiveTrainingServer(source, port=0).start()
    ran_on, stop = [], threading.Event()
    real_run = live_server._Job.run

    def run(job, src):
        ran_on.append(threading.current_thread().name)
        real_run(job, src)

    def pump():  # the trainer loop's boundary: run the queued jobs
        while not stop.is_set():
            server.control.run_pending(source)
            time.sleep(0.01)

    monkeypatch.setattr(live_server._Job, "run", run)
    pumper = threading.Thread(target=pump, name="trainer", daemon=True)
    pumper.start()
    try:
        code, body, _ = _get(server.port, "/render.png?w=64&h=48")
        assert code == 200 and _png(body).max() > 0
        with torch.no_grad():  # a train step's in-place write
            splats.replace_trainable({"means": splats.means + 0.05})
        codes = [_get(server.port, "/render.png?w=64&h=48")[0] for _ in range(2)]
        assert codes == [200, 200]
        assert set(ran_on) == {"trainer"}
        (renderer,) = server._coherent.values()
        assert renderer.stats["bins"] == 2 and renderer.stats["frames"] == 3
    finally:
        stop.set()
        pumper.join(timeout=10)
        server.stop()
    assert not pumper.is_alive()


def test_render_error_reaches_the_reply_as_500(rng):
    class _NoModel:
        last_progress = (0, None, 0)

        @property
        def state(self):
            raise RuntimeError("no model loaded — POST /open first")

    server = LiveTrainingServer(_NoModel(), port=0).start()
    try:
        code, body, _ = _get(server.port, "/render.png?w=32&h=32")
        assert code == 500 and b"no model loaded" in body
    finally:
        server.stop()


@pytest.mark.slow
def test_trainer_pause_save_stop(rng, tmp_path):
    """A real Trainer through the control surface: pause freezes the
    iteration counter, save-while-paused writes a PLY, stop ends the run
    early with the final artifacts intact."""
    from lichtfeld_studio_tpu_torch.cli import parse_args_and_params
    from lichtfeld_studio_tpu_torch.train.trainer import Trainer
    from tests.test_trainer_e2e import _make_dataset

    _make_dataset(rng, tmp_path / "scene", n_views=4)
    params = parse_args_and_params([
        "-d", str(tmp_path / "scene"), "-o", str(tmp_path / "out"), "--headless",
        "--iterations", "4000",  # stop() must end it long before
        "--max-cap", "4096", "--instance-cap", "16384",
        "--start-refine", "100000",  # no refine in this short run
        "--sh-degree", "1", "--random", "--init-num-pts", "256", "--dispatch-steps", "2",
        "--num-workers", "1",
    ])
    trainer = Trainer.setup(params, "cpu")
    control = TrainingControl()
    trainer.control = control

    events = []
    h1 = bus().when(TrainingPaused, lambda e: events.append(("paused", e.iteration)))
    h2 = bus().when(TrainingStopped, lambda e: events.append(("stopped", e.iteration)))
    t = threading.Thread(target=trainer.train, daemon=True)
    t.start()
    try:
        deadline = time.time() + 300
        while trainer.last_progress[0] < 4 and time.time() < deadline:
            time.sleep(0.05)
        assert trainer.last_progress[0] >= 4, "training never advanced"

        control.pause()
        time.sleep(1.0)  # let the loop reach the pause gate
        frozen = trainer.last_progress[0]
        time.sleep(1.0)
        assert trainer.last_progress[0] == frozen, "iteration advanced while paused"

        # between-dispatch jobs are pumped while paused (the live viewer
        # renders during a pause) and run on the trainer's thread
        job = control.submit(lambda tr: int(tr.state.splats.n_active))
        assert job.done.wait(timeout=30), "paused loop did not pump jobs"
        assert job.error is None and job.result > 0

        control.request_save()  # save honoured while paused
        deadline = time.time() + 60
        while not list((tmp_path / "out").glob("splat_*.ply")) and time.time() < deadline:
            time.sleep(0.1)
        assert list((tmp_path / "out").glob("splat_*.ply")), "pause-time save produced no PLY"
        assert (tmp_path / "out" / "viewer_live.html").exists()

        control.request_stop()
        t.join(timeout=300)
        assert not t.is_alive(), "trainer did not stop"
        assert trainer.last_progress[0] < 4000
        kinds = [k for k, _ in events]
        assert "paused" in kinds and "stopped" in kinds
    finally:
        bus().off(TrainingPaused, h1)
        bus().off(TrainingStopped, h2)
        control.request_stop()
        t.join(timeout=60)
