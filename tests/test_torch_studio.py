"""The port's studio session: the reference's cases of tests/test_studio.py
on the port (open a model, render, crop, transform and save through the
server; a dataset opened, trained, watched, cropped and saved in one
session), a .sog opened like a .ply, and the CLI's lobby."""

import json
import types
import urllib.request

import numpy as np
import pytest
import torch

from lichtfeld_studio_tpu_torch import cli as t_cli
from lichtfeld_studio_tpu_torch.io.ply import write_ply
from lichtfeld_studio_tpu_torch.io.sog import write_sog
from lichtfeld_studio_tpu_torch.render import headless
from lichtfeld_studio_tpu_torch.render.headless import splats_from_ply
from lichtfeld_studio_tpu_torch.render.live_server import LiveTrainingServer
from lichtfeld_studio_tpu_torch.render.studio import StudioSession
from tests.scene_utils import make_random_splats
from tests.torch_parity import np_, to_torch_splats


def _get(port, path, timeout=60):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post(port, path, body: dict, timeout=120):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method="POST",
                                 data=json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _model(rng, path, n=64):
    splats = to_torch_splats(make_random_splats(rng, n=n, capacity=n, spread=1.0))
    write_ply(splats.to_point_cloud(), path)
    return splats


def test_studio_open_ply_crop_save(rng, tmp_path):
    _model(rng, tmp_path / "model.ply")
    session = StudioSession(out_dir=tmp_path / "out", device="cpu")
    server = LiveTrainingServer(session, port=0).start()
    try:
        code, body = _get(server.port, "/session.json")
        assert code == 200 and json.loads(body)["mode"] == "lobby"

        # verbs reject cleanly before a model exists
        code, res = _post(server.port, "/crop", {"min": [0, 0, 0], "max": [1, 1, 1]})
        assert code == 409 and "error" in res
        code, res = _post(server.port, "/open", {"path": str(tmp_path / "nope.ply")})
        assert code == 409

        code, res = _post(server.port, "/open", {"path": str(tmp_path / "model.ply")})
        assert code == 200 and res["mode"] == "viewing" and res["num_gaussians"] == 64

        code, body = _get(server.port, "/render.png?w=48&h=32")
        assert code == 200

        # crop to the +x half-space: fewer gaussians survive, none outside
        code, res = _post(server.port, "/crop", {"min": [0, -2, -2], "max": [2, 2, 2]})
        assert code == 200 and 0 < res["kept"] < 64
        kept = res["kept"]
        means = np_(session.splats.means[: int(session.splats.n_active)])
        assert means.shape[0] == kept and (means[:, 0] >= 0).all()

        code, res = _post(server.port, "/transform", {"translate": [5.0, 0, 0]})
        assert code == 200
        np.testing.assert_allclose(np_(session.splats.means[:kept])[:, 0], means[:, 0] + 5.0,
                                   atol=1e-5)

        code, res = _post(server.port, "/saveply", {"name": "edited"})
        assert code == 200
        assert int(splats_from_ply(res["path"]).n_active) == kept
    finally:
        server.stop()


def test_studio_opens_a_sog_and_renders_it(rng, tmp_path):
    splats = to_torch_splats(make_random_splats(rng, n=80, capacity=80, spread=1.0))
    write_sog(splats.to_point_cloud(), tmp_path / "model.sog", kmeans_iterations=4, device="cpu")
    session = StudioSession(out_dir=tmp_path / "out", device="cpu")
    server = LiveTrainingServer(session, port=0).start()
    try:
        code, res = _post(server.port, "/open", {"path": str(tmp_path / "model.sog")})
        assert code == 200 and res["mode"] == "viewing" and res["num_gaussians"] == 80
        code, body = _get(server.port, "/render.png?w=48&h=32")
        assert code == 200
        code, res = _post(server.port, "/transform", {"euler": [0.0, 0.0, 0.5]})
        assert code == 200 and res["num_gaussians"] == 80
    finally:
        server.stop()


def test_studio_lobby_through_the_cli(tmp_path, monkeypatch, capsys):
    """--live-viewer with no -d/-v serves the lobby until interrupted."""
    monkeypatch.setattr(headless, "default_device", lambda: torch.device("cpu"))
    started = {}
    real_start = LiveTrainingServer.start

    def start(self):
        started["server"] = self
        return real_start(self)

    def interrupt(_seconds):
        code, body = _get(started["server"].port, "/session.json")
        started["session"] = (code, json.loads(body))
        raise KeyboardInterrupt

    monkeypatch.setattr(LiveTrainingServer, "start", start)
    monkeypatch.setattr(t_cli, "time", types.SimpleNamespace(sleep=interrupt))
    assert t_cli.main(["--live-viewer", "0", "-o", str(tmp_path / "out")]) == 0
    assert started["session"] == (200, {
        "mode": "lobby", "data_path": None, "model_loaded": False, "num_gaussians": 0,
        "train_error": None, "train_stats": None})
    assert "studio session" in capsys.readouterr().out


@pytest.mark.slow
def test_studio_dataset_to_train_to_crop(rng, tmp_path):
    """dataset -> train -> watch -> crop -> save in one browser session."""
    from tests.test_trainer_e2e import _make_dataset

    _make_dataset(rng, tmp_path / "scene", n_views=4)
    session = StudioSession(out_dir=tmp_path / "out", device="cpu")
    server = LiveTrainingServer(session, port=0).start()
    try:
        code, res = _post(server.port, "/open", {"path": str(tmp_path / "scene")})
        assert code == 200 and res["mode"] == "staged" and res["num_cameras"] == 4

        # training cannot start twice; edits are rejected mid-run
        code, res = _post(server.port, "/train", {"argv": [
            "-i", "8", "--max-cap", "2048", "--instance-cap", "8192",
            "--start-refine", "100000", "--sh-degree", "1",
            "--random", "--init-num-pts", "128", "--dispatch-steps", "2", "--num-workers", "1",
        ]})
        assert code == 200 and res["mode"] == "training"
        code, res = _post(server.port, "/train", {"argv": []})
        assert code == 409

        assert session.wait(timeout=900), "training did not finish"
        assert session.train_error is None
        assert session.mode == "done"
        code, body = _get(server.port, "/state.json")
        assert json.loads(body)["status"] == "done"

        n_before = int(session.splats.n_active)
        assert n_before == 128
        code, res = _post(server.port, "/crop", {"min": [-0.5, -2, -2], "max": [2, 2, 2]})
        assert code == 200 and res["kept"] + res["removed"] == n_before

        code, res = _post(server.port, "/saveply", {"name": "final_cropped"})
        assert code == 200
        import os

        assert os.path.exists(res["path"])
    finally:
        session.control and session.control.request_stop()
        server.stop()


def test_session_needs_a_gpu_unless_given_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        StudioSession()
    assert StudioSession(device="cpu").mode == "lobby"
