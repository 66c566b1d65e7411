"""Browser-driven application lifecycle (counterpart of
lichtfeld_studio_tpu/render/studio.py) — the headless counterpart of the
reference's GUI application flow (src/core/application.cpp:56-138
run_gui_app: start the visualizer with or without data, open datasets/PLYs
from the UI via DataLoadingService, configure + launch training through
TrainerManager, training_manager.cpp:121-165, and edit the scene with the
crop/translation tools, src/visualizer/tools/).

A StudioSession owns the current model/run and is the live server's
`source`: it exposes `.state.splats`, `.last_progress` and
`.training_active` exactly like a Trainer, so every existing endpoint
(/render.png, /state.json, /control) works in all modes. On top it
implements the lifecycle verbs the reference GUI has:

    open(path)        .ply/.sog -> static model  |  dataset dir -> staged
    start_training()  Trainer.setup on the staged dataset + CLI-style args,
                      run on a worker thread (the reference's jthread);
                      with --devices N that thread is rank 0 and ranks
                      1..N-1 are processes of their own, as the CLI's
    crop(min,max)     SplatData.crop_by_bbox applied to the CURRENT model
    transform(...)    SE(3) EuclideanTransform applied to the current model
    save(name)        write the current model as PLY

Edits apply to a quiescent model (lobby/viewing/finished) — while a run is
training, the model is the optimizer's (the reference disables the gizmo
on the in-training scene too), and edits during an active run, paused or
not, are rejected with a clear error.

Models and runs live on `device`: the first GPU unless the caller passes
one (the tests pass "cpu").
"""

from __future__ import annotations

import datetime
import os
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

# --devices N: bounds every collective of a run's ranks, and the wait for
# ranks 1..N-1 once rank 0 has ended
RANK_TIMEOUT = datetime.timedelta(minutes=10)


class _StaticState:
    """Duck-typed stand-in for TrainState when viewing a static model."""

    def __init__(self, splats):
        self.splats = splats


class StudioSession:
    MODES = ("lobby", "viewing", "staged", "training", "done")

    def __init__(self, out_dir: str | Path = "output", device=None):
        if device is None:
            from lichtfeld_studio_tpu_torch.render.headless import default_device

            device = default_device()
        self.device = device
        self.out_dir = Path(out_dir)
        self._lock = threading.Lock()
        self.mode = "lobby"
        self.data_path: str | None = None
        self.splats = None  # static model (viewing/done)
        self.trainer = None
        self.control = None  # TrainingControl while training
        self._thread: threading.Thread | None = None
        self.train_error: str | None = None
        self.train_stats: dict | None = None

    # --- live-server source protocol -----------------------------------
    @property
    def state(self):
        t = self.trainer
        if t is not None and self.mode == "training":
            return t.state
        if self.splats is not None:
            return _StaticState(self.splats)
        if t is not None:
            return t.state
        raise RuntimeError("no model loaded — POST /open first")

    @property
    def last_progress(self):
        if self.trainer is not None:
            return self.trainer.last_progress
        n = int(self.splats.n_active) if self.splats is not None else 0
        return (0, None, n)

    @property
    def training_active(self) -> bool:
        return self.mode == "training"

    # --- lifecycle verbs ------------------------------------------------
    def session_json(self) -> dict:
        return {
            "mode": self.mode,
            "data_path": self.data_path,
            "model_loaded": self.splats is not None
            or (self.trainer is not None and self.mode in ("training", "done")),
            "num_gaussians": self.last_progress[2],
            "train_error": self.train_error,
            "train_stats": self.train_stats,
        }

    def open(self, path: str) -> dict:
        """DataLoadingService analog: a .ply/.sog becomes the viewed model;
        a directory is validated as a dataset and staged for /train."""
        with self._lock:
            if self.mode == "training":
                raise RuntimeError("a training run is active — stop it first")
            p = Path(path)
            if not p.exists():
                raise FileNotFoundError(f"no such path: {path}")
            if p.is_file():
                from lichtfeld_studio_tpu_torch.render.headless import splats_from_ply

                self.splats = splats_from_ply(p, device=self.device)
                self.trainer = None
                self.data_path = None
                self.mode = "viewing"
                return {"mode": self.mode, "num_gaussians": int(self.splats.n_active)}
            # dataset directory: validate it loads (COLMAP / transforms /
            # PLY-pointcloud detection, io/dataset.py) without holding the
            # cameras — Trainer.setup reloads at /train time with the run's
            # resize/test-every settings.
            from lichtfeld_studio_tpu_torch.io.dataset import load_dataset

            cameras, _, _ = load_dataset(str(p))
            self.data_path = str(p)
            self.mode = "staged"
            return {"mode": self.mode, "num_cameras": len(cameras)}

    def start_training(self, argv: list[str], control) -> dict:
        """Configure + launch a run on the staged dataset (TrainerManager::
        start_training, training_manager.cpp:121-165). `argv` is CLI-style
        flags — the browser gets the CLI's full 70-flag surface for free.
        Bad flags raise here; with --devices N the ranks are set up on the
        run's thread (_train_ranks), and what fails there lands in
        train_error."""
        with self._lock:
            if self.mode == "training":
                raise RuntimeError("a training run is already active")
            if self.data_path is None:
                raise RuntimeError("no dataset staged — POST /open a dataset dir first")
            from lichtfeld_studio_tpu_torch.cli import parse_args_and_params
            from lichtfeld_studio_tpu_torch.train.trainer import Trainer

            full = ["-d", self.data_path, "-o", str(self.out_dir), "--headless", *argv]
            params = parse_args_and_params(full)
            if hasattr(control, "reset"):
                control.reset()  # a previous run's stop flag must not leak
            if params.optimization.devices == 1:
                trainer = self._adopt(Trainer.setup(params, self.device), control)
                body = trainer.train
            else:
                self.trainer = None

                def body():
                    return self._train_ranks(full, params, control)

            self.control = control
            self.splats = None
            self.train_error = None
            self.train_stats = None
            self.mode = "training"

            def run():
                try:
                    self.train_stats = body()
                except Exception as e:  # surface to /session.json
                    self.train_error = f"{type(e).__name__}: {e}"
                finally:
                    with self._lock:
                        self.mode = "done"
                        # adopt the final model for viewing/editing
                        if self.trainer is not None:
                            self.splats = self.trainer.state.splats

            self._thread = threading.Thread(target=run, daemon=True)
            self._thread.start()
            return {"mode": self.mode, "iterations": params.optimization.iterations}

    def _adopt(self, trainer, control):
        """Make `trainer` the session's, steered by `control`."""
        trainer.control = control
        trainer.training_active = True  # before any frame can race
        self.trainer = trainer
        return trainer

    def _train_ranks(self, argv: list[str], params, control) -> dict:
        """--devices N on the run's thread: ranks 1..N-1 run cli._train_rank
        (the CLI's rank body) in processes of their own, and this thread is
        rank 0, steered by the live control (its flags reach every rank).
        Returns rank 0's stats once every rank has ended with the same state
        (parallel.state_digest); raises if a rank raised, if a rank is still
        running RANK_TIMEOUT after rank 0 ended, or if the states differ."""
        import torch.distributed as dist

        from lichtfeld_studio_tpu_torch.cli import _train_rank
        from lichtfeld_studio_tpu_torch.parallel import data_parallel as dp
        from lichtfeld_studio_tpu_torch.train.trainer import Trainer

        world = params.optimization.devices
        devices = dp.rank_devices(world, self.device)
        wait_s = RANK_TIMEOUT.total_seconds()
        root = tempfile.mkdtemp(prefix="lfs-dp-")
        peers = dp.start_ranks(_train_rank, world, root, devices, args=(argv,),
                               timeout=RANK_TIMEOUT, first=1)
        try:
            try:
                ctx = dp.init_rank(0, world, devices[0], dp.choose_backend(devices),
                                   os.path.join(root, "store"), RANK_TIMEOUT)
                try:
                    trainer = self._adopt(Trainer.setup(params, ctx.device, ranks=ctx), control)
                    stats = trainer.train()
                    digest = dp.state_digest(trainer.state)
                finally:
                    dist.destroy_process_group()
            except Exception as e:
                # the peers' own failures explain rank 0's (often a lost connection)
                try:
                    dp.join_ranks(peers, root, first=1, deadline=wait_s)
                except Exception as peer_error:
                    raise RuntimeError(f"rank 0 raised {type(e).__name__}: {e}\n"
                                       f"{type(peer_error).__name__}: {peer_error}") from e
                raise
            digests = [digest] + [r["digest"] for r in
                                  dp.join_ranks(peers, root, first=1, deadline=wait_s)]
        finally:
            dp.stop_ranks(peers, root)
        if len(set(digests)) != 1:
            raise RuntimeError(f"the {world} ranks ended with different states: {digests}")
        return stats

    def wait(self, timeout: float | None = None) -> bool:
        t = self._thread
        if t is None:
            return True
        t.join(timeout)
        return not t.is_alive()

    def _editable_splats(self):
        if self.mode == "training":
            raise RuntimeError(
                "model is being trained — stop the run before editing"
            )
        if self.splats is None and self.trainer is not None:
            self.splats = self.trainer.state.splats
        if self.splats is None:
            raise RuntimeError("no model loaded")
        return self.splats

    def crop(self, bbox_min, bbox_max) -> dict:
        """Apply the crop box to the model (reference crop-box tool applied
        via SceneManager; SplatData::crop_by_cropbox, splat_data.cpp:616+)."""
        from lichtfeld_studio_tpu_torch.core.geometry import BoundingBox

        splats = self._editable_splats()
        before = int(splats.n_active)
        box = BoundingBox(
            min=np.asarray(bbox_min, np.float32), max=np.asarray(bbox_max, np.float32)
        )
        with self._lock:
            self.splats = splats.crop_by_bbox(box)
            if self.mode in ("lobby", "staged"):
                self.mode = "viewing"
        return {"kept": int(self.splats.n_active), "removed": before - int(self.splats.n_active)}

    def transform(self, translate=None, euler=None) -> dict:
        """Apply an SE(3) edit (reference translation gizmo,
        src/visualizer/tools/translation_gizmo_tool.cpp -> SplatData::transform)."""
        from lichtfeld_studio_tpu_torch.core.geometry import EuclideanTransform

        splats = self._editable_splats()
        t = np.asarray(translate if translate is not None else [0, 0, 0], np.float32)
        r, p_, y = (euler or [0.0, 0.0, 0.0])
        xf = EuclideanTransform.from_euler(float(r), float(p_), float(y), translation=t)
        with self._lock:
            self.splats = splats.transformed(xf)
            if self.mode in ("lobby", "staged"):
                self.mode = "viewing"
        return {"ok": True, "num_gaussians": int(self.splats.n_active)}

    def save(self, name: str = "") -> dict:
        """Write the current model as a PLY into the session output dir."""
        splats = self._editable_splats()
        from lichtfeld_studio_tpu_torch.io.ply import write_ply

        self.out_dir.mkdir(parents=True, exist_ok=True)
        fname = name.strip() or f"studio_{int(time.time())}.ply"
        if not fname.endswith(".ply"):
            fname += ".ply"
        out = self.out_dir / Path(fname).name  # no path traversal
        write_ply(splats.to_point_cloud(), out)
        return {"path": str(out), "num_gaussians": int(splats.n_active)}
