"""Project management: the .lfs JSON project file.

Reference: src/project/project.cpp (798 LoC) — versioned project JSON with a
migration registry (:75-90, 168-179), validation (:241-250), PLY output
registry (project.hpp:143), temp projects + lock files
(project.hpp:182-188). Same schema version and on-disk shape so projects
interop with the reference GUI.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

CURRENT_VERSION = 2
EXTENSION = ".lfs"


@dataclass
class PlyRecord:
    name: str
    path: str
    iteration: int = 0
    added_at: float = field(default_factory=time.time)


@dataclass
class Project:
    path: Path
    data: dict = field(default_factory=dict)

    # -- migration registry (project.cpp:75-90) --
    _MIGRATIONS: dict[int, Callable[[dict], dict]] = None  # populated below

    @staticmethod
    def create(
        path: str | Path,
        project_name: str = "project",
        data_path: str = "",
        output_path: str = "",
        params: Optional[dict] = None,
    ) -> "Project":
        path = Path(path)
        if path.suffix != EXTENSION:
            path = path.with_suffix(EXTENSION)
        data = {
            "version": CURRENT_VERSION,
            "project_name": project_name,
            "created_at": time.time(),
            "updated_at": time.time(),
            "data_path": str(data_path),
            "output_path": str(output_path),
            "training_params": params or {},
            "plys": [],
        }
        p = Project(path=path, data=data)
        p.save()
        return p

    @staticmethod
    def create_temp(project_name: str = "temp_project") -> "Project":
        """Temp project with lock file (reference CreateTempNewProject,
        project.hpp:185)."""
        d = Path(tempfile.mkdtemp(prefix="lfs_tpu_"))
        p = Project.create(d / f"{project_name}{EXTENSION}", project_name)
        (d / ".lock").write_text(str(os.getpid()))
        return p

    @staticmethod
    def load(path: str | Path) -> "Project":
        path = Path(path)
        data = json.loads(path.read_text())
        data = Project._migrate(data)
        p = Project(path=path, data=data)
        p.validate()
        return p

    @staticmethod
    def _migrate(data: dict) -> dict:
        version = data.get("version", 1)
        while version < CURRENT_VERSION:
            fn = _MIGRATIONS.get(version)
            if fn is None:
                raise ValueError(f"no migration from project version {version}")
            data = fn(data)
            version = data["version"]
        return data

    def validate(self) -> None:
        """(reference project.cpp:241-250)"""
        for k in ("version", "project_name", "plys"):
            if k not in self.data:
                raise ValueError(f"invalid project file: missing '{k}'")
        if self.data["version"] != CURRENT_VERSION:
            raise ValueError(f"unsupported project version {self.data['version']}")

    def add_ply(self, name: str, ply_path: str | Path, iteration: int = 0) -> None:
        """Register a training output (reference project.hpp:143 addPly)."""
        self.data["plys"].append(
            {
                "name": name,
                "path": str(ply_path),
                "iteration": iteration,
                "added_at": time.time(),
            }
        )
        self.save()

    def plys(self) -> list[PlyRecord]:
        return [PlyRecord(**{k: v for k, v in d.items()}) for d in self.data["plys"]]

    def set_params(self, params: dict) -> None:
        self.data["training_params"] = params
        self.save()

    def save(self) -> None:
        self.data["updated_at"] = time.time()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(json.dumps(self.data, indent=2))
        tmp.replace(self.path)

    @staticmethod
    def remove_temp_unlocked(root: Optional[Path] = None) -> int:
        """Clean up temp projects whose lock holder died
        (reference RemoveTempUnlockedProjects, project.hpp:187)."""
        import shutil

        root = root or Path(tempfile.gettempdir())
        removed = 0
        for d in root.glob("lfs_tpu_*"):
            lock = d / ".lock"
            try:
                pid = int(lock.read_text()) if lock.exists() else -1
                alive = pid > 0 and Path(f"/proc/{pid}").exists()
                if not alive:
                    shutil.rmtree(d, ignore_errors=True)
                    removed += 1
            except (ValueError, OSError):
                continue
        return removed


def _migrate_v1_to_v2(data: dict) -> dict:
    """v1 stored outputs as a flat list of paths."""
    data = dict(data)
    plys = data.pop("outputs", [])
    data["plys"] = [
        {"name": Path(p).stem, "path": p, "iteration": 0, "added_at": 0.0}
        for p in plys
    ]
    data["version"] = 2
    return data


_MIGRATIONS: dict[int, Callable[[dict], dict]] = {1: _migrate_v1_to_v2}
