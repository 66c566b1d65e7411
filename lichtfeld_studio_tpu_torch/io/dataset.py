"""Camera dataset: train/val split + background prefetch loader.

Reference: src/training/dataset.hpp (CameraDataset, InfiniteRandomSampler,
make_data_loader) — split rule `i % test_every == 0` -> val (dataset.hpp:
42-48), lazy per-camera image load, N worker threads. Counterpart of
lichtfeld_studio_tpu/io/dataset.py: a thread-pool prefetcher that decodes
and resizes ahead of the train loop and hands out (Camera, host image)
pairs; the trainer copies the image to the device (pinned buffer,
non_blocking). With more than one worker the order of the queue is not
deterministic."""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from lichtfeld_studio_tpu_torch.core.camera import Camera


@dataclass
class CameraDataset:
    cameras: list[Camera]
    split: str = "train"  # train | val | all
    test_every: int = 8

    def indices(self) -> list[int]:
        n = len(self.cameras)
        if self.split == "all" or self.test_every <= 0:
            return list(range(n))
        if self.split == "val":
            return [i for i in range(n) if i % self.test_every == 0]
        return [i for i in range(n) if i % self.test_every != 0]

    def __len__(self) -> int:
        return len(self.indices())

    def __getitem__(self, k: int) -> Camera:
        return self.cameras[self.indices()[k]]


class InfiniteRandomLoader:
    """Endless shuffled camera stream with background decode threads
    (reference InfiniteRandomSampler + worker threads, dataset.hpp:116-135,
    233-259). Yields (Camera, np.ndarray HWC float image)."""

    def __init__(
        self,
        dataset: CameraDataset,
        num_workers: int = 2,
        prefetch: int = 4,
        seed: int = 0,
        preload: bool = False,
    ):
        self.dataset = dataset
        self.rng = np.random.default_rng(seed)
        self.q: queue.Queue = queue.Queue(maxsize=prefetch)
        self.idx_q: queue.Queue = queue.Queue(maxsize=prefetch * 2)
        self._stop = threading.Event()
        self._preload = preload
        if preload:
            for i in range(len(dataset)):
                dataset[i].load_image(cache=True)
        self._feeder = threading.Thread(target=self._feed, daemon=True)
        self._feeder.start()
        self._workers = [
            threading.Thread(target=self._work, daemon=True)
            for _ in range(max(1, num_workers))
        ]
        for w in self._workers:
            w.start()

    def _feed(self):
        n = len(self.dataset)
        while not self._stop.is_set():
            order = self.rng.permutation(n)
            for i in order:
                if self._stop.is_set():
                    return
                self.idx_q.put(int(i))

    def _work(self):
        while not self._stop.is_set():
            try:
                i = self.idx_q.get(timeout=0.25)
            except queue.Empty:
                continue
            cam = self.dataset[i]
            img = cam.load_image(cache=self._preload)
            self.q.put((cam, img))

    def __iter__(self) -> Iterator[tuple[Camera, np.ndarray]]:
        return self

    def __next__(self) -> tuple[Camera, np.ndarray]:
        return self.q.get()

    def stop(self):
        self._stop.set()


def load_dataset(
    data_path: str,
    images: str = "images",
    resize_factor: int = -1,
    max_width: int = 3840,
):
    """Format auto-detection (reference loader facade, src/loader/loader.cpp:
    19-80): COLMAP markers -> colmap; transforms json -> blender; .ply file ->
    splat. Returns (cameras, point_cloud, scene_center)."""
    from pathlib import Path

    from lichtfeld_studio_tpu_torch.io import colmap, transforms

    p = Path(data_path)
    if colmap.is_colmap_dataset(p):
        return colmap.load_colmap(p, images, resize_factor, max_width)
    if transforms.is_transforms_dataset(p):
        return transforms.load_transforms(p, resize_factor, max_width)
    raise ValueError(f"unrecognized dataset at {data_path}")
