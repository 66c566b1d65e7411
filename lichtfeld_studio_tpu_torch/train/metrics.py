"""Evaluation harness: PSNR / SSIM / LPIPS and the metrics.csv report
(counterpart of lichtfeld_studio_tpu/train/metrics.py).

Reference: src/training/metrics/ (PSNR metrics.hpp:28, windowed SSIM :40,
LPIPS via TorchScript VGG :54, MetricsEvaluator loop metrics.cpp:389-480,
csv/report writers :212-280). Same formulas and the same csv schema
(iteration,psnr,ssim,lpips,time_per_image,num_gaussians).

LPIPS is not ported yet (ROADMAP.md queue 1, item 5: it needs pretrained
VGG16 weights, and none ship with the repository): the column reads -1, as
the reference's does when `weights/lpips_vgg.pt` is missing
(metrics.cpp:125-128). Eval renders are forward-only: the inference
binning layout and blend, under no_grad.
"""

from __future__ import annotations

import csv
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from lichtfeld_studio_tpu_torch.core.splat_data import SplatData
from lichtfeld_studio_tpu_torch.io.dataset import CameraDataset
from lichtfeld_studio_tpu_torch.ops.rasterize import apply_render_mode, rasterize
from lichtfeld_studio_tpu_torch.ops.ssim import psnr as psnr_fn, ssim as ssim_fn


@dataclass
class EvalMetrics:
    psnr: float
    ssim: float
    lpips: float
    elapsed: float
    num_gaussians: int
    iteration: int


@dataclass
class MetricsEvaluator:
    dataset: CameraDataset
    output_dir: Path
    save_images: bool = True
    raster_mode: str = "cuda"
    instance_cap: int = 2**20
    lpips_weights: Optional[str] = None
    render_mode: str = "RGB"  # RGB/D/ED/RGB_D/RGB_ED (rasterizer.cpp:364-394)
    save_depth: bool = False  # force depth dumps even in RGB mode (--save-depth)
    projection: str = "auto"
    antialiasing: bool = False
    _rows: list[EvalMetrics] = field(default_factory=list)

    def __post_init__(self):
        self.output_dir = Path(self.output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        if self.lpips_weights:
            raise NotImplementedError(
                "not ported yet: --lpips-weights (LPIPS), ROADMAP.md queue 1, item 5")

    @torch.no_grad()
    def evaluate(self, splats: SplatData, iteration: int) -> EvalMetrics:
        """Render every val camera and average metrics
        (reference metrics.cpp:389-480)."""
        dev = splats.means.device
        bg = torch.zeros(3, device=dev)
        psnrs, ssims = [], []
        t0 = time.time()
        img_dir = self.output_dir / f"eval_step_{iteration}"
        if self.save_images:
            img_dir.mkdir(parents=True, exist_ok=True)
        with_depth = self.render_mode != "RGB" or self.save_depth
        for k in range(len(self.dataset)):
            cam = self.dataset[k]
            gt = torch.from_numpy(cam.load_image()).to(dev)
            out = rasterize(
                splats,
                cam.device_params(dev),
                bg,
                mode=self.raster_mode,
                instance_cap=self.instance_cap,
                with_depth=with_depth,
                projection=self.projection,
                antialiasing=self.antialiasing,
                inference=True,
            )
            pred = torch.clamp(out.image, 0.0, 1.0)
            psnrs.append(float(psnr_fn(pred, gt)))
            ssims.append(float(ssim_fn(pred, gt)))
            if self.save_images:
                from lichtfeld_studio_tpu_torch.io.image import save_image, side_by_side

                save_image(
                    str(img_dir / f"{Path(cam.image_name).stem}_compare.png"),
                    side_by_side(gt.cpu().numpy(), pred.cpu().numpy()),
                )
                if with_depth:
                    # depth colormap dump per render mode (metrics.cpp:454-480);
                    # --save-depth in RGB mode dumps the raw accumulated depth
                    if self.render_mode == "RGB":
                        d = out.depth.cpu().numpy()
                    else:
                        frame = apply_render_mode(out, self.render_mode).cpu().numpy()
                        d = frame[..., -1] if frame.shape[-1] in (1, 4) else frame[..., 0]
                    lo, hi = np.nanmin(d), np.nanmax(d)
                    dn = (d - lo) / max(hi - lo, 1e-9)
                    save_image(
                        str(img_dir / f"{Path(cam.image_name).stem}_depth.png"),
                        np.stack([dn, 1.0 - np.abs(2 * dn - 1), 1.0 - dn], axis=-1),
                    )
        n_img = max(len(psnrs), 1)
        # LPIPS reports -1 (the reference's disabled-LPIPS value, not NaN)
        m = EvalMetrics(
            psnr=float(np.mean(psnrs)) if psnrs else float("nan"),
            ssim=float(np.mean(ssims)) if ssims else float("nan"),
            lpips=-1.0,
            elapsed=(time.time() - t0) / n_img,
            num_gaussians=int(splats.n_active),
            iteration=iteration,
        )
        self._rows.append(m)
        self.write_csv()
        return m

    def write_csv(self) -> None:
        """metrics.csv with the reference schema (metrics.hpp:90)."""
        path = self.output_dir / "metrics.csv"
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(
                ["iteration", "psnr", "ssim", "lpips", "time_per_image", "num_gaussians"]
            )
            for m in self._rows:
                w.writerow(
                    [m.iteration, f"{m.psnr:.6f}", f"{m.ssim:.6f}", f"{m.lpips:.6f}",
                     f"{m.elapsed:.6f}", m.num_gaussians]
                )

    def write_report(self) -> None:
        """Final text report with best/final (reference metrics.cpp:212-280)."""
        if not self._rows:
            return
        best = max(self._rows, key=lambda m: m.psnr)
        final = self._rows[-1]

        def lp(m: EvalMetrics) -> str:
            # -1 is the "no VGG weights" sentinel (see evaluate): say so
            # instead of printing a misleading number
            return f"{m.lpips:.4f}" if m.lpips >= 0 else "unavailable (no weights)"

        lines = [
            "Evaluation report",
            "=================",
            f"evaluations: {len(self._rows)}",
            f"best   : iter {best.iteration}  PSNR {best.psnr:.4f}  SSIM {best.ssim:.4f}  LPIPS {lp(best)}",
            f"final  : iter {final.iteration}  PSNR {final.psnr:.4f}  SSIM {final.ssim:.4f}  LPIPS {lp(final)}",
            f"gaussians(final): {final.num_gaussians}",
            "",
        ]
        if final.lpips < 0:
            lines.insert(
                3,
                "lpips: unavailable (no VGG weights in this environment; "
                "export with tools/export_lpips_weights.py and pass --lpips-weights)",
            )
        (self.output_dir / "report.txt").write_text("\n".join(lines))
