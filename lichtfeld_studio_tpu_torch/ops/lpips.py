"""LPIPS (the VGG16 variant) in PyTorch (counterpart of
lichtfeld_studio_tpu/ops/lpips.py).

Reference: src/training/metrics/metrics.hpp:54 loads a TorchScript VGG LPIPS
(`weights/lpips_vgg.pt`). Here the same network reads its weights from an
.npz with the keys of the `lpips` package's state dict (written by
tools/export_lpips_weights.py): net.slice{1..5}.<idx>.weight/bias for the
VGG convolutions, lin{0..4}.model.1.weight for the linear heads. The
normalisation constants are lpips.LPIPS's (ImageNet shift and scale).

The convolutions run in float32 with "same" padding; on the card cuDNN's
TF32 is switched off around them (the JAX package convolves at
Precision.HIGHEST).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# VGG16 conv layout: (out_channels, conv indices within torchvision features)
_SLICES = [
    (64, [0, 2]),  # relu1_2
    (128, [5, 7]),  # relu2_2
    (256, [10, 12, 14]),  # relu3_3
    (512, [17, 19, 21]),  # relu4_3
    (512, [24, 26, 28]),  # relu5_3
]

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


class LPIPS(torch.nn.Module):
    def __init__(self, convs: dict[int, tuple[np.ndarray, np.ndarray]], lins: list[np.ndarray]):
        super().__init__()
        for idx, (w, b) in convs.items():
            self.register_buffer(f"w{idx}", torch.as_tensor(np.asarray(w, np.float32)))
            self.register_buffer(f"b{idx}", torch.as_tensor(np.asarray(b, np.float32)))
        for i, w in enumerate(lins):
            self.register_buffer(f"lin{i}", torch.as_tensor(np.asarray(w, np.float32)))
        self.register_buffer("shift", torch.as_tensor(_SHIFT))
        self.register_buffer("scale", torch.as_tensor(_SCALE))

    @staticmethod
    def from_npz(path: str) -> "LPIPS":
        data = np.load(path)
        convs = {}
        for si, (_, idxs) in enumerate(_SLICES):
            for idx in idxs:
                convs[idx] = (data[f"net.slice{si + 1}.{idx}.weight"],
                              data[f"net.slice{si + 1}.{idx}.bias"])
        lins = [data[f"lin{i}.model.1.weight"][:, :, 0, 0] for i in range(5)]
        return LPIPS(convs, lins)

    def _features(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x: [1, 3, H, W] normalised. Returns each slice's activations."""
        feats = []
        h = x
        for si, (_, idxs) in enumerate(_SLICES):
            if si > 0:
                h = F.max_pool2d(h, 2, 2)
            for idx in idxs:
                h = torch.relu(F.conv2d(h, getattr(self, f"w{idx}"), getattr(self, f"b{idx}"),
                                        padding="same"))
            feats.append(h)
        return feats

    @torch.no_grad()
    def forward(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """pred, target [H, W, 3] in [0, 1]; returns the LPIPS distance."""

        def prep(img):
            x = (img * 2.0 - 1.0 - self.shift) / self.scale  # lpips' scaling layer
            return x.permute(2, 0, 1)[None]

        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            f1, f2 = self._features(prep(pred)), self._features(prep(target))
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        total = torch.zeros((), dtype=torch.float32, device=pred.device)
        for i, (a, b) in enumerate(zip(f1, f2)):
            a = a / torch.clamp(torch.linalg.norm(a, dim=1, keepdim=True), min=1e-10)
            b = b / torch.clamp(torch.linalg.norm(b, dim=1, keepdim=True), min=1e-10)
            lin = getattr(self, f"lin{i}")[0]  # [C]: a 1x1 convolution to one channel
            total = total + ((a - b) ** 2 * lin[None, :, None, None]).sum(dim=1).mean()
        return total
