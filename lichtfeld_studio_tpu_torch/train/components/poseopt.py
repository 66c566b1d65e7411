"""Camera pose optimisation (counterpart of
lichtfeld_studio_tpu/train/components/poseopt.py; reference
src/training/components/poseopt.{cpp,hpp}).

Three modes: none; `direct`, a per-camera 9D embedding (3 translation +
6D rotation delta); `mlp`, a per-camera embedding -> MLP(width 64, depth 2)
-> 9D delta. The delta forms a 4x4 that is right-multiplied onto the
world-to-camera transform. Trained with its own Adam, lr 1e-5
(trainer.cpp:384-386). The parameters are a plain dict of tensors.
"""

from __future__ import annotations

import torch


def rotation_6d_to_matrix(rot6d: torch.Tensor) -> torch.Tensor:
    """[..., 6] -> [..., 3, 3] by Gram-Schmidt (poseopt.cpp:12-21)."""
    a1, a2 = rot6d[..., :3], rot6d[..., 3:]
    b1 = a1 / torch.clamp(torch.linalg.norm(a1, dim=-1, keepdim=True), min=1e-12)
    a2p = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = a2p / torch.clamp(torch.linalg.norm(a2p, dim=-1, keepdim=True), min=1e-12)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def init_pose_params(mode: str, num_cameras: int, width: int = 64, depth: int = 2,
                     generator: torch.Generator | None = None, device=None) -> dict:
    """Pose parameters that start at the identity in both modes. The `mlp`
    hidden layers are drawn from `generator` (a CPU generator; seed 0 when
    None) by torch.nn.Linear's law, U(-1/sqrt(width), 1/sqrt(width)); the
    output layer is zero."""
    if mode == "none":
        return {}
    if mode == "direct":
        return {"embeddings": torch.zeros((num_cameras, 9), dtype=torch.float32, device=device)}
    if mode != "mlp":
        raise ValueError(f"unknown pose optimization mode {mode}")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    lim = 1.0 / width**0.5

    def uniform(*shape):
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        return ((2.0 * u - 1.0) * lim).to(device)

    params = {"embeddings": torch.zeros((num_cameras, width), dtype=torch.float32, device=device)}
    for i in range(depth):
        params[f"w{i}"] = uniform(width, width)
        params[f"b{i}"] = uniform(width)
    params["w_out"] = torch.zeros((width, 9), dtype=torch.float32, device=device)
    params["b_out"] = torch.zeros((9,), dtype=torch.float32, device=device)
    return params


def _delta_to_transform(delta: torch.Tensor) -> torch.Tensor:
    """9D delta -> 4x4 (poseopt.cpp:31-45). The identity's rows come from
    torch.eye, made on the device: no host-to-device copy in the step."""
    eye = torch.eye(4, dtype=delta.dtype, device=delta.device)
    rot = rotation_6d_to_matrix(delta[3:] + eye[:2, :3].reshape(6))  # 6D identity (1,0,0,0,1,0)
    return torch.cat([torch.cat([rot, delta[:3, None]], dim=1), eye[3:]], dim=0)


def pose_delta(mode: str, params: dict, uid: int, depth: int = 2) -> torch.Tensor:
    """The 4x4 correction of camera `uid`."""
    if mode == "direct":
        return _delta_to_transform(params["embeddings"][uid])
    h = params["embeddings"][uid]
    for i in range(depth):
        h = torch.relu(h @ params[f"w{i}"] + params[f"b{i}"])
    return _delta_to_transform(h @ params["w_out"] + params["b_out"])


def apply_pose_opt(mode: str, params: dict, w2c: torch.Tensor, uid: int,
                   depth: int = 2) -> torch.Tensor:
    """Adjust one camera's w2c [4, 4]: w2c @ delta (the reference
    right-multiplies)."""
    if mode == "none" or not params:
        return w2c
    return w2c @ pose_delta(mode, params, uid, depth)
