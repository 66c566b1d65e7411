"""Training-state checkpoint and resume (counterpart of
lichtfeld_studio_tpu/train/checkpoint.py).

The reference has no training-state snapshots: its checkpoints are model
exports only (PLY/SOG at save_steps; the optimizer state and the iteration
counter are lost, SURVEY §5.4). Here the whole TrainState goes through
`torch.save` as one plain dict: parameters, Adam moments, step counts and
per-group LRs, the generator's state, the iteration, the binomial table,
the ADC statistics, the components' parameters and their Adam state, the
ADMM duals and the model's static fields. Resume is bit-exact on
one device type. A generator's state restores only onto a generator of the
same device type (a CUDA generator's state is not a CPU generator's):
`load_checkpoint` raises otherwise.
"""

from __future__ import annotations

from pathlib import Path

import torch

from lichtfeld_studio_tpu_torch.ops.adam import AdamState
from lichtfeld_studio_tpu_torch.train.state import TrainState

_FILE = "state.pt"
_ADAM_FIELDS = ("exp_avg", "exp_avg_sq", "step_count", "lr")


def _adam_to_cpu(adam: AdamState) -> dict:
    return {f: {k: v.cpu() for k, v in getattr(adam, f).items()} for f in _ADAM_FIELDS}


def _adam_from(payload: dict, dev) -> AdamState:
    return AdamState(*({k: v.to(dev) for k, v in payload[f].items()} for f in _ADAM_FIELDS))


def _file(path: str | Path) -> Path:
    return Path(path) / _FILE


def save_checkpoint(state: TrainState, path: str | Path) -> None:
    """Write `state` under the directory `path` (as `state.pt`)."""
    splats = state.splats
    payload = {
        "params": {k: p.detach().cpu() for k, p in splats.trainable_dict().items()},
        "n_active": int(splats.n_active),
        "active_sh_degree": int(splats.active_sh_degree),
        "max_sh_degree": splats.max_sh_degree,
        "scene_scale": splats.scene_scale,
        "adam": _adam_to_cpu(state.adam),
        "generator_state": state.generator.get_state(),
        "generator_device": state.generator.device.type,
        "iteration": state.iteration,
        "binoms": state.binoms.cpu(),
        "densify_count": state.densify_count.cpu(),
        "densify_grad": state.densify_grad.cpu(),
        "aux_params": {k: v.detach().cpu() for k, v in state.aux_params.items()},
        "aux_adam": _adam_to_cpu(state.aux_adam),
        "admm_u": state.admm_u.cpu(),
        "admm_z": state.admm_z.cpu(),
    }
    out = _file(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save(payload, out)


def peek_capacity(path: str | Path) -> int | None:
    """Gaussian capacity stored in a snapshot (rows of its means), or None
    if there is no readable snapshot: lets --resume adopt the grown capacity
    bucket before it restores."""
    try:
        payload = torch.load(_file(path), map_location="cpu", weights_only=True, mmap=True)
        return int(payload["params"]["means"].shape[0])
    except (OSError, KeyError, RuntimeError, ValueError):
        return None


@torch.no_grad()
def load_checkpoint(path: str | Path, template: TrainState) -> TrainState:
    """Restore into `template` (built with the configuration and the
    number of cameras used at save time, at the snapshot's capacity), in
    place; returns it."""
    payload = torch.load(_file(path), map_location="cpu", weights_only=True)
    splats = template.splats
    dev = splats.means.device
    if payload["params"]["means"].shape[0] != splats.capacity:
        raise ValueError(
            f"checkpoint capacity {payload['params']['means'].shape[0]} != template capacity "
            f"{splats.capacity}: grow the template first (train/capacity.py)")
    if payload["generator_device"] != template.generator.device.type:
        raise ValueError(
            f"the snapshot holds a {payload['generator_device']} generator's state; it restores "
            f"only onto a {payload['generator_device']} generator, not onto "
            f"{template.generator.device.type}")
    if payload["aux_params"].keys() != template.aux_params.keys():
        raise ValueError(
            f"the snapshot's components {sorted(payload['aux_params'])} are not the "
            f"configuration's {sorted(template.aux_params)}")
    splats.replace_trainable({k: v.to(dev) for k, v in payload["params"].items()})
    splats.n_active.fill_(payload["n_active"])
    splats.active_sh_degree.fill_(payload["active_sh_degree"])
    splats.max_sh_degree = int(payload["max_sh_degree"])
    splats.scene_scale = float(payload["scene_scale"])
    splats.mark_changed()
    template.adam = _adam_from(payload["adam"], dev)
    template.generator.set_state(payload["generator_state"])
    template.iteration = int(payload["iteration"])
    template.binoms = payload["binoms"].to(dev)
    template.densify_count = payload["densify_count"].to(dev)
    template.densify_grad = payload["densify_grad"].to(dev)
    template.aux_params = {k: v.to(dev) for k, v in payload["aux_params"].items()}
    template.aux_adam = _adam_from(payload["aux_adam"], dev)
    template.admm_u = payload["admm_u"].to(dev)
    template.admm_z = payload["admm_z"].to(dev)
    return template
