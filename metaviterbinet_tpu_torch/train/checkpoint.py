"""Checkpoints keyed by (snr, gamma) with the reference's naming scheme
(reference trainer.py:507-532: snr_{snr}_gamma_{gamma}.pt).

The payload mirrors the reference artifact {model_state_dict,
optimizer_state_dict, loss}: the parameter dict, the optimizer state
(moments and step count) and the loss, through torch.save / torch.load
(tensors, dicts, numbers only: loaded with weights_only=True). Evaluation
restores the params alone, as the reference does (trainer.py:526-528).

Beside the checkpoints, `config.yaml` records the resolved config (the
reference copies its config there, trainer.py:132). It is written without
`yaml`: the config is flat, and each line `key: <JSON value>` is YAML.
The JAX package's `.msgpack` checkpoints are not read here.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

import torch

from metaviterbinet_tpu_torch.train.optim import OptState


def ckpt_path(weights_dir: str, snr: float, gamma: float) -> str:
    return os.path.join(weights_dir, f"snr_{snr}_gamma_{gamma}.pt")


def save_config_provenance(weights_dir: str, cfg: Any) -> str:
    """Write the resolved config into the weights dir once; an existing file
    is left untouched, so it records the config of the first checkpoint."""
    os.makedirs(weights_dir, exist_ok=True)
    path = os.path.join(weights_dir, "config.yaml")
    if not os.path.isfile(path):
        lines = [f"{k}: {json.dumps(v)}" for k, v in dataclasses.asdict(cfg).items()]
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
    return path


def _cpu(tensors: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def save_params(weights_dir: str, snr: float, gamma: float, params: dict[str, torch.Tensor],
                loss: float = 0.0, opt_state: Optional[OptState] = None) -> str:
    os.makedirs(weights_dir, exist_ok=True)
    path = ckpt_path(weights_dir, snr, gamma)
    payload = {"params": _cpu(params), "loss": float(loss)}
    if opt_state is not None:
        payload["opt_state"] = {"count": int(opt_state.count), "mu": _cpu(opt_state.mu),
                                "nu": _cpu(opt_state.nu)}
    torch.save(payload, path)
    return path


def load_checkpoint(weights_dir: str, snr: float, gamma: float,
                    device: str | torch.device) -> Optional[dict]:
    """The checkpoint's payload with its tensors on `device`, or None when
    there is none: {"params": dict, "loss": float, "opt_state": OptState}
    (no "opt_state" when none was saved)."""
    path = ckpt_path(weights_dir, snr, gamma)
    if not os.path.isfile(path):
        return None
    raw = torch.load(path, map_location=device, weights_only=True)
    if "opt_state" in raw:
        raw["opt_state"] = OptState(**raw["opt_state"])
    return raw
