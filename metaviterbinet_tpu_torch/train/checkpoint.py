"""Checkpoints keyed by (snr, gamma) with the reference's naming scheme
(reference trainer.py:507-532: snr_{snr}_gamma_{gamma}.pt).

The payload mirrors the reference artifact {model_state_dict,
optimizer_state_dict, loss}: the parameter dict, the optimizer state
(moments and step count) and the loss, through torch.save / torch.load
(tensors, dicts, numbers only: loaded with weights_only=True). Evaluation
restores the params alone, as the reference does (trainer.py:526-528).

Beside the checkpoints, `config.yaml` records the resolved config (the
reference copies its config there, trainer.py:132). It is written without
`yaml`: the config is flat, and each line `key: <JSON value>` is YAML, but
for floats, which are written as PyYAML writes them (1.0e-05, not JSON's
1e-05, which YAML 1.1 reads as a string).

Where a weights dir holds no `.pt` for a point, `load_checkpoint` reads the
JAX package's `snr_{snr}_gamma_{gamma}.msgpack` (flax's msgpack of
{"params", "loss", "opt_state"}) through the port's own decoder
(train/msgpack.py): the params are the JAX names in their [out, in] layout,
and optax's Adam state (a chain's state as a map "0", "1", ..., with
{"count", "mu", "nu"} at its Adam entry) becomes an OptState.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

import numpy as np
import torch

from metaviterbinet_tpu_torch.train import msgpack
from metaviterbinet_tpu_torch.train.optim import OptState
from metaviterbinet_tpu_torch.weights import adam_state_from_jax


def ckpt_path(weights_dir: str, snr: float, gamma: float, suffix: str = ".pt") -> str:
    """The checkpoint of (snr, gamma): the port's (.pt) or the JAX package's
    (suffix=".msgpack")."""
    return os.path.join(weights_dir, f"snr_{snr}_gamma_{gamma}{suffix}")


def _yaml_value(v: Any) -> str:
    """A flat config value as YAML 1.1: JSON, but floats in PyYAML's form."""
    if isinstance(v, float):
        if v != v or v in (float("inf"), float("-inf")):
            return {"nan": ".nan", "inf": ".inf", "-inf": "-.inf"}[repr(v)]
        text = repr(v).lower()
        return text.replace("e", ".0e", 1) if "." not in text and "e" in text else text
    return json.dumps(v)


def save_config_provenance(weights_dir: str, cfg: Any) -> str:
    """Write the resolved config into the weights dir once; an existing file
    is left untouched, so it records the config of the first checkpoint."""
    os.makedirs(weights_dir, exist_ok=True)
    path = os.path.join(weights_dir, "config.yaml")
    if not os.path.isfile(path):
        lines = [f"{k}: {_yaml_value(v)}" for k, v in dataclasses.asdict(cfg).items()]
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
        # the count as a host int: one read, when the checkpoint is written
        payload["opt_state"] = {"count": int(opt_state.count), "mu": _cpu(opt_state.mu),
                                "nu": _cpu(opt_state.nu)}
    torch.save(payload, path)
    return path


def _jax_opt_state(tree: dict, device: torch.device) -> OptState:
    """The moments and count of an optax state dict: the entry of the chain
    (a map "0", "1", ...) that holds "nu" (Adam's or RMSprop's), else an empty
    state (SGD)."""
    if "nu" in tree:
        return adam_state_from_jax(tree.get("mu", {}), tree["nu"], tree.get("count", 0), device)
    for sub in tree.values():
        if isinstance(sub, dict) and sub:
            return _jax_opt_state(sub, device)
    return OptState(count=torch.zeros((), dtype=torch.int32, device=device))


def _load_jax(path: str, device: torch.device) -> dict:
    with open(path, "rb") as f:
        raw = msgpack.unpackb(f.read())
    out = {"params": {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
                      for k, v in raw["params"].items()},
           "loss": float(raw.get("loss", 0.0))}
    if "opt_state" in raw:
        out["opt_state"] = _jax_opt_state(raw["opt_state"], device)
    return out


def load_checkpoint(weights_dir: str, snr: float, gamma: float,
                    device: str | torch.device) -> Optional[dict]:
    """The checkpoint's payload with its tensors on `device`, or None when
    there is none: {"params": dict, "loss": float, "opt_state": OptState}
    (no "opt_state" when none was saved). The port's .pt first; else the JAX
    package's .msgpack of the same point."""
    path = ckpt_path(weights_dir, snr, gamma)
    if not os.path.isfile(path):
        jax_path = ckpt_path(weights_dir, snr, gamma, ".msgpack")
        return _load_jax(jax_path, torch.device(device)) if os.path.isfile(jax_path) else None
    raw = torch.load(path, map_location=device, weights_only=True)
    if "opt_state" in raw:
        state = raw["opt_state"]
        raw["opt_state"] = OptState(
            count=torch.tensor(state["count"], dtype=torch.int32, device=device),
            mu=state["mu"], nu=state["nu"])
    return raw
