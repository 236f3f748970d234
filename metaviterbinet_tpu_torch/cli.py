"""Command-line interface of the port (the JAX package's cli.py, for its
`train` and `evaluate` commands).

    python -m metaviterbinet_tpu_torch train    --detector vnet --snr 10
    python -m metaviterbinet_tpu_torch evaluate --detector vnet --set eval_time_chunks=4
    python -m metaviterbinet_tpu_torch evaluate --detector va --device cpu

Any Config field can be overridden with --set key=value. Runs on the card
unless --device cpu is given. `sweep`, `taps` and `bench` are not ported.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import json

from metaviterbinet_tpu_torch.config import Config, load_config
from metaviterbinet_tpu_torch.detectors import DETECTORS


def _parse_set_overrides(pairs):
    fields = {f.name for f in dataclasses.fields(Config)}
    out = {}
    for pair in pairs or []:
        key, _, raw = pair.partition("=")
        if key not in fields:
            raise SystemExit(f"unknown config field: {key}")
        current = getattr(Config(), key)
        if isinstance(current, bool):
            out[key] = raw.lower() in ("1", "true", "yes")
        elif isinstance(current, int):
            out[key] = int(raw)
        elif isinstance(current, float):
            out[key] = float(raw)
        elif current is None:
            # Optional fields (use_pallas tri-state, mesh_shape tuple,
            # weights_dir str): bool words, then python literals, else the string
            if raw.lower() in ("true", "false"):
                out[key] = raw.lower() == "true"
            else:
                try:
                    out[key] = ast.literal_eval(raw)
                except (ValueError, SyntaxError):
                    out[key] = raw
        else:
            out[key] = raw
    return out


def _build_config(args) -> Config:
    overrides = _parse_set_overrides(args.set)
    if args.snr is not None:
        overrides.update(val_SNR_start=args.snr, val_SNR_end=args.snr,
                         train_SNR_start=args.snr, train_SNR_end=args.snr)
    if getattr(args, "eval_mode", None):
        overrides["eval_mode"] = args.eval_mode
    if args.weights_dir:
        overrides["weights_dir"] = args.weights_dir
    return load_config(args.config, **overrides)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="metaviterbinet_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    def add_common(p):
        p.add_argument("--config", default=None, help="yaml config path")
        p.add_argument("--set", nargs="*", metavar="KEY=VALUE",
                       help="override any Config field")
        p.add_argument("--snr", type=float, default=None,
                       help="pin train+val SNR to one value")
        p.add_argument("--weights-dir", default=None)
        p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                       help="run on the card (default) or on the CPU")
        p.add_argument("--detector", choices=sorted(DETECTORS), required=True)

    add_common(sub.add_parser("train", help="offline (meta-)training"))
    p_eval = sub.add_parser("evaluate", help="aggregated or by-word evaluation")
    add_common(p_eval)
    p_eval.add_argument("--eval-mode", choices=["aggregated", "by_word"], default=None)

    args = parser.parse_args(argv)

    from metaviterbinet_tpu_torch.evaluation.trainer import Trainer

    cfg = _build_config(args)
    trainer = Trainer(cfg, args.detector, device=args.device)
    if args.command == "train":
        trainer.train()
        print(json.dumps({"status": "trained", "weights_dir": trainer.weights_dir}))
    else:
        sers = trainer.evaluate()
        print(json.dumps({
            "detector": args.detector, "eval_mode": cfg.eval_mode,
            "mean_ser": float(sers.mean()), "n_points": len(sers),
        }))
    return 0
