"""Command-line interface of the port (the JAX package's cli.py: `train`,
`evaluate`, `sweep`, `bench` and `taps`).

    python -m metaviterbinet_tpu_torch train    --detector vnet --snr 10
    python -m metaviterbinet_tpu_torch evaluate --detector vnet --set eval_time_chunks=4
    python -m metaviterbinet_tpu_torch evaluate --detector va --config weights/config.yaml
    python -m metaviterbinet_tpu_torch sweep    --snrs 7 8 9 10 11 12
    python -m metaviterbinet_tpu_torch taps     --channel cost2100 --fading-type 2
    python -m metaviterbinet_tpu_torch bench

Any Config field can be overridden with --set key=value; `train`, `evaluate`
and `taps` read them over the values of a --config file (the port's
config.yaml or a provenance written by either package). A sweep's Config is
the paper's protocol (plotters.experiments.sweep_config) with only --set
over it, as in the JAX CLI, which never applies --config to a sweep; here
`sweep` takes no --config. `train`, `evaluate`, `sweep` and `bench` run on
the card unless --device cpu is given; `taps` computes the taps on the CPU.
`sweep` and `taps` render figures with matplotlib and fail before any work
where it is missing. `bench` prints the card's line and the JSON line of
metaviterbinet_tpu_torch/bench.py.
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
    if getattr(args, "snr", None) is not None:
        overrides.update(val_SNR_start=args.snr, val_SNR_end=args.snr,
                         train_SNR_start=args.snr, train_SNR_end=args.snr)
    if getattr(args, "eval_mode", None):
        overrides["eval_mode"] = args.eval_mode
    if getattr(args, "weights_dir", None):
        overrides["weights_dir"] = args.weights_dir
    return load_config(args.config, **overrides)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="metaviterbinet_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    def add_set(p):
        p.add_argument("--set", nargs="*", metavar="KEY=VALUE",
                       help="override any Config field")

    def add_common(p):
        p.add_argument("--config", default=None, help="yaml config path")
        add_set(p)

    def add_device(p):
        p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                       help="run on the card (default) or on the CPU")

    def add_point(p):
        add_common(p)
        add_device(p)
        p.add_argument("--snr", type=float, default=None,
                       help="pin train+val SNR to one value")
        p.add_argument("--weights-dir", default=None)
        p.add_argument("--detector", choices=sorted(DETECTORS), required=True)

    add_point(sub.add_parser("train", help="offline (meta-)training"))
    p_eval = sub.add_parser("evaluate", help="aggregated or by-word evaluation")
    add_point(p_eval)
    p_eval.add_argument("--eval-mode", choices=["aggregated", "by_word"], default=None)

    p_sweep = sub.add_parser("sweep", help="full SNR sweep over all curves")
    add_set(p_sweep)
    add_device(p_sweep)
    p_sweep.add_argument("--snrs", type=float, nargs="+", default=[7, 8, 9, 10, 11, 12])
    p_sweep.add_argument("--channel", default="cost2100", choices=["cost2100", "time_decay"])
    p_sweep.add_argument("--run-over", action="store_true")
    p_sweep.add_argument("--by-block", action="store_true")

    add_device(sub.add_parser("bench", help="run the headline benchmark"))

    p_taps = sub.add_parser(
        "taps", help="plot channel tap trajectories (reference channel_estimation.py:52-70)")
    add_common(p_taps)
    p_taps.add_argument("--channel", default="time_decay", choices=["cost2100", "time_decay"])
    p_taps.add_argument("--fading-type", type=int, default=1, choices=[1, 2])
    p_taps.add_argument("--blocks", type=int, default=300)

    args = parser.parse_args(argv)

    if args.command == "bench":
        from metaviterbinet_tpu_torch import bench
        bench.main(device=args.device)
        return 0

    if args.command == "taps":
        from metaviterbinet_tpu_torch.plotters.figures import plot_tap_trajectories
        cfg = _build_config(args)
        path = plot_tap_trajectories(
            memory_length=cfg.memory_length, gamma=cfg.gamma,
            channel_coefficients=args.channel,
            fading_taps_type=args.fading_type, n_blocks=args.blocks,
            fading=cfg.fading_in_channel,
        )
        print(json.dumps({"figure": path}))
        return 0

    if args.command == "sweep":
        from metaviterbinet_tpu_torch.plotters.experiments import run_sweep
        all_curves, fig = run_sweep(
            snrs=args.snrs, channel_coefficients=args.channel,
            run_over=args.run_over, plot_by_block_flag=args.by_block,
            device=args.device, **_parse_set_overrides(args.set),
        )
        print(json.dumps({
            "curves": [
                {"method": name, "mean_ser": float(sum(ser) / len(ser))}
                for ser, name, _, _ in all_curves
            ],
            "figure": fig,
        }))
        return 0

    from metaviterbinet_tpu_torch.evaluation.trainer import Trainer

    cfg = _build_config(args)
    trainer = Trainer(cfg, args.detector, device=args.device)
    if args.command == "train":
        trainer.train()
        print(json.dumps({"status": "trained", "weights_dir": trainer.weights_dir}))
    else:
        sers = trainer.evaluate()
        out = {"detector": args.detector, "eval_mode": cfg.eval_mode,
               "mean_ser": float(sers.mean()), "n_points": len(sers)}
        if cfg.eval_mode == "by_word":
            # the paper's metric (the mean over the data blocks, pilots
            # excluded), the engine's steps and the SER of each block
            out["mean_data_ser"] = float(sers[cfg.data_indices("val")].mean())
            out["steps"] = trainer.online_result.steps
            out["ser_by_word"] = sers.tolist()
        print(json.dumps(out))
    return 0
