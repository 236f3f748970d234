"""The by-word meta cell alone on the card, timed: meta_vnet at 10 dB on the
type-2 test channel, 300 blocks (chip_smoke.py's phase-5d cell), from a
checkpoint meta-trained on the miss in a temporary weights directory.

    env PYTHONPATH=. python3 scripts/torch_meta_alone.py [--runs 2]

Prints the card's name and power limit, then per run the seconds of
Trainer.evaluate() from a fresh Trainer (host clock to a synchronise, its
graphs' warm-ups and captures included; the same blocks and draws each
run), its host reads, MAML pair steps and gated blocks, and the mean coded
BER over the data blocks; then one JSON line. It needs of the package only
`Trainer` and `OnlineResult`'s `host_reads` and `steps`, so `env
PYTHONPATH=<parent checkout> python3 scripts/torch_meta_alone.py` times an
earlier commit's engine that has them in the same call (run them in turns:
parent, change, change, parent).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
import time

import numpy as np
import torch

from metaviterbinet_tpu_torch import Config
from metaviterbinet_tpu_torch.evaluation.trainer import Trainer


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card)
    runs = []
    with tempfile.TemporaryDirectory() as weights_dir:
        cfg = Config(eval_mode="by_word", fading_taps_type=2, val_frames=12, use_ecc=True,
                     n_symbols=2, val_SNR_start=10.0, val_SNR_end=10.0, train_SNR_start=10.0,
                     train_SNR_end=10.0, weights_dir=weights_dir, self_supervised=True,
                     online_meta=True, weights_init="last_frame")
        Trainer(cfg, "meta_vnet", verbose=False).load_weights(10.0, cfg.gamma)
        for run in range(args.runs):
            trainer = Trainer(cfg, "meta_vnet", verbose=False)
            trainer.load_weights(10.0, cfg.gamma)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sers = trainer.evaluate()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            result = trainer.online_result
            ber = float(np.mean(sers[cfg.data_indices("val")]))
            runs.append({"s": seconds, "host_reads": result.host_reads,
                         "maml_steps": result.steps["maml"], "n_gated": result.n_gated,
                         "mean_data_ber": ber})
            print(f"meta_vnet meta mode alone, run {run + 1}: 300 blocks {seconds:.3f} s, host "
                  f"reads {result.host_reads}, {result.steps['maml']} MAML pair steps, "
                  f"{result.n_gated} gated, mean data BER {ber:.6f} [{card}]")
    print(json.dumps({"card": card, "runs": runs}))


if __name__ == "__main__":
    main()
