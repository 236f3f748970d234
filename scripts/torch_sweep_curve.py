"""One curve of the port's sweep at one SNR on the card, against its band.

    env PYTHONPATH=. python3 scripts/torch_sweep_curve.py --curve OnlineRNN --snr 11

Runs `plotters.experiments.build_curve` for the curve over
`sweep_config(snr, 120, 2, "cost2100")` (300 blocks of 120 info bits + RS
nsym=2 on the COST2100 test channel, train-on-miss on the time-decay train
channel), in temporary weights and cache directories, as chip_smoke.py's
phase 5c does for six of the seven curves at 8 dB. Prints the card's name
and power limit, the mean coded BER over the 288 data blocks beside the
reference's parity-matrix cell for the curve's detector and mode at that
SNR where there is one (resources/reference_baselines.json) and the JAX
package's curve value (resources/sweep_cost2100.json, a mean over all 300
blocks), the seconds, the gated blocks, the kernels' launches and the
graphed calls, then one JSON line. OnlineRNN (meta_lstm) at 8 dB has no
band, so chip_smoke.py leaves it out; its 300 blocks take ~10 minutes on
the card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from metaviterbinet_tpu_torch.paths import RESOURCES_DIR
from metaviterbinet_tpu_torch.plotters import experiments

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

# the parity-matrix cell of each curve (tests/test_parity_anchor.py's band)
CELLS = {"Viterbi - Full CSI": ("va_joint_cost2100", 0.005),
         "Joint ViterbiNet": ("vnet_joint_cost2100", 0.012),
         "ViterbiNet": ("vnet_online_cost2100", 0.012),
         "OnlineMetaViterbiNet": ("meta_vnet_meta_cost2100", 0.012),
         "JointRNN": ("lstm_joint_cost2100", 0.012),
         "LSTM": ("lstm_online_cost2100", 0.012),
         "OnlineRNN": ("meta_lstm_meta_cost2100", 0.012)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--curve", required=True, choices=sorted(CELLS))
    parser.add_argument("--snr", type=float, required=True)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_sweep_curve: no CUDA device", file=sys.stderr)
        return 1
    card = smoke.card_line()
    print(card)
    spec = {c.method_name: c for c in experiments.CURVES}[args.curve]
    cfg = experiments.sweep_config(args.snr, 120, 2, "cost2100")
    di = cfg.data_indices("val")
    _, cells = smoke.reference_baselines()
    cell, tol = CELLS[args.curve]
    point = cells.get(cell, {}).get("points", {}).get(str(args.snr))
    ref = float(np.mean(point["ref"])) if point else None
    with open(os.path.join(RESOURCES_DIR, "sweep_cost2100.json")) as f:
        jax_sweep = json.load(f)
    jax_ber = (jax_sweep["mean_coded_ber"][args.curve][jax_sweep["snrs_db"].index(args.snr)]
               if args.snr in jax_sweep["snrs_db"] else None)

    with tempfile.TemporaryDirectory() as root, smoke.harness_dirs(root) as trainers:
        smoke.zero_launches()
        smoke.zero_steps()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ser = experiments.build_curve(spec, cfg, run_over=True, verbose=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        result = trainers[-1].online_result
    launches, steps = smoke.read_launches(), smoke.read_steps()
    mean_ber = float(np.mean(ser[di]))
    inside = None if ref is None else abs(mean_ber - ref) <= tol
    band = f"reference {ref:.6f} +- {tol} ({cell})" if ref is not None else "no reference band"
    print(f"{args.curve} ({spec.detector}) at {args.snr:g} dB on COST2100: mean coded BER over "
          f"the {len(di)} data blocks {mean_ber:.6f} ({band}; inside {inside}); over all "
          f"{len(ser)} blocks {float(np.mean(ser)):.6f} (the JAX package's curve: {jax_ber}); "
          f"{seconds:.1f} s with train-on-miss; {result.n_gated} gated blocks; steps "
          f"{result.steps}; launches {launches} [{card}]")
    print(f"graphed calls: {smoke.steps_line(steps, None)}")
    if ser.shape != (cfg.n_words("val"),) or not np.all((ser >= 0) & (ser <= 1)):
        print(f"the curve is not {cfg.n_words('val')} SERs in [0, 1]", file=sys.stderr)
        return 1
    print(json.dumps({"curve": args.curve, "snr_db": args.snr, "mean_data_ber": mean_ber,
                      "mean_ber_300": float(np.mean(ser)), "reference": ref, "band": tol,
                      "inside_band": inside, "jax_package_ber_300": jax_ber, "s": seconds,
                      "n_gated": result.n_gated, "steps": result.steps, "launches": launches,
                      "graphed_calls": steps, "ser_by_word": ser.tolist(), "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
