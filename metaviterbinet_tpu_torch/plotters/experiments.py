"""Experiment harness (the JAX package's plotters/experiments.py): the
reference's seven curves and SNR sweep (plotter_main.py:12-156) on top of
the port's Trainer.

Each curve is (detector spec, online flags, weights-dir naming convention):
the reference's five trainer classes with kwargs-grids collapse to rows of
the CURVES table. Every curve is a by-word run of 300 blocks; `build_curve`
and `run_sweep` run it on the card unless given device="cpu". Checkpoints
go to the port's WEIGHTS_DIR and curves to its PLOTS_DIR.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from metaviterbinet_tpu_torch.config import Config
from metaviterbinet_tpu_torch.evaluation.trainer import Trainer
from metaviterbinet_tpu_torch.paths import WEIGHTS_DIR
from metaviterbinet_tpu_torch.plotters.cache import get_ser_curve
from metaviterbinet_tpu_torch.plotters.figures import (
    plot_ber_vs_snr, plot_by_block, require_matplotlib)


@dataclass(frozen=True)
class CurveSpec:
    method_name: str          # plot key (plotter_utils METHOD_NAMES key space)
    detector: str             # DetectorSpec name
    self_supervised: bool
    online_meta: bool
    weights_prefix: str       # reference weights-dir naming convention


# the seven curves of plotter_main.py:12-93, in sweep order (:143-149)
CURVES: List[CurveSpec] = [
    CurveSpec("Joint ViterbiNet", "vnet", False, False, "training"),
    CurveSpec("JointRNN", "lstm", False, False, "rnn_training"),
    CurveSpec("ViterbiNet", "vnet", True, False, "training"),
    CurveSpec("LSTM", "lstm", True, False, "rnn_training"),
    CurveSpec("OnlineMetaViterbiNet", "meta_vnet", True, True, "meta_training"),
    CurveSpec("OnlineRNN", "meta_lstm", True, True, "rnn_meta_training"),
    CurveSpec("Viterbi - Full CSI", "va", False, False, "training"),
]


def sweep_config(snr: float, val_block_length: int = 120, n_symbols: int = 2,
                 channel_coefficients: str = "cost2100", **overrides) -> Config:
    """The reference sweep's HYPERPARAMS_DICT (plotter_main.py:96-111,130-138)."""
    base = dict(
        val_SNR_step=2.0, train_SNR_step=2.0, noisy_est_var=0.0,
        fading_taps_type=2, fading_in_decoder=True, use_ecc=True, gamma=0.2,
        channel_type="ISI_AWGN", val_frames=12, subframes_in_frame=25,
        eval_mode="by_word", self_supervised_iterations=200, ser_thresh=0.02,
        buffer_empty=True, weights_init="last_frame",
        n_symbols=n_symbols,
        val_SNR_start=snr, val_SNR_end=snr,
        train_SNR_start=snr, train_SNR_end=snr,
        val_block_length=val_block_length, train_block_length=val_block_length,
        fading_in_channel=(channel_coefficients == "time_decay"),
        channel_coefficients=channel_coefficients,
    )
    base.update(overrides)
    return Config(**base)


def build_curve(spec: CurveSpec, cfg: Config, run_over: bool = False,
                verbose: bool = True, device: str = "cuda") -> np.ndarray:
    """The curve's SER per block: from the cache, or a by-word run of the
    spec's detector on `device` (training its checkpoint on a miss)."""
    cfg = cfg.replace(self_supervised=spec.self_supervised,
                      online_meta=spec.online_meta)
    weights_dir = os.path.join(
        WEIGHTS_DIR,
        f"{spec.weights_prefix}_{cfg.val_block_length}_{cfg.n_symbols}_channel1",
    )
    trainer = Trainer(cfg, spec.detector, device=device, weights_dir=weights_dir,
                      verbose=verbose)
    current_params = (f"{cfg.channel_coefficients}_{cfg.val_SNR_start}_"
                      f"{cfg.val_block_length}_{cfg.n_symbols}")
    return get_ser_curve(trainer, run_over, spec.method_name + "_" + current_params)


def run_sweep(
    snrs: Sequence[float] = (7, 8, 9, 10, 11, 12),
    val_block_length: int = 120,
    n_symbols: int = 2,
    channel_coefficients: str = "cost2100",
    curves: Optional[Sequence[CurveSpec]] = None,
    run_over: bool = False,
    plot_by_block_flag: bool = False,
    device: str = "cuda",
    **overrides,
):
    """The reference's main sweep (plotter_main.py:113-156): per SNR build all
    curves (pkl-cached), then render BER-vs-SNR (or per-SNR BER-vs-block).
    Without matplotlib it raises before the first curve; there, build the
    curves into the cache with build_curve."""
    require_matplotlib()
    curves = list(curves) if curves is not None else CURVES
    all_curves = []
    for snr in snrs:
        cfg = sweep_config(float(snr), val_block_length, n_symbols,
                           channel_coefficients, **overrides)
        for spec in curves:
            ser = build_curve(spec, cfg, run_over=run_over, device=device)
            all_curves.append((ser, spec.method_name, val_block_length, n_symbols))
        if plot_by_block_flag:
            per_snr = all_curves[-len(curves):]
            plot_by_block(per_snr, val_block_length, n_symbols, float(snr))
    fig = None
    if not plot_by_block_flag:
        fig = plot_ber_vs_snr(all_curves, list(snrs))
    return all_curves, fig
