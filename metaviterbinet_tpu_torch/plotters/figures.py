"""Figure renderers (the JAX package's plotters/figures.py; parity with
reference plotter_utils.py:68-140): running-mean coded BER vs block index,
mean coded BER vs SNR, and the channel's tap trajectories.

matplotlib is imported only inside the renderers. The card's machine has
none, so a sweep there builds its curves into the cache (build_curve) and
the figures are rendered where matplotlib exists; `require_matplotlib` lets
a caller that will render fail before it computes anything. Figures go to the port's FIGURES_DIR (results/torch_figures).
"""
from __future__ import annotations

import datetime
import math
import os
from typing import List, Tuple

import numpy as np
import torch

from metaviterbinet_tpu_torch.ops.channel import estimate_channel_batch
from metaviterbinet_tpu_torch.paths import FIGURES_DIR
from metaviterbinet_tpu_torch.plotters.style import (
    COLORS, DISPLAY_NAMES, LINESTYLES, MARKERS, MARKER_EVERY, MIN_BER_COEF,
    apply_style,
)

Curve = Tuple[np.ndarray, str, int, int]  # (ser, method_name, block_len, n_symbols)


def require_matplotlib() -> None:
    """Raise RuntimeError unless matplotlib can be imported."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            "matplotlib is not installed, so no figure can be rendered here: build the curves "
            "into the cache with plotters.experiments.build_curve, and render them where "
            "matplotlib exists") from e


def _pyplot(show: bool):
    require_matplotlib()
    import matplotlib
    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _figure_dir() -> str:
    now = datetime.datetime.now()
    folder = f"{now.month}-{now.day}-{now.hour}-{now.minute}"
    path = os.path.join(FIGURES_DIR, folder)
    os.makedirs(path, exist_ok=True)
    return path


def plot_by_block(all_curves: List[Curve], val_block_length: int,
                  n_symbol: int, snr: float, show: bool = False) -> str:
    """Running-mean coded BER vs block index, log-y (plotter_utils.py:68-104)."""
    plt = _pyplot(show)
    apply_style()
    out_dir = _figure_dir()
    plt.figure()
    min_ber = math.inf
    max_block = 1
    for ser, method_name, _, _ in all_curves:
        key = method_name.split(" ")[0]
        block_range = np.arange(1, len(ser) + 1)
        agg = np.cumsum(ser) / block_range
        plt.plot(block_range, agg, label=DISPLAY_NAMES[key], color=COLORS[key],
                 marker=MARKERS[key], linestyle=LINESTYLES[key], linewidth=2.2,
                 markevery=MARKER_EVERY)
        min_ber = min(min_ber, agg[-1])
        max_block = max(max_block, len(ser))
    plt.ylabel("Coded BER")
    plt.xlabel("Block Index")
    plt.xlim([0.9, max_block + 0.1])
    if min_ber > 0:
        plt.ylim(bottom=MIN_BER_COEF * min_ber)
    plt.yscale("log")
    plt.legend(loc="upper left", prop={"size": 15})
    path = os.path.join(
        out_dir, f"SNR {snr}, Block Length {val_block_length}, "
                 f"Error symbols {n_symbol}.png")
    plt.savefig(path, bbox_inches="tight")
    if show:
        plt.show()
    plt.close()
    return path


def plot_tap_trajectories(memory_length: int = 4, gamma: float = 0.2,
                          channel_coefficients: str = "time_decay",
                          fading_taps_type: int = 1, n_blocks: int = 300,
                          fading: bool = True, show: bool = False) -> str:
    """Per-tap magnitude over block index: the reference's visual-inspection
    smoke test of the channel generator (channel_estimation.py:52-70). The
    taps are data, computed on the CPU."""
    plt = _pyplot(show)
    h = estimate_channel_batch(
        memory_length, gamma, torch.arange(n_blocks),
        channel_coefficients=channel_coefficients,
        fading=fading, fading_taps_type=fading_taps_type,
    ).numpy()
    apply_style()
    out_dir = _figure_dir()
    plt.figure()
    for tap in range(memory_length):
        plt.plot(np.arange(n_blocks), h[:, tap], label=f"h{tap}", linewidth=2.2)
    plt.xlabel("Block Index")
    plt.ylabel("Tap magnitude")
    plt.legend(loc="upper right", prop={"size": 15})
    path = os.path.join(
        out_dir, f"taps_{channel_coefficients}_type{fading_taps_type}.png")
    plt.savefig(path, bbox_inches="tight")
    if show:
        plt.show()
    plt.close()
    return path


def plot_ber_vs_snr(all_curves: List[Curve], snr_values: List[float],
                    show: bool = False) -> str:
    """Mean coded BER vs SNR, log-y (plotter_utils.py:107-140)."""
    plt = _pyplot(show)
    apply_style()
    out_dir = _figure_dir()
    plt.figure()
    names: List[str] = []
    for _, name, _, _ in all_curves:
        if name not in names:
            names.append(name)
    for method_name in names:
        key = method_name.split(" ")[0]
        mean_sers = [float(np.mean(ser)) for ser, nm, _, _ in all_curves
                     if nm == method_name]
        plt.plot(snr_values[: len(mean_sers)], mean_sers,
                 label=DISPLAY_NAMES[key], color=COLORS[key],
                 marker=MARKERS[key], linestyle=LINESTYLES[key], linewidth=2.2)
    plt.xticks(snr_values, snr_values)
    plt.xlabel("SNR [dB]")
    plt.ylabel("Coded BER")
    plt.grid(which="both", ls="--")
    plt.legend(loc="lower left", prop={"size": 15})
    plt.yscale("log")
    path = os.path.join(out_dir, "coded_ber_versus_snr.png")
    plt.savefig(path, bbox_inches="tight")
    if show:
        plt.show()
    plt.close()
    return path
