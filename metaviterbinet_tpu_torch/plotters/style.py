"""Figure style and per-method visual identity (the JAX package's
plotters/style.py, copied: parity with reference plotters/plotter_config.py:1-14
(rcParams) and plotter_utils.py:14-44 (per-method colors, markers,
linestyles, names)). matplotlib is imported only inside `apply_style`.
"""
from __future__ import annotations

MIN_BER_COEF = 0.2
MARKER_EVERY = 20

COLORS = {
    "ViterbiNet": "green", "LSTM": "green",
    "Joint": "blue", "JointRNN": "blue",
    "Viterbi": "black",
    "OnlineRNN": "red", "OnlineMetaViterbiNet": "red",
}
MARKERS = {
    "ViterbiNet": "d", "LSTM": "d",
    "Joint": "x", "JointRNN": "x",
    "Viterbi": "o",
    "OnlineRNN": ".", "OnlineMetaViterbiNet": ".",
}
LINESTYLES = {
    "ViterbiNet": "solid", "LSTM": "dotted",
    "Joint": "solid", "JointRNN": "dotted",
    "Viterbi": "solid",
    "OnlineRNN": "dotted", "OnlineMetaViterbiNet": "solid",
}
DISPLAY_NAMES = {
    "ViterbiNet": "Online ViterbiNet", "LSTM": "Online LSTM",
    "Joint": "Joint ViterbiNet", "JointRNN": "Joint LSTM",
    "Viterbi": "Viterbi, full CSI",
    "OnlineRNN": "Meta-LSTM", "OnlineMetaViterbiNet": "Meta-ViterbiNet",
}
RC_PARAMS = {
    "xtick.labelsize": 24, "ytick.labelsize": 24,
    "font.size": 15, "figure.autolayout": True,
    "figure.figsize": [9.5, 6.45],
    "axes.titlesize": 28, "axes.labelsize": 28,
    "lines.linewidth": 2, "lines.markersize": 8,
    "legend.fontsize": 20,
    "mathtext.fontset": "stix", "font.family": "STIXGeneral",
}


def apply_style():
    import matplotlib as mpl

    mpl.rcParams.update(RC_PARAMS)
