"""SER-curve result cache (the JAX package's plotters/cache.py; parity with
reference plotter_utils.get_ser_plot, plotter_utils.py:47-65): each method's
SER vector is pickled per method + params key, so that a sweep resumes for
free; `run_over=True` recomputes.

The files have the JAX package's names, under the port's own PLOTS_DIR
(results/torch_plots): a curve the JAX package cached is never handed back
as one the port computed.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from metaviterbinet_tpu_torch.paths import PLOTS_DIR


def save_pkl(path: str, obj):
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load_pkl(path: str):
    """Unpickles: read only files this cache wrote."""
    with open(path, "rb") as f:
        return pickle.load(f)


def get_ser_curve(trainer, run_over: bool, method_name: str) -> np.ndarray:
    """The trainer's SER curve from <method_name>_<channel_type>.pkl in
    PLOTS_DIR, or from trainer.evaluate() (then written there) when there is
    none or `run_over`."""
    os.makedirs(PLOTS_DIR, exist_ok=True)
    file_name = "_".join([method_name, str(trainer.cfg.channel_type)])
    plots_path = os.path.join(PLOTS_DIR, file_name + ".pkl")
    if os.path.isfile(plots_path) and not run_over:
        return np.asarray(load_pkl(plots_path))
    ser = np.asarray(trainer.evaluate())
    save_pkl(plots_path, ser)
    return ser
