"""Path registry of the PyTorch port (parity with reference dir_definitions.py:3-12).

The port reads the repository's data files under `resources/` (the COST2100
traces, the recorded reference baselines); they are data, shared with the
JAX package.
"""
import os

ROOT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODE_DIR = os.path.join(ROOT_DIR, "metaviterbinet_tpu_torch")
RESOURCES_DIR = os.path.join(ROOT_DIR, "resources")
RESULTS_DIR = os.path.join(ROOT_DIR, "results")
# the port's checkpoints (.pt), curve cache and figures, apart from the JAX
# package's results/{weights,plots,figures}: a curve cached by the JAX
# package must never be read back as one the port computed
WEIGHTS_DIR = os.path.join(RESULTS_DIR, "torch_weights")
PLOTS_DIR = os.path.join(RESULTS_DIR, "torch_plots")
FIGURES_DIR = os.path.join(RESULTS_DIR, "torch_figures")
COST2100_DIR = os.path.join(RESOURCES_DIR, "cost2100_channel")
CONFIG_PATH = os.path.join(CODE_DIR, "config.yaml")
