"""Layered configuration: dataclass defaults <- yaml file <- programmatic overrides.

The same fields, defaults and derived quantities as the JAX package's
`Config` (parity with the reference's flat yaml namespace, python_code/
config.yaml:1-57). The port keeps its own copy so that it imports nothing of
the JAX package. `yaml` is imported only inside `load_config`.

Fields whose mechanism the port does not have yet raise NotImplementedError
when set away from their default, rather than being ignored.
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

# field -> the only value the port runs with until its mechanism is ported
_NOT_PORTED = {
    "mesh_shape": None,
}
COMPUTE_DTYPES = ("float32", "bfloat16")


@dataclass
class Config:
    # general
    run_name: str = "default_run"

    # coding parameters (reference config.yaml:5-6)
    use_ecc: bool = True
    n_symbols: int = 2  # RS parity symbols, 8 bits each

    # channel (reference config.yaml:9-17)
    memory_length: int = 4
    channel_type: str = "ISI_AWGN"
    channel_coefficients: str = "time_decay"  # 'time_decay' | 'cost2100'
    noisy_est_var: float = 0.0
    fading_in_channel: bool = True
    fading_in_decoder: bool = True
    fading_taps_type: int = 1  # 1 = synthetic train channel, 2 = test channel
    subframes_in_frame: int = 25  # first subframe of each frame is a pilot
    gamma: float = 0.2

    # validation (reference config.yaml:20-26)
    val_block_length: int = 120
    val_frames: int = 5
    val_SNR_start: float = 10.0
    val_SNR_end: float = 10.0
    val_SNR_step: float = 1.0
    eval_mode: str = "aggregated"  # 'aggregated' | 'by_word' (online protocol)

    # training (reference config.yaml:29-39)
    train_block_length: int = 120
    train_frames: int = 12
    train_minibatch_num: int = 25
    train_minibatch_size: int = 32
    train_SNR_start: float = 10.0
    train_SNR_end: float = 10.0
    train_SNR_step: float = 1.0
    lr: float = 1e-3
    clip_grad_norm: float = 0.0  # >0 enables global-norm grad clipping
    loss_type: str = "CrossEntropy"  # 'BCE' | 'CrossEntropy' | 'MSE'
    optimizer_type: str = "Adam"  # 'Adam' | 'RMSprop' | 'SGD'

    # seeds (reference config.yaml:40-41)
    noise_seed: int = 3450002
    word_seed: int = 7860002

    # self-supervised online training (reference config.yaml:44-47)
    self_supervised: bool = False
    self_supervised_iterations: int = 200
    ser_thresh: float = 0.02

    # meta-learning (reference config.yaml:50-57)
    online_meta: bool = False
    meta_lr: float = 0.1
    MAML: bool = True
    weights_init: str = "last_frame"  # 'random' | 'last_frame' | 'meta_training'
    window_size: int = 1
    buffer_empty: bool = True
    meta_train_iterations: int = 20
    meta_j_num: int = 10
    meta_subframes: int = 5

    # --- extras of the accelerated packages (no reference counterpart) ---
    dtype: str = "float32"  # the ViterbiNet family's MLP compute dtype:
    # 'bfloat16' runs its products and activations in bf16 for training and
    # the online engine (detectors.py::with_compute_dtype); the ACS and the
    # loss stay f32, and the batch detect kernels round to bf16 either way.
    use_pallas: Optional[bool] = None  # not read by the port: batch detection
    # always goes through the kernel wrappers of kernels/acs.py, which launch
    # the hand-written CUDA kernel for a CUDA tensor and run its plain
    # PyTorch version only for a CPU tensor.
    mesh_shape: Optional[tuple] = None  # not ported yet
    decode_overlap: int = 32  # warm-up overlap of the time-chunked detect
    eval_time_chunks: int = 0  # > 1: the ViterbiNet family's batch detect
    # runs over that many overlap-save time chunks (K4) where T divides and
    # the chunks are at least decode_overlap long; else K1
    # (detectors.py::with_time_chunks).
    eval_two_step: Optional[bool] = None  # changes no result in the port:
    # the JAX kernels' two-step ACS is bit-exact against the one-step one,
    # and the CUDA kernels always run the one-step recursion.
    buffer_capacity: int = 300  # ring-buffer capacity of the online loop
    weights_dir: Optional[str] = None

    def __post_init__(self):
        for name, supported in _NOT_PORTED.items():
            if getattr(self, name) != supported:
                raise NotImplementedError(
                    f"Config.{name}={getattr(self, name)!r} is not supported by "
                    f"the PyTorch port yet (only {supported!r})")
        if self.dtype not in COMPUTE_DTYPES:
            raise ValueError(f"Config.dtype={self.dtype!r}: expected one of {COMPUTE_DTYPES}")
        if self.eval_time_chunks < 0:
            raise ValueError(f"Config.eval_time_chunks={self.eval_time_chunks} must be >= 0")

    # ---- derived quantities ----
    @property
    def n_states(self) -> int:
        return 2 ** self.memory_length

    def transmission_length(self, phase: str) -> int:
        """Codeword length through the channel (reference trainer.py:196-198)."""
        block = self.block_length(phase)
        return block + 8 * self.n_symbols if self.use_ecc else block

    def block_length(self, phase: str) -> int:
        return self.train_block_length if phase == "train" else self.val_block_length

    def n_words(self, phase: str) -> int:
        frames = self.train_frames if phase == "train" else self.val_frames
        return frames * self.subframes_in_frame

    def snr_range(self, phase: str) -> np.ndarray:
        if phase == "train":
            return np.arange(self.train_SNR_start, self.train_SNR_end + 1, step=self.train_SNR_step)
        return np.arange(self.val_SNR_start, self.val_SNR_end + 1, step=self.val_SNR_step)

    def coefficients_for_phase(self, phase: str) -> str:
        """Train phase always uses the synthetic time-decay taps (reference trainer.py:195)."""
        return "time_decay" if phase == "train" else self.channel_coefficients

    def data_indices(self, phase: str = "val") -> np.ndarray:
        """Non-pilot word indices; SER is computed only over these (reference trainer.py:99-102)."""
        idx = np.arange(self.n_words(phase))
        return idx[idx % self.subframes_in_frame != 0]

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)


def load_config(config_path: Optional[str] = None, **overrides) -> Config:
    """Build a Config: dataclass defaults, then yaml file, then overrides (highest wins)."""
    values = {}
    if config_path is not None and os.path.isfile(config_path):
        import yaml

        with open(config_path) as f:
            loaded = yaml.safe_load(f) or {}
        known = {f.name for f in dataclasses.fields(Config)}
        values.update({k: v for k, v in loaded.items() if k in known})
    values.update({k: v for k, v in overrides.items() if v is not None})
    return Config(**values)
