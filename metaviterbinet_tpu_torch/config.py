"""Layered configuration: dataclass defaults <- yaml file <- programmatic overrides.

The same fields, defaults and derived quantities as the JAX package's
`Config` (parity with the reference's flat yaml namespace, python_code/
config.yaml:1-57). The port keeps its own copy so that it imports nothing of
the JAX package. Config files are read by `parse_flat_yaml`, so that the
port needs no `yaml`: its dependencies are torch, numpy and scipy (and
triton on the card), the packages the card's machine is set up with.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from dataclasses import dataclass
from typing import Optional

import numpy as np

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
    mesh_shape: Optional[tuple] = None  # batch detection words-sharded over
    # a 'dp' mesh of prod(mesh_shape) ranks, one per device
    # (parallel/decode.py::shard_words_decode); the by-word engine stays on
    # one device.
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


# PyYAML's implicit types of a plain scalar (YAML 1.1, yaml/resolver.py), so
# that a value reads as yaml.safe_load reads it: "1e-3" has no dot and stays
# a string there, "1.0e-03" is a float
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = {w: w.lower() in ("yes", "true", "on")
         for w in "yes Yes YES no No NO true True TRUE false False FALSE on On ON off Off OFF".split()}
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
# the implicit types the reader does not construct: binary, octal, hex and
# sexagesimal numbers, timestamps, merge keys and the value key
_UNSUPPORTED = re.compile(r"^(?:[-+]?0(?:b[0-1_]+|[0-7_]+|x[0-9a-fA-F_]+)"
                          r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
                          r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt \t].*)?|<<|=)$")
_KEY = re.compile(r"^([A-Za-z_][A-Za-z0-9_]*)[ \t]*:(?:[ \t]+(.*))?$")
_ITEM = re.compile(r"^[ \t]*-(?:[ \t]+(.*))?$")


def _plain(text: str, where: str):
    """A plain scalar as PyYAML resolves it."""
    if _NULL.match(text):
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _UNSUPPORTED.match(text) or ": " in text or text.endswith(":"):
        raise ValueError(f"{where}: unsupported value {text!r}")
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        digits = text.replace("_", "").lower()
        return float(digits.replace(".inf", "inf").replace(".nan", "nan"))
    return text


def _scalar(text: str, where: str):
    """A value: a double- or single-quoted string or a plain scalar, with an
    optional trailing comment. Returns (value, the text after it)."""
    if text[:1] == '"':
        end = 1
        while end < len(text) and text[end] != '"':
            end += 2 if text[end] == "\\" else 1
        try:
            value = json.loads(text[:end + 1])
        except json.JSONDecodeError as e:
            raise ValueError(f"{where}: bad double-quoted string") from e
        return value, text[end + 1:]
    if text[:1] == "'":
        m = re.match(r"'((?:[^']|'')*)'", text)
        if m is None:
            raise ValueError(f"{where}: unterminated single-quoted string")
        return m.group(1).replace("''", "'"), text[m.end():]
    if text[:1] and text[0] in "{[]}&*!|>%@`,?":
        raise ValueError(f"{where}: unsupported YAML ({text!r})")
    m = re.search(r"[ \t]#", text)
    plain, rest = (text[:m.start()], text[m.start():]) if m else (text, "")
    return _plain(plain.strip(), where), rest


def _value(text: str, where: str):
    """A key's value: a scalar or a flow sequence of scalars (as a tuple)."""
    if text[:1] == "[":
        close = text.find("]")
        if close < 0 or "[" in text[1:close]:
            raise ValueError(f"{where}: unsupported flow sequence")
        inner, rest = text[1:close].strip(), text[close + 1:]
        items = [_scalar(item.strip(), where) for item in inner.split(",")] if inner else []
        if any(tail.strip() for _, tail in items):
            raise ValueError(f"{where}: unsupported flow sequence")
        value = tuple(v for v, _ in items)
    else:
        value, rest = _scalar(text, where)
    if rest.strip() and not rest.strip().startswith("#"):
        raise ValueError(f"{where}: unexpected text after the value ({rest.strip()!r})")
    return value


def parse_flat_yaml(text: str, source: str = "<config>") -> dict:
    """A flat YAML mapping of scalars, read as yaml.safe_load reads it, with
    no `yaml`: `key: value` lines with quoted or plain scalars (null, bool,
    int, float or str by PyYAML's YAML 1.1 rules), comments, and sequences of
    scalars in flow (`[2, 4]`) or block form (`key:` then `- 2` lines), which
    are returned as tuples. It reads the port's config.yaml, the port's
    provenance (`key: <JSON value>` lines) and the JAX package's
    (`yaml.safe_dump`). Anything else (nested maps, anchors, tags, block
    scalars, several documents) raises ValueError naming the line."""
    out: dict = {}
    seq_key = None  # the key whose value was empty: a block sequence may follow
    for n, line in enumerate(text.splitlines(), 1):
        where = f"{source}:{n}"
        body = line.rstrip()
        if not body.strip() or body.lstrip().startswith("#"):
            continue
        item = _ITEM.match(body)
        if item:
            if seq_key is None:
                raise ValueError(f"{where}: a sequence item outside a key's sequence")
            out[seq_key] = (out[seq_key] or ()) + (_value(item.group(1) or "", where),)
            continue
        m = _KEY.match(body)
        if m is None:
            raise ValueError(f"{where}: not a flat `key: value` line: {body.strip()!r}")
        key, rest = m.group(1), (m.group(2) or "").strip()
        if not rest or rest.startswith("#"):
            out[key], seq_key = None, key
        else:
            out[key], seq_key = _value(rest, where), None
    return out


def load_config(config_path: Optional[str] = None, **overrides) -> Config:
    """Build a Config: dataclass defaults, then the config file (read by
    parse_flat_yaml; keys that are no Config field are ignored), then
    overrides (highest wins)."""
    values = {}
    if config_path is not None and os.path.isfile(config_path):
        with open(config_path) as f:
            loaded = parse_flat_yaml(f.read(), config_path)
        known = {f.name for f in dataclasses.fields(Config)}
        values = {k: v for k, v in loaded.items() if k in known}
    values.update({k: v for k, v in overrides.items() if v is not None})
    return Config(**values)
