"""Detector registry: one functional API over the detector families.

A detector is a `DetectorSpec` binding
    model                         the model family's module (models/viterbinet.py
                                  or models/lstm.py: param_dict, from_params;
                                  None for the VA)
    init(cfg, generator, device)  -> params (a model; None for the VA)
    score(param_dict, y)          -> per-symbol logits [words, T, n_classes]
    meta_score(param_dict, y)     -> the same logits through a forward that is
                                     twice differentiable, for the MAML step
    detect(params, y, h)          -> hard bits [words, T], batch detection
    engine_detect(params, y, h)   -> hard bits [1, T], the online engine's
(the counterpart of metaviterbinet_tpu/detectors.py). Batch detection of the
ViterbiNet family and the VA always goes through the fused kernels of
kernels/acs.py, as the JAX package's `with_pallas_detect` does when it is
asked to: on CUDA tensors the hand-written kernel runs, on CPU tensors its
plain PyTorch version. The kernels take any number of words (the TPU
kernels' padding of the words axis to 128 lanes has no counterpart here).
The LSTM family has no kernel in the JAX package either: it detects through
its recurrence (models/lstm.py::logits, cuDNN on the card) and takes the
MAML step's second derivative through `logits_unrolled`, since cuDNN's RNN
has no double backward.

The online engine detects one block at a time as the JAX engine does
(evaluation/trainer.py:81-83 there keeps it off the fused kernels): the VA
through K2 at one word, which is bit-identical to the JAX `va.detect`; the
ViterbiNet family through its f32 MLP (torch.matmul with TF32 off, see
device.py::use_f32_matmuls) and then K5, the decode over those priors, and
never through K1, which rounds to bf16 like the TPU kernel; the LSTM family
through its batch detect at one word.

Two specialisations, applied by the Trainer in the JAX package's order:
`with_compute_dtype` (Config.dtype) and `with_time_chunks`
(Config.eval_time_chunks), the counterparts of `with_compute_dtype` and the
chunked branch of `with_pallas_detect` there.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, replace
from functools import partial
from types import ModuleType
from typing import Callable, Optional

import torch

from metaviterbinet_tpu_torch.kernels.acs import (
    fused_va_detect, fused_viterbinet_detect, fused_viterbinet_detect_chunked,
    viterbi_decode_kernel)
from metaviterbinet_tpu_torch.models import lstm, va, viterbinet


@dataclass(frozen=True)
class DetectorSpec:
    name: str
    trainable: bool
    label_kind: Optional[str]      # 'states' | 'bits' | None
    subsample_loss: bool           # reference select_batch subsampling in loss
    meta: bool                     # offline training is MAML meta-training
    model: Optional[ModuleType]    # the model family (param_dict, from_params)
    init: Optional[Callable]       # (cfg, generator, device) -> params
    score: Optional[Callable]      # (param_dict, y) -> [W, T, n_classes]
    meta_score: Optional[Callable]  # score, twice differentiable (the MAML step)
    detect: Callable               # (params, y, h) -> [W, T] bits
    engine_detect: Callable        # (params, y, h) -> [1, T] bits


def _va_detect(params, y: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    return fused_va_detect(y.contiguous(), va.state_means(h).contiguous())


def _vnet_detect(params, y: torch.Tensor, h) -> torch.Tensor:
    return fused_viterbinet_detect(params, y.contiguous())


@torch.no_grad()
def _vnet_engine_detect(params, y: torch.Tensor, h,
                        compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """ACS over the negated logits, returned as f32 whatever the compute
    dtype (logits are max-good, ACS is min-sum; reference
    vnet_detector.py:51-61)."""
    return viterbi_decode_kernel(-viterbinet.logits(viterbinet.param_dict(params), y,
                                                    compute_dtype))


def _vnet_init(cfg, generator, device):
    return viterbinet.init_params(cfg.n_states, generator, device)


def _lstm_detect(params, y: torch.Tensor, h,
                 compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    return lstm.detect(lstm.param_dict(params), y, compute_dtype)


def _lstm_init(cfg, generator, device):
    return lstm.init_params(generator, device)


# Classical Viterbi: parameterless, full CSI via explicit taps h
# (reference detectors/VA/va_detector.py:13-100)
VA = DetectorSpec(name="va", trainable=False, label_kind=None, subsample_loss=False,
                  meta=False, model=None, init=None, score=None, meta_score=None,
                  detect=_va_detect, engine_detect=_va_detect)

# ViterbiNet: DNN branch metrics + ACS (reference detectors/VNET/vnet_detector.py)
VNET = DetectorSpec(name="vnet", trainable=True, label_kind="states", subsample_loss=True,
                    meta=False, model=viterbinet, init=_vnet_init, score=viterbinet.logits,
                    meta_score=viterbinet.logits, detect=_vnet_detect,
                    engine_detect=_vnet_engine_detect)

# Meta-ViterbiNet: the same network, MAML offline training and online
# meta-adaptation (reference trainers/META_VNET/metavnet_trainer.py)
META_VNET = DetectorSpec(name="meta_vnet", trainable=True, label_kind="states",
                         subsample_loss=False, meta=True, model=viterbinet, init=_vnet_init,
                         score=viterbinet.logits, meta_score=viterbinet.logits,
                         detect=_vnet_detect, engine_detect=_vnet_engine_detect)

# Windowed LSTM (reference detectors/LSTM/lstm_detector.py)
LSTM = DetectorSpec(name="lstm", trainable=True, label_kind="bits", subsample_loss=True,
                    meta=False, model=lstm, init=_lstm_init, score=lstm.logits,
                    meta_score=lstm.logits_unrolled, detect=_lstm_detect,
                    engine_detect=_lstm_detect)

# Meta-LSTM (reference trainers/META_LSTM/meta_lstm_trainer.py)
META_LSTM = DetectorSpec(name="meta_lstm", trainable=True, label_kind="bits",
                         subsample_loss=False, meta=True, model=lstm, init=_lstm_init,
                         score=lstm.logits, meta_score=lstm.logits_unrolled,
                         detect=_lstm_detect, engine_detect=_lstm_detect)

DETECTORS = {d.name: d for d in (VA, VNET, META_VNET, LSTM, META_LSTM)}


def with_time_chunks(spec: DetectorSpec, time_chunks: int, overlap: int = 32,
                     memory_length: int = 4) -> DetectorSpec:
    """Route the ViterbiNet family's batch detect through the time-chunked
    kernel K4 (Config.eval_time_chunks), by the rules of the JAX package's
    `with_pallas_detect`: chunked only when time_chunks > 1, T divides into
    time_chunks and the chunks are at least `overlap` long; K1 otherwise.
    An overlap below 8 * memory_length (the trellis forgetting depth at
    which the chunked bits were measured equal to K1's) warns and keeps K1.
    This is a choice between two kernels, not a fallback to a plain
    version; the launch counters show which one ran. The VA and the LSTM
    family are returned unchanged."""
    if spec.model is not viterbinet or time_chunks <= 1:
        return spec
    if overlap < 8 * memory_length:
        warnings.warn(
            f"eval_time_chunks={time_chunks} requested with decode_overlap={overlap} < "
            f"8*memory_length={8 * memory_length}: warm-up would not reach trellis "
            "forgetting depth; using the unchunked kernel.")
        return spec

    def detect(params, y: torch.Tensor, h) -> torch.Tensor:
        T = y.shape[1]
        if T % time_chunks == 0 and T // time_chunks >= overlap:
            return fused_viterbinet_detect_chunked(params, y.contiguous(), time_chunks, overlap)
        return fused_viterbinet_detect(params, y.contiguous())

    return replace(spec, detect=detect)


def with_compute_dtype(spec: DetectorSpec, dtype_name: str) -> DetectorSpec:
    """Specialise a trainable spec to a compute dtype (Config.dtype).
    'bfloat16', the ViterbiNet family: `score` and `meta_score` (training,
    MAML, the online losses) become the bf16 forward, and `engine_detect`
    its logits cast to f32, then K5, as the JAX engine captures the bf16
    detect; the batch `detect` stays K1/K4, which round to bf16 like the TPU
    kernel. The LSTM family: every forward, detection included, runs the
    unrolled recurrence in bf16, as the JAX package's `lstm.score` does.
    'float32' (Config checks that no other dtype is asked for) and the VA
    are returned unchanged."""
    if dtype_name != "bfloat16" or not spec.trainable:
        return spec
    bf16 = torch.bfloat16
    if spec.model is lstm:
        score = partial(lstm.logits_unrolled, compute_dtype=bf16)
        detect = partial(_lstm_detect, compute_dtype=bf16)
        return replace(spec, score=score, meta_score=score, detect=detect, engine_detect=detect)
    score = partial(viterbinet.logits, compute_dtype=bf16)
    return replace(spec, score=score, meta_score=score,
                   engine_detect=partial(_vnet_engine_detect, compute_dtype=bf16))
