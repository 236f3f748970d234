"""Sliding-window LSTM detector (model-free, no trellis).

Architecture parity with reference detectors/LSTM/lstm_detector.py:14-59 and
the JAX package's models/lstm.py: a window of the INPUT_SIZE most recent
samples [y_{t-3}, .., y_t] (positions before t = 0 read the -100 padding)
feeds a 2-layer LSTM (hidden 256) and an FC layer to 2 classes. The weights
keep nn.LSTM's layout and gate order (i, f, g, o), which the JAX package
also uses, under the JAX names w_ih{l}, w_hh{l}, b_ih{l}, b_hh{l}, w_fc and
b_fc.

Two forwards over such a parameter dict:
  - `logits`, the fused recurrence of PyTorch's LSTM op (cuDNN on the card):
    batch and engine detection, the word sweep and the online
    self-supervised steps. The JAX package runs its LSTM on an XLA scan,
    outside any Pallas kernel (detectors.py:99-101 there).
  - `logits_unrolled`, the JAX package's `_score_split` (models/lstm.py:90-
    119 there) in plain differentiable ops: each layer's input projection
    as one product, then per step ((x W_ih^T + b_ih) + h W_hh^T) + b_hh.
    cuDNN's RNN has no double backward, so the MAML step takes its second
    derivative through this forward; the bf16 compute dtype runs it too.
"""
from __future__ import annotations

import torch
from torch import nn

from metaviterbinet_tpu_torch.device import resolve_device, use_f32_matmuls

INPUT_SIZE = 4
HIDDEN_SIZE = 256
NUM_LAYERS = 2
N_CLASSES = 2
START_VALUE_PADDING = -100.0
# the order of torch.lstm's weight list (nn.LSTM's _flat_weights)
LSTM_WEIGHTS = tuple(f"{kind}{layer}" for layer in range(NUM_LAYERS)
                     for kind in ("w_ih", "w_hh", "b_ih", "b_hh"))
PARAM_NAMES = LSTM_WEIGHTS + ("w_fc", "b_fc")
# device activities of one training step of the LSTM (loss, gradient,
# Adam) under torch.profiler, chip_smoke.py phase 7c on an NVIDIA H100 80GB
# HBM3: the nodes a captured step adds to a graph (online/graphs.py::chunk_steps)
STEP_NODES = 1305
# the same of one second-order MAML pair step (inner gradient, query loss
# through the adapted params, outer gradient, Adam): the nodes a captured
# pair adds to a graph (train/meta.py::masked_pairs)
MAML_NODES = 38_000


class WindowedLSTM(nn.Module):
    def __init__(self, device: str | torch.device = "cuda"):
        super().__init__()
        device = resolve_device(device)
        if device.type == "cuda":
            use_f32_matmuls()  # cuDNN's LSTM takes TF32 unless told not to
        self.rnn = nn.LSTM(INPUT_SIZE, HIDDEN_SIZE, num_layers=NUM_LAYERS, batch_first=True,
                           device=device)
        self.fc = nn.Linear(HIDDEN_SIZE, N_CLASSES, device=device)

    def __setstate__(self, state):
        # a deep copy holds the LSTM's weights as separate tensors: put them
        # back in one buffer, as cuDNN takes them without a copy per call (a
        # no-op on the CPU)
        super().__setstate__(state)
        self.rnn.flatten_parameters()

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        """Per-symbol class logits: y [words, T] -> [words, T, 2] f32."""
        return logits(param_dict(self), y)


def param_dict(model: WindowedLSTM) -> dict[str, torch.Tensor]:
    """The model's own parameter tensors under the JAX package's names, so
    that in-place updates land in the module (and in cuDNN's buffer)."""
    out = {}
    for layer in range(NUM_LAYERS):
        for name, attr in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"), ("b_ih", "bias_ih"),
                           ("b_hh", "bias_hh")):
            out[f"{name}{layer}"] = getattr(model.rnn, f"{attr}_l{layer}")
    out["w_fc"], out["b_fc"] = model.fc.weight, model.fc.bias
    return out


def make_windows(y: torch.Tensor) -> torch.Tensor:
    """[B, T] -> [B, T, INPUT_SIZE] windows [y_{t-3}, y_{t-2}, y_{t-1}, y_t]."""
    B, T = y.shape
    padded = torch.cat([y.new_full((B, INPUT_SIZE - 1), START_VALUE_PADDING), y], dim=1)
    return torch.stack([padded[:, i:T + i] for i in range(INPUT_SIZE)], dim=-1)


def logits(params: dict[str, torch.Tensor], y: torch.Tensor) -> torch.Tensor:
    """The fused forward: y [words, T] -> [words, T, 2] f32, through
    PyTorch's LSTM op over `params` (the JAX package's `score`)."""
    B = y.shape[0]
    h0 = y.new_zeros((NUM_LAYERS, B, HIDDEN_SIZE))
    out, _, _ = torch.lstm(make_windows(y), (h0, h0), [params[k] for k in LSTM_WEIGHTS], True,
                           NUM_LAYERS, 0.0, torch.is_grad_enabled(), False, True)
    return out @ params["w_fc"].T + params["b_fc"]


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    # jax.nn.sigmoid as XLA lowers it in a low dtype, each op rounded to it
    return 1.0 / (1.0 + torch.exp(-x))


def logits_unrolled(params: dict[str, torch.Tensor], y: torch.Tensor,
                    compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The recurrence layer by layer in plain ops, twice differentiable:
    y [words, T] -> [words, T, 2] f32. With `compute_dtype` (torch.bfloat16)
    the params and y are cast to it and every op runs in it, as the JAX
    package's `score(..., compute_dtype)`."""
    if compute_dtype is not None:
        params = {k: v.to(compute_dtype) for k, v in params.items()}
        y = y.to(compute_dtype)
    B = y.shape[0]
    inp = make_windows(y).transpose(0, 1)  # [T, B, INPUT_SIZE]
    for layer in range(NUM_LAYERS):
        px = inp @ params[f"w_ih{layer}"].T + params[f"b_ih{layer}"]  # [T, B, 4H]
        w_hh, b_hh = params[f"w_hh{layer}"].T, params[f"b_hh{layer}"]
        h = c = y.new_zeros((B, HIDDEN_SIZE))
        outs = []
        # unbind and chunk, not indexing: their backward is one stack or cat
        # (an index's is a zero-filled copy of the whole tensor per step)
        for px_t in px.unbind(0):
            gates = (px_t + h @ w_hh) + b_hh
            i, f, _, o = _sigmoid(gates).chunk(4, dim=-1)  # the g quarter is unused
            g = torch.tanh(gates.chunk(4, dim=-1)[2])
            c = f * c + i * g
            h = o * torch.tanh(c)
            outs.append(h)
        inp = torch.stack(outs)  # [T, B, H]
    out = inp @ params["w_fc"].T + params["b_fc"]
    return out.transpose(0, 1).to(torch.float32)


@torch.no_grad()
def detect(params: dict[str, torch.Tensor], y: torch.Tensor,
           compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Hard bits [words, T] as y's dtype: the argmax of the class logits,
    ties to class 0 (reference lstm_detector.py:55-57). f32 detection runs
    the fused forward, a compute dtype the unrolled one."""
    out = logits(params, y) if compute_dtype is None else logits_unrolled(params, y, compute_dtype)
    return torch.argmax(out, dim=-1).to(y.dtype)


def init_params(generator: torch.Generator, device: str | torch.device = "cuda") -> WindowedLSTM:
    """A WindowedLSTM with every tensor drawn from U(-sqrt(1/H), sqrt(1/H)),
    H = HIDDEN_SIZE (the torch LSTM family, and w_fc, b_fc at the same k),
    from `generator`."""
    model = WindowedLSTM(device=device)
    bound = (1.0 / HIDDEN_SIZE) ** 0.5
    with torch.no_grad():
        for p in param_dict(model).values():
            p.copy_(torch.rand(p.shape, generator=generator, device=p.device) * (2 * bound) - bound)
    return model


def from_params(params: dict, device: str | torch.device = "cuda") -> WindowedLSTM:
    """A WindowedLSTM holding a copy of `params` (tensors or arrays under
    the JAX package's names, in its layout)."""
    model = WindowedLSTM(device=device)
    with torch.no_grad():
        for k, p in param_dict(model).items():
            src = torch.as_tensor(params[k], dtype=torch.float32)
            if src.shape != p.shape:
                raise ValueError(f"{k}: shape {tuple(src.shape)}, expected {tuple(p.shape)}")
            p.copy_(src)
    return model
