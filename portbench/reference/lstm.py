"""The windowed LSTM detector, written plainly (the Meta-ViterbiNet
reference's detectors/LSTM/lstm_detector.py): at each position t the window
[y_(t-3), .., y_t] (positions before the word read -100) feeds a 2-layer
LSTM of hidden size 256, and a linear layer gives two bit logits.

Each layer follows nn.LSTM's equations, gates in the order i, f, g, o:
  gates = W_ih x_t + b_ih + W_hh h_(t-1) + b_hh
  c_t = sigmoid(f) c_(t-1) + sigmoid(i) tanh(g),  h_t = sigmoid(o) tanh(c_t)
with zero initial state. Params: w_ih{l} [1024, in], w_hh{l} [1024, 256],
b_ih{l}, b_hh{l} [1024] for l = 0, 1 (in = 4, then 256), w_fc [2, 256],
b_fc [2]."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

WINDOW, HIDDEN, LAYERS, CLASSES, PAD = 4, 256, 2, 2, -100.0


def shapes() -> dict[str, tuple[int, ...]]:
    out = {}
    for l in range(LAYERS):
        n_in = WINDOW if l == 0 else HIDDEN
        out.update({f"w_ih{l}": (4 * HIDDEN, n_in), f"w_hh{l}": (4 * HIDDEN, HIDDEN),
                    f"b_ih{l}": (4 * HIDDEN,), f"b_hh{l}": (4 * HIDDEN,)})
    out.update({"w_fc": (CLASSES, HIDDEN), "b_fc": (CLASSES,)})
    return out


def init(generator: torch.Generator, device: torch.device) -> dict[str, torch.Tensor]:
    """U(-1/16, 1/16) for every leaf (nn.LSTM's law at hidden 256, the
    linear layer's too), from one draw on the device."""
    sizes = [int(np.prod(s)) for s in shapes().values()]
    flat = (torch.rand(sum(sizes), generator=generator, device=device) * 2 - 1) * HIDDEN ** -0.5
    return {k: v.view(s) for (k, s), v in zip(shapes().items(), flat.split(sizes))}


def logits(p: dict[str, torch.Tensor], y: torch.Tensor) -> torch.Tensor:
    """y [B, T] -> [B, T, 2]."""
    B, T = y.shape
    padded = torch.cat([y.new_full((B, WINDOW - 1), PAD), y], dim=1)
    x = torch.stack([padded[:, i:T + i] for i in range(WINDOW)], dim=-1)  # [B, T, 4]
    for l in range(LAYERS):
        h = c = y.new_zeros((B, HIDDEN))
        outs = []
        for t in range(T):
            gates = x[:, t] @ p[f"w_ih{l}"].T + p[f"b_ih{l}"] + h @ p[f"w_hh{l}"].T + p[f"b_hh{l}"]
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        x = torch.stack(outs, dim=1)
    return x @ p["w_fc"].T + p["b_fc"]


def loss(p: dict[str, torch.Tensor], y: torch.Tensor, bits: torch.Tensor,
         positions: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of one word's bit logits (y [1, T]) against its
    info bits [1, k] at the given positions (< k)."""
    z = logits(p, y).reshape(-1, CLASSES)
    return F.cross_entropy(z[positions], bits.reshape(-1)[positions].long())
