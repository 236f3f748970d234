"""Operations, bytes and peaks: the arithmetic that turns a measured time
into a share of what one H100 can do. Frozen here so that no change to the
program can move the yardstick.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W limit: 3.35 TB/s
of HBM, 67 TFLOP/s of float32 outside the tensor cores (the port computes
its float32 products with TF32 off, so that is its peak).

The ViterbiNet counts follow chip_smoke.py (at cb310e9) `decode_bound_ms`,
`adapt_ops` and `adapt_bound_ms`, where an operation is one float32 add,
multiply, compare or special function. Per symbol of the 1 -> H1 -> H2 ->
S network (H1 = 100, H2 = 50):
  forward  w1 y + b1 and the sigmoid 6 H1, W2 h1 2 H2 H1, b2 and relu 2 H2,
           W3 h2 2 S H2, b3 S;
  softmax and its gradient 7 S;
  backward dW3 and dh2 2 S H2 each, db3 S, the relu mask H2, dW2 and dh1
           2 H2 H1 each, db2 H2, dz1 3 H1, dw1 2 H1, db1 H1;
and an Adam step 14 operations per parameter.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
H1, H2 = 100, 50


def vnet_params(S: int) -> int:
    return H1 * 2 + H2 * (H1 + 1) + S * (H2 + 1)


def vnet_forward_ops(S: int) -> int:
    return 6 * H1 + 2 * H2 * H1 + 2 * H2 + 2 * S * H2 + S


def vnet_backward_ops(S: int) -> int:
    return 2 * S * H2 + 2 * S * H2 + S + H2 + 2 * 2 * H2 * H1 + H2 + 3 * H1 + 2 * H1 + H1


def vnet_gradient_ops(T: int, S: int) -> int:
    """Loss and gradient of T symbols."""
    return T * (vnet_forward_ops(S) + 7 * S + vnet_backward_ops(S))


def acs_ops(T: int, S: int) -> float:
    """The greedy Viterbi recursion: S adds, S / 2 pair minima, S / 2
    renormalising minima and subtractions and S readout compares a symbol."""
    return 3.5 * S * T


def decode_bound_ms(W: int, T: int, S: int) -> tuple[float, str]:
    """Least time of K5 (viterbi_decode_kernel): the priors in and the bits
    out once, against its ACS operations."""
    t_bytes = 4.0 * (W * T * S + W * T) / HBM_BYTES_PER_S
    t_ops = W * acs_ops(T, S) / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def adapt_ops(T: int, S: int, n_iters: int) -> float:
    """n Adam steps of cross-entropy over the states of one word of T
    symbols (K6, online_adapt_kernel)."""
    return n_iters * (vnet_gradient_ops(T, S) + 14 * vnet_params(S))


def adapt_bound_ms(T: int, S: int, n_iters: int) -> tuple[float, str]:
    """Least time of K6: y and the states in once, the params and both
    moments in and out once, against adapt_ops."""
    t_bytes = 4.0 * (2 * T + 6 * vnet_params(S)) / HBM_BYTES_PER_S
    t_ops = adapt_ops(T, S, n_iters) / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def detect_ops(T: int, S: int) -> float:
    """A block's detection: the forward of its T symbols and the ACS."""
    return T * vnet_forward_ops(S) + acs_ops(T, S)


def maml_pair_ops(T: int, S: int, window: int) -> float:
    """One second-order MAML pair: the support's loss and gradient (window
    words), the inner update (2 per parameter), the query's loss and
    gradient at the adapted params, the product of the support's Hessian
    with that gradient (forward over reverse: twice a gradient), and an
    Adam step."""
    support = window * vnet_gradient_ops(T, S)
    return 3 * support + vnet_gradient_ops(T, S) + 16 * vnet_params(S)


# The windowed LSTM (2 layers, hidden 256, window 4, 2 classes), per word of
# T positions at batch 1: a layer's step is 2 * 4H * (in + H) products and
# the gates' elementwise work (3 sigmoids and 2 tanh of H, 4 products and
# an add of H: counted 4H + 5H); the backward costs twice the forward; Adam
# 14 per parameter.
LSTM_H, LSTM_WINDOW, LSTM_LAYERS, LSTM_CLASSES = 256, 4, 2, 2


def lstm_params() -> int:
    n, n_in = 0, LSTM_WINDOW
    for _ in range(LSTM_LAYERS):
        n += 4 * LSTM_H * (n_in + LSTM_H + 2)
        n_in = LSTM_H
    return n + LSTM_CLASSES * (LSTM_H + 1)


def lstm_forward_ops(T: int) -> float:
    per_t, n_in = 0, LSTM_WINDOW
    for _ in range(LSTM_LAYERS):
        per_t += 2 * 4 * LSTM_H * (n_in + LSTM_H) + 2 * 4 * LSTM_H + 9 * LSTM_H
        n_in = LSTM_H
    return T * (per_t + 2 * LSTM_CLASSES * LSTM_H + LSTM_CLASSES)


def lstm_step_ops(T: int) -> float:
    """One training step of one word: forward, backward (twice the
    forward) and Adam."""
    return 3 * lstm_forward_ops(T) + 14 * lstm_params()
