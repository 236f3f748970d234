"""MAML meta-learning over parameter dicts (the JAX package's train/meta.py;
reference trainer.py:425-453).

Inner: theta' = theta - meta_lr * grad L(theta; support). Outer: the
gradient of L(theta'; query) with respect to theta, applied by the optimizer.
Second-order MAML differentiates through the inner gradient
(`create_graph=True`); first-order MAML treats it as a constant. The loss
must be built on a score that is twice differentiable on the card
(DetectorSpec.meta_score: the LSTM's unrolled recurrence, not cuDNN's).

On the card the step is captured once as a CUDA graph and replayed
(online/graphs.py); on the CPU it runs directly.
"""
from __future__ import annotations

from typing import Callable

import torch

from metaviterbinet_tpu_torch.online.graphs import GraphedStep
from metaviterbinet_tpu_torch.train.optim import Optimizer, OptState


def sorted_unique(j_hats: torch.Tensor) -> torch.Tensor:
    """`torch.unique` semantics of the reference (trainer.py:336-338,
    404-406): the draws in ascending order, duplicates dropped, so duplicate
    draws mean fewer (support, query) updates."""
    return torch.unique(j_hats, sorted=True)


def make_maml_step(loss_fn: Callable, optimizer: Optimizer, meta_lr: float,
                   second_order: bool) -> GraphedStep:
    """Returns step(params, opt_state, s_rx, s_tx, q_rx, q_tx) -> query loss,
    which updates params and opt_state in place at the optimizer state's
    count. On the card the loss is the graph's static output, which the
    next step overwrites: an eager op on it before the next step reads this
    step's loss, in stream order; a host read after the next step would
    read that step's."""

    def pair_step(params: dict[str, torch.Tensor], opt_state: OptState, s_rx, s_tx, q_rx, q_tx):
        names = list(params)
        leaves = [params[k] for k in names]
        inner = torch.autograd.grad(loss_fn(params, s_rx, s_tx), leaves,
                                    create_graph=second_order)
        updated = {k: p - meta_lr * g for k, p, g in zip(names, leaves, inner)}
        loss_q = loss_fn(updated, q_rx, q_tx)
        meta_grads = torch.autograd.grad(loss_q, leaves)
        optimizer.apply(params, dict(zip(names, meta_grads)), opt_state)
        return loss_q.detach()

    return GraphedStep(pair_step, "maml")
