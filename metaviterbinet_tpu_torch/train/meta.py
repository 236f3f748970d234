"""MAML meta-learning over parameter dicts (the JAX package's train/meta.py;
reference trainer.py:425-453).

Inner: theta' = theta - meta_lr * grad L(theta; support). Outer: the
gradient of L(theta'; query) with respect to theta, applied by the optimizer.
Second-order MAML differentiates through the inner gradient
(`create_graph=True`); first-order MAML treats it as a constant. The loss
must be built on a score that is twice differentiable on the card
(DetectorSpec.meta_score: the LSTM's unrolled recurrence, not cuDNN's).

The pairs of a meta iteration run as the JAX package runs them: the query
draws sorted, duplicates masked (`sorted_unique_mask`), and a fixed number
of pair steps, each under `when(fresh)` (`masked_pairs`, `each_pair`), so
that a duplicate draw performs no update and the loop has static shapes. On
the card a chunk of `chunk_steps(meta_j_num, MAML_NODES)` pairs is captured
once as a CUDA graph, each pair an IF node, and replayed (online/graphs.py);
on the CPU it runs directly. The online engine's ViterbiNet pairs run a
whole meta slot, every iteration's pairs in order, in one launch of a
fused kernel instead (online/engine.py::uses_fused_maml, kernels/
maml_pairs.py), through the same masked_pairs given the slot's
[iterations, meta_j_num] draws: each iteration's sorted and masked within
itself, as the iterations one by one would.
"""
from __future__ import annotations

from typing import Callable

import torch

from metaviterbinet_tpu_torch.online.graphs import GraphedStep, when
from metaviterbinet_tpu_torch.train.optim import Optimizer, OptState


def sorted_unique_mask(j_hats: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`torch.unique` semantics under static shapes (trainer.py:336-338,
    404-406; the JAX package's sorted_unique_mask) along the last
    dimension: the draws in ascending order and the mask of each value's
    first occurrence, each row of [..., n] draws on its own, on the draws'
    device with no host read. Masked-out entries must perform no update, so
    duplicate draws mean fewer (support, query) updates."""
    j_sorted = torch.sort(j_hats).values
    fresh = torch.cat([torch.ones_like(j_sorted[..., :1], dtype=torch.bool),
                       j_sorted[..., 1:] != j_sorted[..., :-1]], dim=-1)
    return j_sorted, fresh


def maml_pair_step(loss_fn: Callable, optimizer: Optimizer, meta_lr: float,
                   second_order: bool) -> Callable:
    """pair_step(params, opt_state, s_rx, s_tx, q_rx, q_tx) -> query loss
    (detached): one outer step, updating params and opt_state in place at
    the optimizer state's count."""

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

    return pair_step


def make_maml_step(loss_fn: Callable, optimizer: Optimizer, meta_lr: float,
                   second_order: bool) -> GraphedStep:
    """maml_pair_step as a graphed call of its own. On the card the loss is
    the graph's static output, which the next step overwrites: an eager op
    on it before the next step reads this step's loss, in stream order; a
    host read after the next step would read that step's."""
    return GraphedStep(maml_pair_step(loss_fn, optimizer, meta_lr, second_order), "maml")


def _pair(pair_step: Callable, params, opt_state, st, *rows) -> None:
    st["loss"].add_(pair_step(params, opt_state, *rows))


def each_pair(pair_step: Callable) -> Callable:
    """A chunk's pairs one by one: pairs(params, opt_state, st, take, s_rx,
    s_tx, q_rx, q_tx) runs pair_step on pair i's rows under when(take[i])
    and adds its query loss to st["loss"]."""

    def pairs(params, opt_state, st, take, s_rx, s_tx, q_rx, q_tx) -> None:
        for i in range(take.shape[0]):
            when(take[i], _pair, pair_step, params, opt_state, st, s_rx[i], s_tx[i], q_rx[i],
                 q_tx[i])

    return pairs


def masked_pairs(pairs: Callable, rows: Callable, params, opt_state, st: dict,
                 j_hats: torch.Tensor, first: torch.Tensor, chunk: int,
                 pred: torch.Tensor | None = None) -> None:
    """Pairs first .. first + chunk - 1 of meta iterations' draws j_hats,
    [meta_j_num] for one iteration or [iterations, meta_j_num] for several
    in order (the JAX package's pair scan under lax.cond, once an
    iteration): each iteration's draws sorted and masked within themselves
    (sorted_unique_mask), so that a value drawn twice in one iteration is
    taken once and one drawn in two iterations in both, the iterations'
    pairs then in order, and pair i taken where take[i] = fresh[i] & pred
    holds. rows(st, j) -> (s_rx, s_tx, q_rx, q_tx) gathers the chunk's
    [chunk, window, T] support and [chunk, 1, T] query rows of the sorted
    draws j [chunk] at once, and pairs(params, opt_state, st, take [chunk],
    *rows) runs the taken pairs in order (each_pair's IF nodes, or the
    fused kernel of kernels/maml_pairs.py). `first` is a [1] int64 device
    tensor, so one graph serves every chunk. st["pairs"] (0-d int32)
    counts the pairs taken and st["loss"] (0-d float32) sums their query
    losses, on the device."""
    j_sorted, fresh = (t.reshape(-1) for t in sorted_unique_mask(j_hats))
    k = first + torch.arange(chunk, device=first.device)
    take = fresh.index_select(0, k)
    if pred is not None:
        take = take & pred
    st["pairs"].add_(take.sum(dtype=torch.int32))
    pairs(params, opt_state, st, take, *rows(st, j_sorted.index_select(0, k)))


def make_pair_loop(loss_fn: Callable, optimizer: Optimizer, meta_lr: float, second_order: bool,
                   window: int, chunk: int) -> Callable:
    """Trainer.meta_train's pairs of one minibatch (the JAX package's
    `run_pairs`, evaluation/trainer.py:366-392 there): run(params,
    opt_state, st, j_hats) takes the meta_j_num query draws j_hats (a
    device tensor of words in [window, n_words)) over the words st["rx"] and
    st["tx"] [n_words, T], each fresh draw j a pair step with support the
    `window` words before j and query word j, in graphed calls of `chunk`
    pairs; returns sum(query losses) / max(fresh draws, 1), a 0-d device
    tensor. st also holds the device's "loss" and "pairs" sums, which run
    resets, and the chunks' first pairs."""
    pairs = each_pair(maml_pair_step(loss_fn, optimizer, meta_lr, second_order))

    def rows(st, j):
        support, query = j[:, None] + torch.arange(-window, 0, device=j.device), j[:, None]
        return st["rx"][support], st["tx"][support], st["rx"][query], st["tx"][query]

    graphed = GraphedStep(lambda p, o, st, j_hats, first: masked_pairs(
        pairs, rows, p, o, st, j_hats, first, chunk), "maml", n_state=3)

    def run(params, opt_state: OptState, st: dict, j_hats: torch.Tensor) -> torch.Tensor:
        if "firsts" not in st:
            st["firsts"] = torch.arange(0, j_hats.shape[0], chunk, device=j_hats.device)
        st["loss"].zero_()
        st["pairs"].zero_()
        for c in range(st["firsts"].shape[0]):
            graphed(params, opt_state, st, j_hats, st["firsts"][c:c + 1])
        return st["loss"] / torch.clamp(st["pairs"], min=1)

    return run
