"""Data-parallel training step over the mesh's 'dp' axis (the JAX package's
parallel/training.py).

Each rank computes the loss and gradients of its own rows of words; the
gradients and the loss are averaged over the dp group (one all-reduce, the
JAX package's pmean) and the optimizer update is applied identically on
every rank, so the params stay replicated.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from metaviterbinet_tpu_torch.parallel.mesh import mesh_axis
from metaviterbinet_tpu_torch.train.losses import select_batch
from metaviterbinet_tpu_torch.train.optim import Optimizer, OptState


def make_dp_train_step(mesh: DeviceMesh, loss_fn: Callable, optimizer: Optimizer,
                       minibatch_size: Optional[int] = None) -> Callable:
    """Returns step(params, opt_state, rx [W_loc, T], tx [W_loc, B], seed=None)
    -> (params, opt_state, loss) over this rank's rows; params (a dict of
    leaf tensors) and opt_state are updated in place, the same on every rank.

    loss_fn(params, rx, tx, idx) is train/losses.py::make_loss_fn's. With a
    seed, each rank subsamples minibatch_size of its tx.numel() labels by
    select_batch from a generator seeded by (seed, dp index), as the JAX
    package folds the dp index into its key; the streams differ from JAX's
    by design. Without one, the loss gets no indices."""
    group, n_dp, index = mesh_axis(mesh, "dp")

    def step(params: dict[str, torch.Tensor], opt_state: OptState, rx: torch.Tensor,
             tx: torch.Tensor, seed: Optional[int] = None):
        idx = None
        if seed is not None:
            if minibatch_size is None:
                raise ValueError("a subsampled step needs make_dp_train_step's minibatch_size")
            rank_seed = int(np.random.SeedSequence((seed, index)).generate_state(1)[0])
            gen = torch.Generator(device=rx.device).manual_seed(rank_seed)
            idx = select_batch(tx.numel(), minibatch_size, gen, rx.device)
        names = list(params)
        loss = loss_fn(params, rx, tx, idx)
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        flat = torch.cat([g.reshape(-1) for g in grads] + [loss.detach().reshape(1)])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat = flat / n_dp
        mean_grads, offset = {}, 0
        for k, g in zip(names, grads):
            mean_grads[k] = flat[offset:offset + g.numel()].reshape(g.shape)
            offset += g.numel()
        optimizer.step(params, mean_grads, opt_state)
        return params, opt_state, flat[-1]

    return step
