"""Distributed Viterbi decoding: words-axis sharding and block-parallel
sequence decode with overlap-save warm-up (the JAX package's
parallel/decode.py).

Sequence parallelism rests on the trellis forgetting its start: path
metrics forget their initial condition after about 5 L symbols. Each rank
decodes its T / n_sp steps prefixed by `overlap` steps of its left
neighbour's tail, starting from zero metrics, and drops the warm-up bits.
Rank 0 warms up on zero branch metrics, which keep the metrics exactly
uniform: the same as starting fresh at the stream head.

On the card every local decode is one launch of K5
(kernels/acs.py::viterbi_decode_kernel), whose zero initial metrics are
exactly the JAX package's `viterbi_decode_with_metrics(ext, zeros)`; on a
CPU tensor its plain version.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from metaviterbinet_tpu_torch.kernels.acs import viterbi_decode_kernel
from metaviterbinet_tpu_torch.parallel.mesh import mesh_axis


def shard_words_decode(mesh: DeviceMesh, detect_fn: Callable) -> Callable:
    """Data-parallel detection over the mesh's 'dp' axis.

    Returns run(params, y [W, T], h [W, ...]) -> bits [W, T] on every rank:
    the words axis is padded to a multiple of the dp size by repeating the
    last row, each dp rank runs detect_fn(params, y_rows, h_rows) on its
    contiguous rows (the spec's detect: K1, K2 or K4 on the card), and the
    rows are all-gathered over the dp group and cut to W.

    The JAX package's `via_shard_map` flag exists because a Pallas kernel
    does not partition under GSPMD; here each rank always runs its own
    detect on its own rows, so there is no such choice."""
    group, n_dp, index = mesh_axis(mesh, "dp")

    def run(params, y: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        W = y.shape[0]
        rows = -(-W // n_dp)
        if rows * n_dp != W:
            pad = rows * n_dp - W
            y = torch.cat([y, y[-1:].expand(pad, *y.shape[1:])])
            h = torch.cat([h, h[-1:].expand(pad, *h.shape[1:])])
        mine = slice(index * rows, (index + 1) * rows)
        local = detect_fn(params, y[mine].contiguous(), h[mine].contiguous()).contiguous()
        parts = [torch.empty_like(local) for _ in range(n_dp)]
        dist.all_gather(parts, local, group=group)
        return torch.cat(parts)[:W]

    return run


def sequence_parallel_decode(mesh: DeviceMesh, overlap: int,
                             words_axis: Optional[str] = None) -> Callable:
    """Block-parallel greedy Viterbi over the time axis, split over the
    mesh's 'sp' axis.

    Returns run(local_priors [W_loc, T_loc, S]) -> local bits [W_loc, T_loc]:
    each rank passes its own block of the stream, the time steps of its sp
    index (and, with `words_axis`, the words of its index on that axis,
    e.g. 'dp' for hosts x chips: words across hosts, time across each
    host's chips). Exact equality with the sequential decode holds when
    `overlap` exceeds the trellis forgetting depth (use >= 8 L)."""
    group, n_sp, index = mesh_axis(mesh, "sp")
    if words_axis is not None:
        mesh_axis(mesh, words_axis)  # a mesh axis of its own
        if words_axis == "sp":
            raise ValueError("words_axis must be another mesh axis than 'sp'")

    def run(local_priors: torch.Tensor) -> torch.Tensor:
        T_loc = local_priors.shape[1]
        if T_loc < overlap:
            raise ValueError(f"sequence_parallel_decode: {T_loc} local steps, fewer than the "
                             f"overlap {overlap}")
        tail = local_priors[:, T_loc - overlap:].contiguous()
        prev_tail = torch.zeros_like(tail)
        # the left neighbour's tail: rank i sends to i + 1 and receives from
        # i - 1 (the JAX ppermute). Rank 0 warms up on zeros whatever it
        # receives, so with one sp rank nothing is exchanged.
        if n_sp > 1:
            ops = [dist.P2POp(dist.isend, tail,
                              dist.get_global_rank(group, (index + 1) % n_sp), group=group),
                   dist.P2POp(dist.irecv, prev_tail,
                              dist.get_global_rank(group, (index - 1) % n_sp), group=group)]
            for request in dist.batch_isend_irecv(ops):
                request.wait()
            if index == 0:
                prev_tail.zero_()
        ext = torch.cat([prev_tail, local_priors], dim=1)
        return viterbi_decode_kernel(ext)[:, overlap:]

    return run


def chunked_decode_reference(priors: torch.Tensor, n_chunks: int, overlap: int) -> torch.Tensor:
    """The block-parallel decode on one device: the time axis is cut into
    n_chunks chunks, each prefixed by the last `overlap` steps of the chunk
    before it (zeros for the first), and all W * n_chunks chains go through
    one decode (one K5 launch on the card). [W, T, S] -> [W, T] bits."""
    W, T, S = priors.shape
    if T % n_chunks:
        raise ValueError(f"chunked_decode_reference: T={T} does not split into {n_chunks} chunks")
    Tc = T // n_chunks
    if Tc < overlap:
        raise ValueError(f"chunked_decode_reference: chunks of {Tc} steps are shorter than the "
                         f"overlap {overlap}")
    chunks = priors.reshape(W, n_chunks, Tc, S)
    warm = torch.cat([priors.new_zeros((W, 1, overlap, S)), chunks[:, :-1, Tc - overlap:]], dim=1)
    ext = torch.cat([warm, chunks], dim=2).reshape(W * n_chunks, overlap + Tc, S)
    return viterbi_decode_kernel(ext)[:, overlap:].reshape(W, T)
