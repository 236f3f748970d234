"""The by-word protocol of Meta-ViterbiNet (Raviv et al., arXiv:2103.13483;
the reference's trainers/trainer.py `eval_by_word` and
trainers/META_VNET/metavnet_trainer.py), written plainly for ViterbiNet,
one block after another.

Block c: detect the received word, RS-decode it, count its bit errors
against the sent info bits (none at a pilot, every `subframes`-th block),
and gate it in where the error rate is at most `ser_thresh`. A gated block
enters the buffer with its pseudo-label: the detected word where the
decoded word has errors, else the re-encoded decoded word (a pilot: the
re-encoded sent word). At a candidate meta slot (c a multiple of
`meta_subframes`, from `meta_subframes` on) with more than two words in
the buffer, the params restart from the ones the last slot saved, take
`meta_iterations` rounds of MAML pairs and are saved: each round draws
`meta_j_num` query positions below max(fill - 2, 1) and runs one
second-order pair per distinct position, in ascending order, with the
`window` words before it (wrapping through the fill) as support. A gated
block then restarts from the saved params and takes `iterations` Adam
steps of cross-entropy over its trellis states. One Adam state serves all
steps.

Only weights_init 'last_frame' and an empty-start buffer are written here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from portbench.reference import rs, viterbinet
from portbench.reference.adam import Adam


@dataclass(frozen=True)
class Protocol:
    memory_length: int
    n_symbols: int
    subframes: int
    ser_thresh: float
    self_supervised: bool
    iterations: int
    lr: float
    online_meta: bool
    meta_lr: float
    meta_subframes: int
    meta_iterations: int
    meta_j_num: int
    window: int
    buffer_capacity: int
    tf32: bool = False  # products in TF32 (viterbinet.product)

    @classmethod
    def of(cls, cfg: dict, self_supervised: bool, online_meta: bool) -> "Protocol":
        """From a configuration file's keys (the port's Config names)."""
        return cls(memory_length=cfg["memory_length"], n_symbols=cfg["n_symbols"],
                   subframes=cfg["subframes_in_frame"], ser_thresh=cfg["ser_thresh"],
                   self_supervised=self_supervised, iterations=cfg["self_supervised_iterations"],
                   lr=cfg["lr"], online_meta=online_meta, meta_lr=cfg["meta_lr"],
                   meta_subframes=cfg["meta_subframes"],
                   meta_iterations=cfg["meta_train_iterations"], meta_j_num=cfg["meta_j_num"],
                   window=cfg["window_size"], buffer_capacity=cfg["buffer_capacity"])


def meta_slots(proto: Protocol, n_blocks: int) -> list[int]:
    return [c for c in range(n_blocks)
            if proto.online_meta and c % proto.meta_subframes == 0 and c >= proto.meta_subframes]


class QueryDraws:
    """The query positions of every candidate slot and round, fixed before
    the run: for slot s and round i at bound b, entry [s, i] of
    torch.randint(0, b, (slots, rounds, meta_j_num)) on a CPU generator
    seeded with `seed`, the same seed for every bound."""

    def __init__(self, seed: int, n_slots: int, proto: Protocol):
        self.seed, self.shape = seed, (n_slots, proto.meta_iterations, proto.meta_j_num)
        self._by_bound: dict[int, np.ndarray] = {}

    def __call__(self, slot: int, iteration: int, bound: int) -> np.ndarray:
        if bound not in self._by_bound:
            g = torch.Generator().manual_seed(self.seed)
            self._by_bound[bound] = torch.randint(0, bound, self.shape, generator=g).numpy()
        return self._by_bound[bound][slot, iteration]


def errors_allowed(proto: Protocol, info_bits: int) -> int:
    """The most bit errors of a block that the gate lets in."""
    return int(np.floor(proto.ser_thresh * info_bits + 1e-9))


def maml_pair(p: dict, adam: Adam, proto: Protocol, s_rx, s_lab, q_rx, q_lab) -> None:
    leaves = list(p.values())
    inner = torch.autograd.grad(viterbinet.loss(p, s_rx, s_lab, proto.memory_length, proto.tf32),
                                leaves, create_graph=True)
    fast = {k: v - proto.meta_lr * g for (k, v), g in zip(p.items(), inner)}
    outer = torch.autograd.grad(
        viterbinet.loss(fast, q_rx, q_lab, proto.memory_length, proto.tf32), leaves)
    adam.step(p, dict(zip(p, outer)))


def adapt(p: dict, adam: Adam, proto: Protocol, rx, label) -> None:
    leaves = list(p.values())
    for _ in range(proto.iterations):
        grads = torch.autograd.grad(
            viterbinet.loss(p, rx, label, proto.memory_length, proto.tf32), leaves)
        adam.step(p, dict(zip(p, grads)))


def run(params: dict[str, torch.Tensor], rx: torch.Tensor, tx: torch.Tensor, proto: Protocol,
        draws: Callable[[int, int, int], np.ndarray]) -> dict:
    """The protocol over blocks rx [N, T] (received) and tx [N, k] (sent
    info bits), from `params` (copied), in their dtype and device. Returns
    each block's bit errors, the gated count, the MAML pairs run, the
    buffer's fill and the final params."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    saved = {k: v.detach().clone() for k, v in p.items()}
    adam = Adam(p, proto.lr)
    n_blocks, T = rx.shape
    k_bits = tx.shape[1]
    allowed = errors_allowed(proto, k_bits)
    slot_of = {c: s for s, c in enumerate(meta_slots(proto, n_blocks))}
    buf_rx, buf_lab = [None] * proto.buffer_capacity, [None] * proto.buffer_capacity
    start, n_valid = 0, 0
    errors, n_gated, pairs = [], 0, 0
    tx_np = tx.cpu().numpy().astype(np.int64)
    for c in range(n_blocks):
        detected = viterbinet.detect(p, rx[c], proto.tf32)
        if c % proto.subframes:
            decoded = rs.decode_bits(detected[None], proto.n_symbols)[0]
            err = int((decoded != tx_np[c]).sum())
            label = detected if err else rs.encode_bits(decoded[None], proto.n_symbols)[0]
        else:
            err = 0
            label = rs.encode_bits(tx_np[c][None], proto.n_symbols)[0]
        errors.append(err)
        gate = err <= allowed
        if gate:
            n_gated += 1
            slot = (start + n_valid) % proto.buffer_capacity
            buf_rx[slot], buf_lab[slot] = rx[c], torch.as_tensor(label, device=rx.device)
            if n_valid == proto.buffer_capacity:
                start = (start + 1) % proto.buffer_capacity
            n_valid = min(n_valid + 1, proto.buffer_capacity)
        if c in slot_of and n_valid > 2:
            with torch.no_grad():
                for k, v in p.items():
                    v.copy_(saved[k])
            for it in range(proto.meta_iterations):
                for j in np.unique(draws(slot_of[c], it, max(n_valid - 2, 1))):
                    sup = [(start + (j + d) % n_valid) % proto.buffer_capacity
                           for d in range(-proto.window, 0)]
                    q = (start + j) % proto.buffer_capacity
                    maml_pair(p, adam, proto, torch.stack([buf_rx[i] for i in sup]),
                              torch.stack([buf_lab[i] for i in sup]), buf_rx[q][None],
                              buf_lab[q][None])
                    pairs += 1
            saved = {k: v.detach().clone() for k, v in p.items()}
        if proto.self_supervised and gate:
            if proto.online_meta:
                with torch.no_grad():
                    for k, v in p.items():
                        v.copy_(saved[k])
            adapt(p, adam, proto, rx[c][None], torch.as_tensor(label, device=rx.device)[None])
    return {"errors": errors, "n_gated": n_gated, "pairs": pairs, "n_valid": n_valid,
            "params": {k: v.detach() for k, v in p.items()}}


def run_job(job: tuple) -> dict:
    """run() on plain data, for a worker process: job is (params, rx, tx,
    proto, draws, dtype name) with numpy arrays; the final params come
    back as arrays."""
    params, rx, tx, proto, draws, dtype = job
    dt = getattr(torch, dtype)
    out = run({k: torch.from_numpy(v).to(dt) for k, v in params.items()},
              torch.from_numpy(rx).to(dt), torch.from_numpy(tx), proto, draws)
    out["params"] = {k: v.numpy() for k, v in out["params"].items()}
    return out


def expected_pairs(gates: list[bool], proto: Protocol,
                   draws: Callable[[int, int, int], np.ndarray]) -> int:
    """The MAML pairs a run with these gates takes: at every candidate slot
    whose buffer holds more than two words, the distinct draws of each
    round at the fill's bound."""
    n_valid, pairs = 0, 0
    slot_of = {c: s for s, c in enumerate(meta_slots(proto, len(gates)))}
    for c, gate in enumerate(gates):
        n_valid = min(n_valid + gate, proto.buffer_capacity)
        if c in slot_of and n_valid > 2:
            pairs += sum(len(np.unique(draws(slot_of[c], it, max(n_valid - 2, 1))))
                         for it in range(proto.meta_iterations))
    return pairs
