"""The online by-word adaptation engine (the JAX package's online/engine.py;
reference python_code/trainers/trainer.py:267-354 `eval_by_word`).

For each of the transmission blocks: detect, RS-decode, score SER against
the true word, re-encode the decisions into a pseudo-label, gate on
`ser <= ser_thresh` into a buffer, periodically MAML-adapt from buffer
(support, query) pairs, and run self-supervised steps on the newest
confident word.

The rules of the JAX engine, kept here:
  - the buffer pseudo-label is the RAW detected word when 0 < ser <= thresh,
    and the re-encoded word when ser == 0 or for pilots (trainer.py:319-325);
  - one optimizer state is shared by online SGD and the meta outer step;
  - meta adaptation fires when `count % meta_subframes == 0 and count >=
    meta_subframes and n_valid > 2`, from the params `weights_init` names;
  - support indices wrap negatively through the buffer end at j_hat = 0,
    with mod-n_valid arithmetic;
  - the query draws of a meta iteration are deduplicated and sorted
    (torch.unique, trainer.py:336-338): duplicates perform no update;
  - SER is scored against the true transmitted word, and is the gate;
  - with an initial buffer (buffer_empty=False) the buffer starts full of
    train-channel words and stays full (a ring); an empty-start buffer past
    its capacity drops the oldest word;
  - META trainers restore the meta-initialised params before their
    self-supervised steps (metavnet_trainer.py:59).

The JAX engine is one `lax.scan` over blocks. Here the blocks run in a
Python loop with their tensors on the device, and the data-dependent gate is
a host branch: the engine reads each data block's SER back to the host,
one synchronisation per block (pilots need none), and skips the work a
closed gate or an idle meta slot would mask.

Each block's detect, RS decode, SER and pseudo-label are the JAX scan
body's `detect_decode_score`, a function of tensors here too
(`detect_decode_score`). On the card it is a CUDA graph, one for pilot and
one for data blocks, captured once per run and replayed once per block
(online/graphs.py); it reads the live params in place, so one capture
serves the whole run, across the meta events' restores. The buffer append
after it stays eager (two row copies). On the CPU the same function runs
directly.

The two step loops inside a block are the JAX engine's scans `sgd_steps`
and `meta_adapt`. On the card each of their steps is a CUDA graph, captured
once per run and replayed once per step; on the CPU the same step function
runs directly:
  - the self-supervised step (loss, gradient, optimizer update), replayed
    `self_supervised_iterations` times per gated block, its select_batch
    indices drawn for the whole block before the replays;
  - the MAML pair step (train/meta.py), replayed once per distinct query
    draw, its support and query rows copied into the graph's inputs.
The host keeps the optimizer's count and gives each step its bias
correction as a device tensor (train/optim.py::Optimizer.advance).

The self-supervised step for the meta loss (CE over states, no
subsampling) with Adam and no clipping, in f32, is instead ONE launch of
the fused kernel (kernels/online_sgd.py) per gated block, outside any
graph; any other loss, optimizer or compute dtype, and the LSTM family's
bit labels, runs the graphed step (the LSTM's through its cuDNN forward).
The MAML step goes through the spec's `meta_score`.
"""
from __future__ import annotations

import contextlib
import copy
import functools
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from metaviterbinet_tpu_torch.config import Config
from metaviterbinet_tpu_torch.ecc.rs import rs_decode_bits, rs_encode_bits
from metaviterbinet_tpu_torch.kernels.online_sgd import online_adapt_viterbinet
from metaviterbinet_tpu_torch.online.graphs import GraphedStep, device_rows
from metaviterbinet_tpu_torch.ops.trellis import calculate_states
from metaviterbinet_tpu_torch.train.loop import make_sgd_step
from metaviterbinet_tpu_torch.train.losses import make_loss_fn, select_batch
from metaviterbinet_tpu_torch.train.meta import make_maml_step, sorted_unique
from metaviterbinet_tpu_torch.train.optim import ADAM_B1, ADAM_B2, ADAM_EPS, Optimizer


class OnlineResult(NamedTuple):
    ser_by_word: np.ndarray   # [n_words] SER per block (0 at pilots)
    params: Any               # final adapted params (None for the VA)
    n_buffer: int             # final buffer fill
    n_gated: int              # blocks that passed the gate
    steps: dict               # steps taken by graphed step: "self_supervised", "maml"


class Draws:
    """The engine's random draws, each in stream order from the generators
    it is given: `host` (CPU) for the meta query draws, `device` for the
    select_batch indices and fresh params. The block `count` and the step
    within it are passed so that a test can replay another package's key
    stream instead."""

    def __init__(self, cfg: Config, spec, device: torch.device, generator: torch.Generator,
                 host_generator: torch.Generator):
        self.cfg, self.spec, self.device = cfg, spec, device
        self.generator, self.host_generator = generator, host_generator

    def j_hats(self, count: int, iteration: int, high: int) -> torch.Tensor:
        """meta_j_num query draws in [0, high), on the CPU."""
        return torch.randint(0, high, (self.cfg.meta_j_num,), generator=self.host_generator)

    def select(self, count: int, step: int, n: int) -> torch.Tensor:
        """select_batch indices over n labels for self-supervised step `step`."""
        return select_batch(n, self.cfg.train_minibatch_size, self.generator, self.device)

    def select_steps(self, count: int, n_steps: int, n: int) -> torch.Tensor:
        """[n_steps, train_minibatch_size]: the `select` draws of a block's
        steps, in step order, from the same generator."""
        return torch.stack([self.select(count, step, n) for step in range(n_steps)])

    def init_params(self, count: int):
        """Fresh params for weights_init='random'."""
        return self.spec.init(self.cfg, self.generator, self.device)


def make_self_supervised_step(loss_fn: Callable, optimizer: Optimizer) -> GraphedStep:
    """The engine's self-supervised step, a CUDA graph on the card:
    step(params, opt_state, rx [1, T], label [1, n], idx [B] or None, bc [2])
    takes one optimizer step on loss_fn(params, rx, label, idx) with the
    bias correction bc (Optimizer.advance), in place (train/loop.py::
    make_sgd_step)."""
    return make_sgd_step(loss_fn, optimizer, "self_supervised")


@torch.no_grad()
def detect_decode_score(detect: Callable, rx: torch.Tensor, tx: torch.Tensor, h: torch.Tensor,
                        nsym: int, use_ecc: bool, is_data: bool):
    """One block of the JAX engine's scan body (`detect_decode_score` in its
    online/engine.py): detect(rx [1, T], h [1, L]) -> [1, T] bits, RS-decode,
    score against the true word tx [n], and form the pseudo-label. Returns
    (ser, label, detected) on the device: the 0-d f32 SER (0 at a pilot),
    and [T] label and detected bits in the detected bits' dtype.

    ser is k * f32(1/n) for k symbol errors, the rounding of jnp.mean (not
    the k/n of torch.mean). The label is the raw detected word on a data
    block with 0 < ser, else the re-encoding of the decoded word (data) or
    of the true word (pilot)."""
    detected = detect(rx, h)[0]
    decoded = rs_decode_bits(detected[None], nsym)[0][0] if use_ecc else detected[:tx.shape[0]]
    if is_data:
        ser = (decoded != tx).sum().to(torch.float32) * float(np.float32(1.0 / tx.shape[0]))
        source = decoded
    else:
        ser = detected.new_zeros((), dtype=torch.float32)
        source = tx.to(decoded.dtype)
    encoded = rs_encode_bits(source[None], nsym)[0] if use_ecc else source
    label = torch.where(ser > 0, detected, encoded) if is_data else encoded
    return ser, label, detected


def make_block_scorer(cfg: Config, spec, model) -> Callable:
    """score(is_data, rx [1, T], tx [n], h [1, L]) -> detect_decode_score's
    (ser, label, detected) with the spec's engine detect on `model` (None
    for the VA), as two graphed calls, one per kind of block: the detect
    reads the model's params in place, the graphs' state."""
    p = spec.model.param_dict(model) if spec.trainable else {}

    detect = functools.partial(spec.engine_detect, model)

    def block(is_data: bool) -> GraphedStep:
        def fn(p, rx, tx, h):
            return detect_decode_score(detect, rx, tx, h, cfg.n_symbols, cfg.use_ecc, is_data)

        return GraphedStep(fn, "detect", n_state=1)

    graphed = {is_data: block(is_data) for is_data in (False, True)}
    return lambda is_data, rx, tx, h: graphed[is_data](p, rx, tx, h)


def _snapshot(params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in params.items()}


@torch.no_grad()
def _restore(params: dict[str, torch.Tensor], src: dict[str, torch.Tensor]) -> None:
    for k, p in params.items():
        p.copy_(src[k])


def uses_fused_adaptation(cfg: Config, spec) -> bool:
    """Whether the self-supervised step is one launch of the fused kernel:
    the meta loss (CE over states on all symbols) under Adam, unclipped, in
    f32. Under Config.dtype='bfloat16' the loss is over the bf16 score, as
    the JAX engine's is, and K6 computes an f32 one, so the autograd steps
    run instead."""
    return (spec.trainable and spec.label_kind == "states" and not spec.subsample_loss
            and cfg.loss_type == "CrossEntropy" and cfg.optimizer_type == "Adam"
            and not cfg.clip_grad_norm > 0 and cfg.dtype == "float32")


def run_online(cfg: Config, spec, params, tx_words: torch.Tensor, rx_words: torch.Tensor,
               h_words: torch.Tensor, draws: Draws, *, meta_init_params=None,
               init_buffer_rx: Optional[torch.Tensor] = None,
               init_buffer_tx: Optional[torch.Tensor] = None,
               spans: Callable[[str], Any] = contextlib.nullcontext) -> OnlineResult:
    """Run the online protocol over the blocks.

    tx_words [n_words, block_length] true info bits (SER scoring, pilots);
    rx_words [n_words, T] received samples; h_words [n_words, L] decoder-side
    CSI (the VA's only). `params` (a model of the spec's family, None for
    the VA) is copied, not changed. `spans(name)` is entered around each
    block's "detect" (detect, RS decode, SER, pseudo-label), "sync" (inside
    "detect": the read of the SER), "adapt" (self-supervision) and "meta"
    (meta adaptation), for timing."""
    n_words, T = rx_words.shape
    cap, L, w = cfg.buffer_capacity, cfg.memory_length, cfg.window_size
    subframes = cfg.subframes_in_frame
    thresh = np.float32(cfg.ser_thresh)
    trainable = spec.trainable
    meta = trainable and cfg.online_meta
    self_sup = trainable and cfg.self_supervised

    model = copy.deepcopy(params) if trainable else None
    p = spec.model.param_dict(model) if trainable else None
    score_block = make_block_scorer(cfg, spec, model)
    optimizer = opt_state = None
    if meta or self_sup:
        optimizer = Optimizer(cfg.optimizer_type, cfg.lr, cfg.clip_grad_norm)
        opt_state = optimizer.init(p)
        loss_fn = make_loss_fn(spec.score, spec.label_kind, L, spec.subsample_loss, cfg.loss_type)
    fused = self_sup and uses_fused_adaptation(cfg, spec)
    if self_sup and not fused:
        ss_step = make_self_supervised_step(loss_fn, optimizer)
    if meta:
        maml_loss_fn = make_loss_fn(spec.meta_score, spec.label_kind, L, spec.subsample_loss,
                                    cfg.loss_type)
        maml_step = make_maml_step(maml_loss_fn, optimizer, cfg.meta_lr, cfg.MAML)
        saved = _snapshot(p)
        meta_init = saved if meta_init_params is None \
            else _snapshot(spec.model.param_dict(meta_init_params))
        if cfg.weights_init not in ("last_frame", "random", "meta_training"):
            raise ValueError(f"No such weights init: {cfg.weights_init}")

    buf_rx = rx_words.new_zeros((cap, T))
    buf_tx = rx_words.new_zeros((cap, T))
    ring = init_buffer_rx is not None
    n_valid = 0
    if ring:
        n_valid = init_buffer_rx.shape[0]
        if n_valid > cap:
            raise ValueError(f"init buffer ({n_valid} words) exceeds buffer_capacity ({cap}); "
                             "raise Config.buffer_capacity")
        buf_rx[:n_valid] = init_buffer_rx
        buf_tx[:n_valid] = init_buffer_tx
    start = 0

    def meta_adapt() -> None:
        for iteration in range(cfg.meta_train_iterations):
            j_hats = sorted_unique(draws.j_hats(count, iteration, max(n_valid - 2, 1)))
            for j in j_hats.tolist():
                # rows by slicing, so that no index tensor is copied to the card
                phys_s = [(start + (j + d) % max(n_valid, 1)) % cap for d in range(-w, 0)]
                q = (start + j) % cap
                maml_step(p, opt_state, torch.cat([buf_rx[i:i + 1] for i in phys_s]),
                          torch.cat([buf_tx[i:i + 1] for i in phys_s]),
                          buf_rx[q:q + 1], buf_tx[q:q + 1])
                steps["maml"] += 1

    sers = np.zeros(n_words, dtype=np.float32)
    n_gated = 0
    steps = {"self_supervised": 0, "maml": 0}
    for count in range(n_words):
        rx, tx = rx_words[count:count + 1], tx_words[count]
        is_data = count % subframes != 0
        with spans("detect"):
            ser_t, label, _ = score_block(is_data, rx, tx, h_words[count:count + 1])
            if is_data:
                with spans("sync"):  # the block's one host sync
                    sers[count] = ser_t.item()
        ser = sers[count]
        gate = ser <= thresh
        if gate:
            n_gated += 1
            slot = (start + n_valid) % cap
            buf_rx[slot] = rx[0]
            buf_tx[slot] = label
            if ring:
                start = (start + 1) % cap
            else:
                if n_valid >= cap:
                    start = (start + 1) % cap
                n_valid = min(n_valid + 1, cap)

        if meta and count % cfg.meta_subframes == 0 and count >= cfg.meta_subframes \
                and n_valid > 2:
            with spans("meta"):
                if cfg.weights_init == "last_frame":
                    _restore(p, saved)
                elif cfg.weights_init == "random":
                    _restore(p, spec.model.param_dict(draws.init_params(count)))
                    opt_state = optimizer.init(p)
                else:
                    _restore(p, meta_init)
                meta_adapt()
                saved = _snapshot(p)

        if self_sup and gate:
            with spans("adapt"):
                if meta:
                    _restore(p, saved)
                if fused:
                    online_adapt_viterbinet(p, opt_state, rx[0], calculate_states(L, label[None]),
                                            cfg.self_supervised_iterations, cfg.lr,
                                            ADAM_B1, ADAM_B2, ADAM_EPS)
                else:
                    n_steps = cfg.self_supervised_iterations
                    idx = draws.select_steps(count, n_steps, T) if spec.subsample_loss \
                        else [None] * n_steps
                    bc = device_rows(optimizer.advance(opt_state, n_steps), rx.device)
                    for step in range(n_steps):
                        ss_step(p, opt_state, rx, label[None], idx[step], bc[step])
                    steps["self_supervised"] += n_steps

    return OnlineResult(ser_by_word=sers, params=model, n_buffer=n_valid, n_gated=n_gated,
                        steps=steps)
