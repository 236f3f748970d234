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
closed gate or an idle meta slot would mask. Removing that sync (masked
updates, CUDA graphs) is later work.

The self-supervised step for the meta loss (CE over states, no
subsampling) with Adam and no clipping, in f32, is ONE launch of the fused
kernel (kernels/online_sgd.py) per gated block; any other loss, optimizer
or compute dtype, and the LSTM family's bit labels, runs
`self_supervised_iterations` autograd steps (the LSTM's through its fused
forward). The MAML step goes through the spec's `meta_score`.
"""
from __future__ import annotations

import contextlib
import copy
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from metaviterbinet_tpu_torch.config import Config
from metaviterbinet_tpu_torch.ecc.rs import rs_decode_bits, rs_encode_bits
from metaviterbinet_tpu_torch.kernels.online_sgd import online_adapt_viterbinet
from metaviterbinet_tpu_torch.ops.trellis import calculate_states
from metaviterbinet_tpu_torch.train.losses import make_loss_fn, select_batch
from metaviterbinet_tpu_torch.train.meta import make_maml_step, sorted_unique
from metaviterbinet_tpu_torch.train.optim import ADAM_B1, ADAM_B2, ADAM_EPS, Optimizer


class OnlineResult(NamedTuple):
    ser_by_word: np.ndarray   # [n_words] SER per block (0 at pilots)
    params: Any               # final adapted params (None for the VA)
    n_buffer: int             # final buffer fill
    n_gated: int              # blocks that passed the gate


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

    def init_params(self, count: int):
        """Fresh params for weights_init='random'."""
        return self.spec.init(self.cfg, self.generator, self.device)


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
    block's "detect" (detect, RS decode, SER), "sync" (inside "detect": the
    read of the SER), "adapt" (self-supervision) and "meta" (meta
    adaptation), for timing."""
    n_words, T = rx_words.shape
    cap, L, w = cfg.buffer_capacity, cfg.memory_length, cfg.window_size
    nsym, subframes = cfg.n_symbols, cfg.subframes_in_frame
    thresh = np.float32(cfg.ser_thresh)
    trainable = spec.trainable
    meta = trainable and cfg.online_meta
    self_sup = trainable and cfg.self_supervised

    model = copy.deepcopy(params) if trainable else None
    p = spec.model.param_dict(model) if trainable else None
    optimizer = opt_state = None
    if meta or self_sup:
        optimizer = Optimizer(cfg.optimizer_type, cfg.lr, cfg.clip_grad_norm)
        opt_state = optimizer.init(p)
        loss_fn = make_loss_fn(spec.score, spec.label_kind, L, spec.subsample_loss, cfg.loss_type)
    fused = self_sup and uses_fused_adaptation(cfg, spec)
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

    sers = np.zeros(n_words, dtype=np.float32)
    n_gated = 0
    for count in range(n_words):
        rx, tx = rx_words[count:count + 1], tx_words[count]
        is_data = count % subframes != 0
        with spans("detect"):
            detected = spec.engine_detect(model, rx, h_words[count:count + 1])[0]
            decoded = rs_decode_bits(detected[None], nsym)[0][0] if cfg.use_ecc \
                else detected[:tx.shape[0]]
            if is_data:
                with spans("sync"):  # the block's one host sync
                    errors = int((decoded != tx).sum())
                # k * f32(1/n), the rounding of jnp.mean (not the k/n of torch.mean)
                sers[count] = np.float32(errors) * np.float32(1.0 / tx.shape[0])
        ser = sers[count]
        gate = ser <= thresh
        if gate:
            n_gated += 1
            if is_data and ser > 0:
                label = detected
            else:
                source = decoded if is_data else tx.to(decoded.dtype)
                label = rs_encode_bits(source[None], nsym)[0] if cfg.use_ecc else source
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
                    names = list(p)
                    for step in range(cfg.self_supervised_iterations):
                        idx = draws.select(count, step, T) if spec.subsample_loss else None
                        loss = loss_fn(p, rx, label[None], idx)
                        grads = torch.autograd.grad(loss, [p[k] for k in names])
                        optimizer.step(p, dict(zip(names, grads)), opt_state)

    return OnlineResult(ser_by_word=sers, params=model, n_buffer=n_valid, n_gated=n_gated)
