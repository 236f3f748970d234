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
  - the query draws of a meta iteration are sorted and their duplicates
    masked (torch.unique, trainer.py:336-338): duplicates perform no update;
  - SER is scored against the true transmitted word, and is the gate;
  - with an initial buffer (buffer_empty=False) the buffer starts full of
    train-channel words and stays full (a ring); an empty-start buffer past
    its capacity drops the oldest word;
  - META trainers restore the meta-initialised params before their
    self-supervised steps (metavnet_trainer.py:59).

The JAX engine is one `lax.scan` over blocks, its gate, buffer append,
meta slot and self-supervised loop `lax.cond`s inside it. Here the blocks
run in a Python loop that only enqueues work on the device: the gate, the
buffer and its fill, whether a meta slot fires, the SER of every block and
the counts of gated blocks and of MAML pair steps are device tensors (the
run state, a dict of tensors that the graphs hold), and the host reads
them once, at the end of the run (`OnlineResult.host_reads`). The host
decides only what the block count decides: pilot or data, and whether the
block is a candidate meta slot (`count % meta_subframes == 0` and `count >=
meta_subframes`). Every random draw of the run is made at its start
(`Draws`): the select_batch rows of every self-supervised step, and for
every candidate meta slot its query draws at every bound the buffer's fill
can set (`Draws.j_hat_table`) and, under weights_init='random', its fresh
params.

On the card each part of a block is a CUDA graph (online/graphs.py),
captured once per run and replayed once per block:
  - the block: detect, RS decode, SER and pseudo-label (the JAX scan body's
    `detect_decode_score`), the gate `ser <= ser_thresh`, the SER and gate
    count written to the run state, and the buffer append as device index
    arithmetic (`append`); one graph for pilot and one for data blocks,
    reading the live params in place, so one capture serves the whole run,
    across the meta slots' restores;
  - at a candidate meta slot, the JAX engine's `run_meta` under
    `lax.cond(do_meta)`, `do_meta = n_valid > 2` computed on the device:
    the restore that weights_init names under `when(do_meta)`; the MAML
    pair steps (train/meta.py) of the meta_train_iterations, each
    iteration's query draws those of the fill's bound `max(n_valid - 2,
    1)`, gathered on the device from the slot's table, sorted with their
    duplicates masked within the iteration, and the support and query rows
    gathered from the buffer by device index arithmetic: for ViterbiNet's
    f32 meta loss under Adam (`uses_fused_maml`) ONE graph of the slot's
    meta_train_iterations x meta_j_num pairs, every iteration's in order,
    one launch of the fused kernel (kernels/maml_pairs.py) under
    `when(do_meta)` that skips the duplicates itself; else, iteration by
    iteration, graphs of `chunk_steps(meta_j_num, MAML_NODES)` autograd
    pairs, pair i under `when(do_meta & fresh[i])`; then the saved params
    set to the adapted ones under `when(do_meta)`;
  - the self-supervised loop, the JAX engine's `sgd_steps` under
    `lax.cond(gate)`: its `self_supervised_iterations` steps (loss,
    gradient, optimizer update) as graphs of `chunk_steps` steps back to
    back, each under `when(gate)`, a CUDA graph IF node that the device
    takes or skips by the gate, with the block's select_batch rows as the
    chunk's input and Adam's bias correction read on the device by the
    optimizer's count (train/optim.py);
  - in a meta cell, the restore of the meta-adapted params before the
    self-supervised loop, under the same gate.
On the CPU the same functions run directly, `when` a host branch.

The self-supervised step for the meta loss (CE over states, no
subsampling) with Adam and no clipping, in f32, is instead ONE launch of
the fused kernel (kernels/online_sgd.py) per block under the gate's IF
node, which reads its start powers from the device count; any other loss,
optimizer or compute dtype, and the LSTM family's bit labels, runs the
autograd steps (the LSTM's through its cuDNN forward). Likewise a meta
slot's MAML pairs for that loss in f32, all its iterations', are one
launch of the fused kernel (kernels/maml_pairs.py) under the slot's IF
node (`uses_fused_maml`); any other MAML step goes through autograd on the
spec's `meta_score`, in graphs of a few pairs each (a slot's autograd
pairs would far exceed graphs.MAX_GRAPH_NODES).
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
from metaviterbinet_tpu_torch.kernels.maml_pairs import maml_pairs_viterbinet
from metaviterbinet_tpu_torch.kernels.online_sgd import online_adapt_viterbinet, power_table
from metaviterbinet_tpu_torch.models import viterbinet
from metaviterbinet_tpu_torch.online.graphs import GraphedStep, chunk_steps, when
from metaviterbinet_tpu_torch.ops.trellis import calculate_states
from metaviterbinet_tpu_torch.train.loop import sgd_step
from metaviterbinet_tpu_torch.train.losses import make_loss_fn
from metaviterbinet_tpu_torch.train.meta import each_pair, maml_pair_step, masked_pairs
from metaviterbinet_tpu_torch.train.optim import ADAM_B1, ADAM_B2, ADAM_EPS, Optimizer
from metaviterbinet_tpu_torch.utils import profiling


class OnlineResult(NamedTuple):
    ser_by_word: np.ndarray   # [n_words] SER per block (0 at pilots)
    params: Any               # final adapted params (None for the VA)
    n_buffer: int             # final buffer fill
    n_gated: int              # blocks that passed the gate
    steps: dict               # steps taken by graphed step: "self_supervised", "maml"
    # the loop's reads of device state: one, at the end of the run (on the
    # card the warm-up calls of its graphs read their gates too: the
    # tracer's "host_syncs" counts them all, utils/profiling.py)
    host_reads: int


class Draws:
    """The engine's random draws, each in stream order from the generators
    it is given: `host` (CPU) for the meta query draws, `device` for the
    select_batch indices and fresh params. The block `count` is passed so
    that a test can replay another package's key stream instead."""

    def __init__(self, cfg: Config, spec, device: torch.device, generator: torch.Generator,
                 host_generator: torch.Generator):
        self.cfg, self.spec, self.device = cfg, spec, device
        self.generator, self.host_generator = generator, host_generator

    def j_hat_table(self, counts: list[int]) -> torch.Tensor:
        """[len(counts), meta_train_iterations, n_bounds(cfg), meta_j_num]
        int64 on the device: for each candidate meta slot (its block count)
        and iteration, row b - 1 holds the meta_j_num query draws in [0, b),
        for every bound b the buffer's fill can give (`n_bounds`). The
        draws are torch.randint's on the host generator in slot and
        iteration order, the ones a draw of meta_j_num at each slot and
        iteration in turn makes at that bound: a draw below 2**28 takes one
        32-bit word a value whatever its bound, so one draw of them all from
        the same state per bound gives every row, and leaves the generator
        where the draws at one bound leave it."""
        cfg = self.cfg
        shape = (len(counts), cfg.meta_train_iterations, cfg.meta_j_num)
        state = self.host_generator.get_state()
        rows = []
        for high in range(1, n_bounds(cfg) + 1):
            self.host_generator.set_state(state)
            rows.append(torch.randint(0, high, shape, generator=self.host_generator))
        return profiling.upload(torch.stack(rows, dim=2), self.device)

    def select_run(self, n_words: int, n_steps: int, n: int) -> torch.Tensor:
        """[n_words, n_steps, train_minibatch_size]: the select_batch indices
        over n labels of every self-supervised step of every block, as the
        JAX engine draws a key for every block, gated or not; one batched
        draw (train/losses.py::select_batch's law, row by row)."""
        weights = torch.arange(n, dtype=torch.float32, device=self.device)
        rows = torch.multinomial(weights.repeat(n_words * n_steps, 1),
                                 self.cfg.train_minibatch_size, replacement=False,
                                 generator=self.generator)
        return rows.reshape(n_words, n_steps, -1)

    def init_params(self, count: int):
        """Fresh params for weights_init='random' at the meta slot of block
        `count`."""
        return self.spec.init(self.cfg, self.generator, self.device)


def n_bounds(cfg: Config) -> int:
    """The bounds `max(n_valid - 2, 1)` of a meta slot's query draws that a
    buffer of cfg.buffer_capacity words can give: 1 .. this."""
    return max(cfg.buffer_capacity - 2, 1)


def meta_slots(cfg: Config, n_words: int) -> list[int]:
    """The blocks of a run that are candidate meta slots."""
    return [c for c in range(n_words) if c % cfg.meta_subframes == 0 and c >= cfg.meta_subframes]


@torch.no_grad()
def detect_decode_score(detect: Callable, rx: torch.Tensor, tx: torch.Tensor, h: torch.Tensor,
                        nsym: int, use_ecc: bool, is_data: bool,
                        hold: Optional[contextlib.ExitStack] = None):
    """One block of the JAX engine's scan body (`detect_decode_score` in its
    online/engine.py): detect(rx [1, T], h [1, L]) -> [1, T] bits, RS-decode,
    score against the true word tx [n], and form the pseudo-label. Returns
    (ser, label, detected) on the device: the 0-d f32 SER (0 at a pilot),
    and [T] label and detected bits in the detected bits' dtype.

    ser is k * f32(1/n) for k symbol errors, the rounding of jnp.mean (not
    the k/n of torch.mean). The label is the raw detected word on a data
    block with 0 < ser, else the re-encoding of the decoded word (data) or
    of the true word (pilot).

    Three spans tile it: "detect.viterbi" (the detect), "detect.rs_decode"
    and "detect.label" (SER and label). With `hold`, "detect.label" is
    entered on it and stays open after the return, so that the caller's
    use of the label (the block graph's gate, state writes and append)
    falls within it."""
    with profiling.span("detect.viterbi"):
        detected = detect(rx, h)[0]
    with profiling.span("detect.rs_decode"):
        decoded = rs_decode_bits(detected[None], nsym)[0][0] if use_ecc else detected[:tx.shape[0]]
    with contextlib.ExitStack() as own:
        (own if hold is None else hold).enter_context(profiling.span("detect.label"))
        if is_data:
            ser = (decoded != tx).sum().to(torch.float32) * float(np.float32(1.0 / tx.shape[0]))
            source = decoded
        else:
            ser = detected.new_zeros((), dtype=torch.float32)
            source = tx.to(decoded.dtype)
        encoded = rs_encode_bits(source[None], nsym)[0] if use_ecc else source
        label = torch.where(ser > 0, detected, encoded) if is_data else encoded
    return ser, label, detected


@torch.no_grad()
def append(buf_rx: torch.Tensor, buf_tx: torch.Tensor, start: torch.Tensor, n_valid: torch.Tensor,
           rx: torch.Tensor, label: torch.Tensor, gate: torch.Tensor, ring: bool) -> None:
    """The JAX engine's buffer append under `lax.cond(gate)`, in place and
    on the device: rx [1, T] and label [1, T] into the slot (start +
    n_valid) % capacity where the 0-d bool `gate` holds; a ring (a buffer
    that started full) advances its start, an empty-start buffer grows its
    fill `n_valid` up to the capacity and past it drops its oldest word.
    start and n_valid are 0-d int32 tensors."""
    cap = buf_rx.shape[0]
    slot = ((start + n_valid) % cap).reshape(1).long()
    buf_rx.index_copy_(0, slot, torch.where(gate, rx, buf_rx.index_select(0, slot)))
    buf_tx.index_copy_(0, slot, torch.where(gate, label, buf_tx.index_select(0, slot)))
    if ring:
        start.copy_(torch.where(gate, (start + 1) % cap, start))
    else:
        start.copy_(torch.where(gate & (n_valid >= cap), (start + 1) % cap, start))
        n_valid.copy_(torch.where(gate, torch.clamp(n_valid + 1, max=cap), n_valid))


def make_block_step(cfg: Config, spec, model, ring: bool) -> Callable:
    """block(is_data, p, st, rx [1, T], tx [n], h [1, L]): one block of the
    JAX scan body up to the meta slot, on the run state `st` (run_online):
    detect_decode_score with the spec's engine detect on `model` (None for
    the VA) and its params `p`, the gate, the block's SER and the gate's
    count, the block's word and label kept for its adaptation, and the
    buffer append. Two graphed calls, one per kind of block."""
    detect = functools.partial(spec.engine_detect, model)
    thresh = float(np.float32(cfg.ser_thresh))

    def block(is_data: bool) -> GraphedStep:
        def fn(p, st, rx, tx, h):
            with contextlib.ExitStack() as label_span:  # "detect.label", to the block's end
                ser, label, _ = detect_decode_score(detect, rx, tx, h, cfg.n_symbols,
                                                    cfg.use_ecc, is_data, hold=label_span)
                label = label[None].to(st["label"].dtype)
                gate = ser <= thresh
                st["gate"].copy_(gate)
                st["sers"].index_copy_(0, st["block"].reshape(1), ser.reshape(1))
                st["block"].add_(1)
                st["n_gated"].add_(gate)
                st["rx"].copy_(rx)
                st["label"].copy_(label)
                append(st["buf_rx"], st["buf_tx"], st["start"], st["n_valid"], rx, label, gate,
                       ring)

        return GraphedStep(fn, "block", n_state=2)

    graphed = {is_data: block(is_data) for is_data in (False, True)}
    return lambda is_data, *args: graphed[is_data](*args)


def make_adapt_step(cfg: Config, optimizer: Optimizer, loss_fn: Optional[Callable], fused: bool,
                    chunk: int) -> GraphedStep:
    """The self-supervised loop of a block under its gate, a graphed call
    on (p, opt_state, st): with `fused`, adapt(p, opt_state, st) is one
    launch of the fused kernel for all self_supervised_iterations steps;
    else adapt(p, opt_state, st, idx [chunk, B] or None) takes `chunk`
    autograd steps on the block's word and label, step i on idx[i]."""
    L = cfg.memory_length

    def adapt_fused(p, opt_state, st):
        online_adapt_viterbinet(p, opt_state, st["rx"][0], calculate_states(L, st["label"]),
                                cfg.self_supervised_iterations, cfg.lr, ADAM_B1, ADAM_B2, ADAM_EPS)

    def steps(p, opt_state, st, idx):
        for i in range(chunk):
            sgd_step(loss_fn, optimizer, p, opt_state, st["rx"], st["label"],
                     None if idx is None else idx[i])

    if fused:
        return GraphedStep(lambda p, o, st: when(st["gate"], adapt_fused, p, o, st),
                           "self_supervised", n_state=3)
    return GraphedStep(lambda p, o, st, idx: when(st["gate"], steps, p, o, st, idx),
                       "self_supervised", n_state=3)


def make_meta_steps(cfg: Config, optimizer: Optimizer, loss_fn: Callable, chunk: int,
                    fused: bool = False) -> tuple[GraphedStep, GraphedStep, GraphedStep]:
    """The JAX engine's `run_meta` under `lax.cond(do_meta)`, `do_meta =
    n_valid > 2` read from the run state `st` on the device, as three
    graphed calls:
      - restore(p, opt_state, st, src): p <- src, the params weights_init
        names, and under weights_init='random' a fresh optimizer state;
      - pairs(p, opt_state, st, table [meta_train_iterations, n_bounds,
        meta_j_num], first [1]): the MAML pairs (masked_pairs) first ..
        first + chunk - 1 of a slot's, its iterations' (each a
        `meta_adapt`) in order, each iteration's query draws the table's
        row at the fill's bound `max(n_valid - 2, 1)`, sorted and masked
        within the iteration, the pairs taken where `do_meta & fresh` holds
        on the buffer's rows: with `fused`, the chunk as one launch of the
        fused kernel under `when(do_meta)` (loss_fn unused), else each pair
        under `when(do_meta & fresh)` (each_pair);
      - save(saved, p, st): saved <- p."""
    cap, w, L = cfg.buffer_capacity, cfg.window_size, cfg.memory_length
    reset = cfg.weights_init == "random"

    def do_meta(st):
        return st["n_valid"] > 2

    def rows(st, j):
        # the window before each logical slot j, wrapping negatively through
        # the fill, and slot j, as physical slots of the ring
        logical = (j[:, None] + torch.arange(-w, 0, device=j.device)) \
            % torch.clamp(st["n_valid"], min=1)
        support, query = (st["start"] + logical) % cap, (st["start"] + j[:, None]) % cap
        return st["buf_rx"][support], st["buf_tx"][support], st["buf_rx"][query], st["buf_tx"][query]

    def labels(tx):
        # [pairs, rows, T] words -> [pairs, rows * T] trellis states, word by word
        return calculate_states(L, tx.reshape(-1, tx.shape[-1])).reshape(tx.shape[0], -1)

    def fused_pairs(p, opt_state, st, take, s_rx, s_tx, q_rx, q_tx):
        n = take.shape[0]
        when(do_meta(st), maml_pairs_viterbinet, p, opt_state, optimizer.table(take.device),
             s_rx.reshape(n, -1), labels(s_tx), q_rx.reshape(n, -1), labels(q_tx), take,
             st["loss"], cfg.meta_lr, optimizer.lr, cfg.MAML)

    chunk_pairs = fused_pairs if fused else each_pair(
        maml_pair_step(loss_fn, optimizer, cfg.meta_lr, cfg.MAML))

    def pairs(p, opt_state, st, table, first):
        bound = torch.clamp(st["n_valid"] - 2, min=1)
        j_hats = table.index_select(1, (bound - 1).reshape(1).long())[:, 0]
        masked_pairs(chunk_pairs, rows, p, opt_state, st, j_hats, first, chunk, do_meta(st))

    def init(p, opt_state, src):
        _restore(p, src)
        if reset:
            optimizer.init(p, out=opt_state)

    return (GraphedStep(lambda p, o, st, src: when(do_meta(st), init, p, o, src), "meta_restore",
                        n_state=4),
            GraphedStep(pairs, "maml", n_state=3),
            GraphedStep(lambda saved, p, st: when(do_meta(st), _restore, saved, p), "meta_save",
                        n_state=3))


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


def uses_fused_maml(cfg: Config, spec) -> bool:
    """Whether a meta slot's pairs are launches of the fused kernel
    (kernels/maml_pairs.py): ViterbiNet's meta loss (CE over states on all
    symbols through its f32 forward, `viterbinet.logits`) under Adam,
    unclipped, in f32. The LSTM family's loss runs through its unrolled
    recurrence, and under Config.dtype='bfloat16' ViterbiNet's through the
    bf16 forward, as the JAX engine's is: autograd pairs."""
    return (spec.meta_score is viterbinet.logits and spec.label_kind == "states"
            and not spec.subsample_loss and cfg.loss_type == "CrossEntropy"
            and cfg.optimizer_type == "Adam" and not cfg.clip_grad_norm > 0
            and cfg.dtype == "float32")


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
    block's "detect" (detect, RS decode, SER, pseudo-label, gate, append),
    "adapt" (self-supervision, under the gate) and "meta" (a candidate meta
    slot's adaptation, under do_meta), and around the run's one host read,
    "sync", for timing. On the card a span's host clock measures the
    enqueue: the device runs behind the host until the read.

    Where a tracer is active (utils/profiling.py) the run is one of its
    runs: the same spans, a "start" span (the run's draws, snapshots and
    graphs, up to the first block), the graphed calls' and the block
    graph's spans within them, and the run's host syncs and uploaded bytes
    go to it as well."""
    args = (cfg, spec, params, tx_words, rx_words, h_words, draws, meta_init_params,
            init_buffer_rx, init_buffer_tx, spans)
    tracer = profiling._active
    if tracer is None:
        return _run_online(*args)
    with tracer.run():
        return _run_online(*args)


def _run_online(cfg: Config, spec, params, tx_words: torch.Tensor, rx_words: torch.Tensor,
                h_words: torch.Tensor, draws: Draws, meta_init_params,
                init_buffer_rx: Optional[torch.Tensor], init_buffer_tx: Optional[torch.Tensor],
                spans: Callable[[str], Any]) -> OnlineResult:
    # the run's set-up: draws, snapshots, graphs and run state
    with profiling.span("start"):
        n_words, T = rx_words.shape
        cap, L = cfg.buffer_capacity, cfg.memory_length
        subframes = cfg.subframes_in_frame
        trainable = spec.trainable
        meta = trainable and cfg.online_meta
        self_sup = trainable and cfg.self_supervised
        device = rx_words.device

        model = copy.deepcopy(params) if trainable else None
        p = spec.model.param_dict(model) if trainable else {}
        ring = init_buffer_rx is not None
        block_step = make_block_step(cfg, spec, model, ring)
        graphed = []
        optimizer = opt_state = select = None
        if meta or self_sup:
            optimizer = Optimizer(cfg.optimizer_type, cfg.lr, cfg.clip_grad_norm)
            opt_state = optimizer.init(p)
            loss_fn = make_loss_fn(spec.score, spec.label_kind, L, spec.subsample_loss,
                                   cfg.loss_type)
        fused = self_sup and uses_fused_adaptation(cfg, spec)
        if self_sup:
            n_steps = cfg.self_supervised_iterations
            chunk = n_steps if fused else chunk_steps(n_steps, spec.model.STEP_NODES)
            adapt = make_adapt_step(cfg, optimizer, loss_fn, fused, chunk)
            graphed.append(adapt)
            if fused and device.type == "cuda":
                power_table(ADAM_B1, ADAM_B2, device)  # uploaded before a capture
            if spec.subsample_loss and not fused:
                select = draws.select_run(n_words, n_steps, T)
        if meta:
            if cfg.weights_init not in ("last_frame", "random", "meta_training"):
                raise ValueError(f"No such weights init: {cfg.weights_init}")
            maml_loss_fn = make_loss_fn(spec.meta_score, spec.label_kind, L, spec.subsample_loss,
                                        cfg.loss_type)
            saved = _snapshot(p)
            restore = GraphedStep(lambda p, saved, st: when(st["gate"], _restore, p, saved),
                                  "restore", n_state=3)
            # the run's draws for every candidate meta slot, made now
            slot_of = {c: i for i, c in enumerate(meta_slots(cfg, n_words))}
            table = draws.j_hat_table(list(slot_of))
            if cfg.weights_init == "random":
                drawn = [_snapshot(spec.model.param_dict(draws.init_params(c))) for c in slot_of]
                src = _snapshot(p)  # each slot's fresh params are copied in
            elif cfg.weights_init == "last_frame":
                src = saved
            else:  # the meta-trained params, by default the run's first
                src = _snapshot(p if meta_init_params is None
                                else spec.model.param_dict(meta_init_params))
            fused_maml = uses_fused_maml(cfg, spec)
            # a slot's pairs in one graphed call (one launch) for the fused
            # kernel; autograd's in graphs of a few of an iteration's pairs,
            # since a slot's would far exceed graphs.MAX_GRAPH_NODES
            slot_pairs = cfg.meta_train_iterations * cfg.meta_j_num
            meta_chunk = slot_pairs if fused_maml else chunk_steps(cfg.meta_j_num,
                                                                   spec.model.MAML_NODES)
            firsts = torch.arange(0, slot_pairs, meta_chunk, device=device)
            meta_restore, meta_pairs, meta_save = make_meta_steps(cfg, optimizer, maml_loss_fn,
                                                                  meta_chunk, fused_maml)
            graphed += [meta_restore, meta_pairs, meta_save]

        # the run state: what the JAX scan carries besides params and
        # optimizer state, and the per-block results, on the device
        int0 = lambda: torch.zeros((), dtype=torch.int32, device=device)
        st = {"buf_rx": rx_words.new_zeros((cap, T)), "buf_tx": rx_words.new_zeros((cap, T)),
              "start": int0(), "n_valid": int0(), "n_gated": int0(), "pairs": int0(),
              "loss": torch.zeros((), dtype=torch.float32, device=device),
              "gate": torch.zeros((), dtype=torch.bool, device=device),
              "block": torch.zeros((), dtype=torch.int64, device=device),
              "sers": torch.zeros(n_words, dtype=torch.float32, device=device),
              "rx": rx_words.new_zeros((1, T)), "label": rx_words.new_zeros((1, T))}
        if ring:
            n0 = init_buffer_rx.shape[0]
            if n0 > cap:
                raise ValueError(f"init buffer ({n0} words) exceeds buffer_capacity ({cap}); "
                                 "raise Config.buffer_capacity")
            st["buf_rx"][:n0] = init_buffer_rx
            st["buf_tx"][:n0] = init_buffer_tx
            st["n_valid"].fill_(n0)

    for count in range(n_words):
        with profiling.span("detect", spans):
            block_step(count % subframes != 0, p, st, rx_words[count:count + 1], tx_words[count],
                       h_words[count:count + 1])

        if meta and count in slot_of:
            s = slot_of[count]
            with profiling.span("meta", spans):
                if cfg.weights_init == "random":
                    _restore(src, drawn[s])
                meta_restore(p, opt_state, st, src)
                for c in range(firsts.shape[0]):
                    meta_pairs(p, opt_state, st, table[s], firsts[c:c + 1])
                meta_save(saved, p, st)

        if self_sup:
            with profiling.span("adapt", spans):
                if meta:
                    restore(p, saved, st)
                if fused:
                    adapt(p, opt_state, st)
                else:
                    for first in range(0, n_steps, chunk):
                        adapt(p, opt_state, st, None if select is None
                              else select[count, first:first + chunk])

    with profiling.span("sync", spans):  # the run's one read: SERs, counts, conditional launches
        hits = [h for g in graphed for h, _ in g.conditional]
        ints = torch.stack([st["n_gated"], st["n_valid"], st["pairs"], *hits]).to(torch.float32)
        read = profiling.host_read(torch.cat([st["sers"], ints])).numpy()
    sers = read[:n_words]
    n_gated, n_valid, pairs, *hits = (int(v) for v in read[n_words:])
    for g in graphed:
        g.settle([hits.pop(0) for _ in g.conditional])
    steps = {"self_supervised": n_gated * n_steps if self_sup and not fused else 0,
             "maml": pairs}
    return OnlineResult(ser_by_word=sers, params=model, n_buffer=n_valid, n_gated=n_gated,
                        steps=steps, host_reads=1)
