"""The by-word engine's graphed steps on the CPU, where they run directly:
each against the eager formulation it replaces, bit for bit (the same f32
operations in the same order, so no tolerance).

  - the optimizers with the bias correction gathered from the table at the
    device count (what a captured step runs) against the host rows of a
    count kept on the host, over 300 steps;
  - a run's select_batch draws made up front;
  - the engine's self-supervised chunk and the MAML pair step, vnet and
    lstm, against the eager loop of loss, gradient and Optimizer.step;
  - the offline word sweep through its graphed step, vnet and lstm, against
    the eager Optimizer.step loop over 300 words;
  - a graphed call whose state is a parameter dict or nothing (the engine's
    per-block detect), called directly.

Their card counterparts (a replayed graph against the same step called
directly) are in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

from metaviterbinet_tpu_torch import Config
from metaviterbinet_tpu_torch.detectors import DETECTORS
from metaviterbinet_tpu_torch.online.engine import Draws, make_adapt_step
from metaviterbinet_tpu_torch.online.graphs import GraphedStep
from metaviterbinet_tpu_torch.train.loop import word_sweep
from metaviterbinet_tpu_torch.train.losses import make_loss_fn, select_batch
from metaviterbinet_tpu_torch.train.meta import make_maml_step
from metaviterbinet_tpu_torch.train.optim import ADAM_B1, ADAM_B2, Optimizer, _bias_correction
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
L = 4


def _assert_state_equal(a: dict, b: dict, sa, sb) -> None:
    assert sa.count == sb.count
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for moments_a, moments_b in ((sa.mu, sb.mu), (sa.nu, sb.nu)):
        for k in moments_a:
            assert torch.equal(moments_a[k], moments_b[k]), k


def _twins(name: str, seed: int):
    """Two equal parameter dicts of the spec's family, from one seed."""
    spec = DETECTORS[name]
    return spec, [spec.model.param_dict(spec.init(Config(), torch.Generator().manual_seed(seed),
                                                  "cpu")) for _ in range(2)]


def _host_row(opt_type: str, count: int) -> tuple[float, float]:
    """The bias-correction factors of step `count` as a count kept on the
    host gives them: float32 reciprocals of optax's float32 1 - b^count
    (ones for RMSprop and SGD, which keep no count)."""
    if opt_type != "Adam":
        return 1.0, 1.0
    one = np.float32(1.0)
    return (float(one / np.float32(_bias_correction(ADAM_B1, count))),
            float(one / np.float32(_bias_correction(ADAM_B2, count))))


@pytest.mark.parametrize("opt_type", ["Adam", "RMSprop", "SGD"])
@pytest.mark.parametrize("clip", [0.0, 0.05])
def test_bias_correction_from_a_tensor_is_bit_equal_to_host_floats(opt_type, clip):
    """Optimizer.step, which gathers Adam's factors from the table at the
    device count and advances it there, against apply with the host row of
    each step's count, over 300 steps, with and without clipping."""
    rng = np.random.default_rng(3)
    params = {k: torch.tensor(rng.normal(size=shape).astype(np.float32))
              for k, shape in (("w", (50, 100)), ("b", (50,)))}
    twin = {k: v.clone() for k, v in params.items()}
    opt = Optimizer(opt_type, 1e-3, clip)
    host, dev = opt.init(params), opt.init(twin)
    for count in range(1, 301):
        grads = {k: torch.tensor((0.1 * rng.normal(size=v.shape)).astype(np.float32))
                 for k, v in params.items()}
        opt.apply(params, grads, host, _host_row(opt_type, count))
        opt.step(twin, grads, dev)
    assert dev.count.dtype == torch.int32 and dev.count.shape == ()
    assert int(dev.count) == (300 if opt_type == "Adam" else 0)
    host.count.fill_(int(dev.count))
    _assert_state_equal(params, twin, host, dev)


def test_a_blocks_select_draws_up_front_equal_one_per_step():
    """Draws.select_run: the select_batch indices of every step of every
    block, drawn at once: select_batch's law row by row (train_minibatch_size
    distinct indices in [1, n): index 0 has weight 0), the same rows from
    the same seed, and other rows for other blocks and steps."""
    cfg = Config()
    n_words, n_steps, T = 12, cfg.self_supervised_iterations, 136
    first, again = (Draws(cfg, DETECTORS["vnet"], CPU, torch.Generator().manual_seed(4),
                          torch.Generator()).select_run(n_words, n_steps, T) for _ in range(2))
    assert first.shape == (n_words, n_steps, cfg.train_minibatch_size)
    assert torch.equal(first, again)
    rows = first.reshape(-1, cfg.train_minibatch_size)
    assert int(rows.min()) >= 1 and int(rows.max()) < T
    assert all(len(set(r.tolist())) == cfg.train_minibatch_size for r in rows)
    assert len({tuple(r.tolist()) for r in rows}) == n_words * n_steps


def _words(n: int, T: int, seed: int):
    rng = np.random.default_rng(seed)
    return (torch.tensor(rng.normal(size=(n, T)).astype(np.float32)),
            torch.tensor(rng.integers(0, 2, size=(n, T)).astype(np.float32)))


@pytest.mark.parametrize("name", ["vnet", "lstm"])
def test_self_supervised_step_is_bit_equal_to_the_eager_loop(name):
    """The engine's block: its self-supervised chunk (make_adapt_step) in
    calls of 3 steps under an open gate, on the block's word and label and
    its rows of the draws up front; against the eager loop of per-step
    draws and Optimizer.step. A block with the gate closed changes
    nothing."""
    spec, (eager, graphed) = _twins(name, 5)
    cfg = Config(train_minibatch_size=8)
    T, n_steps, chunk = 24, 6, 3
    rx, label = _words(1, T, 6)
    loss_fn = make_loss_fn(spec.score, spec.label_kind, L, spec.subsample_loss)
    opt = Optimizer("Adam", 1e-3)
    s_eager, s_graphed = opt.init(eager), opt.init(graphed)
    select = Draws(cfg, spec, CPU, torch.Generator().manual_seed(7),
                   torch.Generator()).select_run(3, n_steps, T)
    adapt = make_adapt_step(cfg, opt, loss_fn, False, chunk)
    st = {"gate": torch.tensor(True), "rx": rx, "label": label}
    for block, gate in enumerate((True, False, True)):  # the count carried
        st["gate"].fill_(gate)
        if gate:
            for step in range(n_steps):
                loss = loss_fn(eager, rx, label, select[block, step])
                grads = torch.autograd.grad(loss, list(eager.values()))
                opt.step(eager, dict(zip(eager, grads)), s_eager)
        for first in range(0, n_steps, chunk):
            adapt(graphed, s_graphed, st, select[block, first:first + chunk])
    assert int(s_graphed.count) == 2 * n_steps
    _assert_state_equal(eager, graphed, s_eager, s_graphed)


@pytest.mark.parametrize("name", ["meta_vnet", "meta_lstm"])
@pytest.mark.parametrize("second_order", [True, False])
def test_maml_pair_step_is_bit_equal_to_the_eager_step(name, second_order):
    """make_maml_step (the graph's plain version on the CPU) against the
    eager pair step it replaced, three pairs from a carried Adam state,
    the returned query losses too."""
    spec, (eager, graphed) = _twins(name, 8)
    rx, tx = _words(4, 24, 9)
    loss_fn = make_loss_fn(spec.meta_score, spec.label_kind, L, False)
    opt = Optimizer("Adam", 1e-3)
    s_eager, s_graphed = opt.init(eager), opt.init(graphed)
    step = make_maml_step(loss_fn, opt, 0.1, second_order)
    for q in (1, 2, 3):
        support, query = (rx[q - 1:q], tx[q - 1:q]), (rx[q:q + 1], tx[q:q + 1])
        leaves = list(eager.values())
        inner = torch.autograd.grad(loss_fn(eager, *support), leaves, create_graph=second_order)
        updated = {k: p - 0.1 * g for (k, p), g in zip(eager.items(), inner)}
        want_loss = loss_fn(updated, *query)
        opt.step(eager, dict(zip(eager, torch.autograd.grad(want_loss, leaves))), s_eager)
        got_loss = step(graphed, s_graphed, *support, *query)
        assert torch.equal(got_loss, want_loss.detach())
    _assert_state_equal(eager, graphed, s_eager, s_graphed)


def test_a_step_on_the_cpu_is_a_direct_call():
    GraphedStep.counts.pop("cpu test", None)
    p = {"w": torch.zeros(3)}
    opt = Optimizer("SGD", 1.0)
    step = GraphedStep(lambda params, state, g, bc: opt.apply(params, {"w": g}, state, bc),
                       "cpu test")
    for _ in range(4):
        step(p, opt.init(p), torch.ones(3), torch.ones(2))
    assert torch.equal(p["w"], torch.full((3,), -4.0))
    assert GraphedStep.counts["cpu test"] == {"direct": 4, "warmup": 0, "capture": 0,
                                              "replay": 0}


@pytest.mark.parametrize("name", ["vnet", "lstm"])
def test_word_sweep_is_bit_equal_to_the_eager_step_loop(name):
    """train/loop.py::word_sweep, one graphed step per word (its plain
    version here), against the eager loop it replaced (loss, gradient,
    Optimizer.step per word) over 300 words with their select_batch draws:
    params, moments and the summed loss bit-equal."""
    spec, (eager, graphed) = _twins(name, 12)
    T, n_words = 24, 300
    rx, tx = _words(n_words, T, 13)
    loss_fn = make_loss_fn(spec.score, spec.label_kind, L, spec.subsample_loss)
    gen = torch.Generator().manual_seed(14)
    select = [select_batch(T, 8, gen) for _ in range(n_words)]
    opt = Optimizer("Adam", 1e-3)
    s_eager, s_graphed = opt.init(eager), opt.init(graphed)
    want = rx.new_zeros(())
    for i in range(n_words):
        loss = loss_fn(eager, rx[i:i + 1], tx[i:i + 1], select[i])
        grads = torch.autograd.grad(loss, list(eager.values()))
        opt.step(eager, dict(zip(eager, grads)), s_eager)
        want = want + loss.detach()
    GraphedStep.counts.pop("word_sweep", None)
    got = word_sweep(loss_fn, opt, graphed, s_graphed, rx, tx, select)
    assert GraphedStep.counts["word_sweep"]["direct"] == n_words
    assert torch.equal(got, want)
    _assert_state_equal(eager, graphed, s_eager, s_graphed)


@pytest.mark.parametrize("state", ["params", "none"])
def test_a_call_with_no_optimizer_state_on_the_cpu_is_a_direct_call(state):
    """A graphed call whose state is one parameter dict (the engine's
    detect of a trainable detector) or none (the VA's): on the CPU the
    function runs directly on the caller's tensors, each call."""
    GraphedStep.counts.pop("cpu detect", None)
    p = {"w": torch.tensor([2.0, -1.0])}
    args = (p,) if state == "params" else ()
    call = GraphedStep(lambda *a: (a[-1] * 3.0).sum(), "cpu detect", n_state=len(args))
    for i in range(3):
        x = torch.full((2,), float(i))
        assert torch.equal(call(*args, x), (x * 3.0).sum())
    assert GraphedStep.counts["cpu detect"] == {"direct": 3, "warmup": 0, "capture": 0,
                                                "replay": 0}
