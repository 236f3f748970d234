"""The by-word engine's graphed steps on the CPU, where they run directly:
each against the eager formulation it replaces, bit for bit (the same f32
operations in the same order, so no tolerance).

  - the optimizers with the bias correction read from a tensor
    (Optimizer.advance + apply, what a captured step runs) against the
    host floats of Optimizer.step, over 300 steps;
  - a block's select_batch draws made up front against one per step;
  - the self-supervised step and the MAML pair step, vnet and lstm,
    against the eager loop of loss, gradient and Optimizer.step;
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
from metaviterbinet_tpu_torch.online.engine import Draws, make_self_supervised_step
from metaviterbinet_tpu_torch.online.graphs import GraphedStep, device_rows
from metaviterbinet_tpu_torch.train.loop import word_sweep
from metaviterbinet_tpu_torch.train.losses import make_loss_fn, select_batch
from metaviterbinet_tpu_torch.train.meta import make_maml_step
from metaviterbinet_tpu_torch.train.optim import Optimizer
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


@pytest.mark.parametrize("opt_type", ["Adam", "RMSprop", "SGD"])
@pytest.mark.parametrize("clip", [0.0, 0.05])
def test_bias_correction_from_a_tensor_is_bit_equal_to_host_floats(opt_type, clip):
    rng = np.random.default_rng(3)
    params = {k: torch.tensor(rng.normal(size=shape).astype(np.float32))
              for k, shape in (("w", (50, 100)), ("b", (50,)))}
    twin = {k: v.clone() for k, v in params.items()}
    opt = Optimizer(opt_type, 1e-3, clip)
    host, dev = opt.init(params), opt.init(twin)
    for _ in range(300):
        grads = {k: torch.tensor((0.1 * rng.normal(size=v.shape)).astype(np.float32))
                 for k, v in params.items()}
        opt.step(params, grads, host)
        opt.apply(twin, grads, dev, device_rows(opt.advance(dev, 1), CPU)[0])
    assert host.count == (300 if opt_type == "Adam" else 0)
    _assert_state_equal(params, twin, host, dev)


def test_a_blocks_select_draws_up_front_equal_one_per_step():
    cfg = Config()
    n_steps, T = cfg.self_supervised_iterations, 136
    per_step, up_front = (Draws(cfg, DETECTORS["vnet"], CPU, torch.Generator().manual_seed(4),
                                torch.Generator()) for _ in range(2))
    want = torch.stack([per_step.select(0, step, T) for step in range(n_steps)])
    got = up_front.select_steps(0, n_steps, T)
    assert got.shape == (n_steps, cfg.train_minibatch_size)
    assert torch.equal(got, want)
    # and the stream is left where the per-step draws leave it
    assert torch.equal(up_front.select(1, 0, T), per_step.select(1, 0, T))


def _words(n: int, T: int, seed: int):
    rng = np.random.default_rng(seed)
    return (torch.tensor(rng.normal(size=(n, T)).astype(np.float32)),
            torch.tensor(rng.integers(0, 2, size=(n, T)).astype(np.float32)))


@pytest.mark.parametrize("name", ["vnet", "lstm"])
def test_self_supervised_step_is_bit_equal_to_the_eager_loop(name):
    """The engine's block: the draws up front, the bias corrections of the
    block's steps as one tensor, then the step per row; against the eager
    loop of per-step draws and Optimizer.step."""
    spec, (eager, graphed) = _twins(name, 5)
    cfg = Config(train_minibatch_size=8)
    T, n_steps = 24, 6
    rx, label = _words(1, T, 6)
    loss_fn = make_loss_fn(spec.score, spec.label_kind, L, spec.subsample_loss)
    opt = Optimizer("Adam", 1e-3)
    s_eager, s_graphed = opt.init(eager), opt.init(graphed)
    d_eager, d_graphed = (Draws(cfg, spec, CPU, torch.Generator().manual_seed(7),
                                torch.Generator()) for _ in range(2))
    ss_step = make_self_supervised_step(loss_fn, opt)
    for _ in range(2):  # two blocks, the count carried
        for step in range(n_steps):
            loss = loss_fn(eager, rx, label, d_eager.select(0, step, T))
            grads = torch.autograd.grad(loss, list(eager.values()))
            opt.step(eager, dict(zip(eager, grads)), s_eager)
        idx = d_graphed.select_steps(0, n_steps, T)
        bc = device_rows(opt.advance(s_graphed, n_steps), CPU)
        for step in range(n_steps):
            ss_step(graphed, s_graphed, rx, label, idx[step], bc[step])
    assert s_graphed.count == 2 * n_steps
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
