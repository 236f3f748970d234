"""Each driver run on the CPU at a tiny size through the program's plain
versions, with the harness's look for a card skipped: its check against
the reference comes out correct, and false with the timed path broken
underneath in each way the cell can break."""
import time

import pytest
import torch

from portbench.tests import tiny

CPU = torch.device("cpu")


def drive(name: str, traced: bool = False, seconds: float = 1.5):
    cell = tiny.cell(name)
    return cell, cell.driver().run(cell, 2**31 + 11, seconds, traced, CPU, time.time())


@pytest.mark.parametrize("traced", [False, True])
def test_byword_is_correct(one_thread, traced):
    cell, out = drive("viterbinet.meta", traced)
    assert out.correct, out.checks
    assert out.readings["pairs"] > 0 and out.readings["gated"] > 0
    assert out.e2e["blocks_per_s"] > 0 and out.e2e["block_p95_ms"] > 0 and out.e2e["setup_s"] > 0
    if traced:
        read = {m["name"]: cell.reader(m["name"]).read(out.layer) for m in cell.metrics(True)}
        assert read["detect_ms"] > 0 and read["maml_pair_ms"] > 0 and read["mfu.byword"] > 0
        # no card: nothing to read from a device trace
        assert read["k5_roofline"] is None and read["k6_roofline"] is None


@pytest.mark.parametrize("traced", [False, True])
def test_sweep_is_correct(one_thread, traced):
    cell, out = drive("lstm.train", traced, seconds=2.0)
    assert out.correct, out.checks
    assert out.e2e["train_words_per_s"] > 0
    if traced:
        assert cell.reader("sweep_step_ms").read(out.layer) > 0


def _k6_unchanged(params, opt_state, y, states, n_iters, *args, **kw):
    opt_state.count.add_(n_iters)


def _k6_half(params, opt_state, y, states, n_iters, *args, **kw):
    from metaviterbinet_tpu_torch.kernels import online_sgd

    half = y.shape[0] // 2
    online_sgd.online_adapt_viterbinet(params, opt_state, y[:half].contiguous(),
                                       states[:half].contiguous(), n_iters, *args, **kw)


def _ser_altered(original):
    def detect_decode_score(*args, **kw):
        ser, label, detected = original(*args, **kw)
        return ser + (1.0 / 120 if kw.get("is_data", args[-1]) else 0.0), label, detected
    return detect_decode_score


@pytest.mark.parametrize("fault", ["state unchanged", "half of the word", "answer altered"])
def test_byword_faults_are_caught(one_thread, monkeypatch, fault):
    from metaviterbinet_tpu_torch.online import engine

    if fault == "state unchanged":
        monkeypatch.setattr(engine, "online_adapt_viterbinet", _k6_unchanged)
    elif fault == "half of the word":
        monkeypatch.setattr(engine, "online_adapt_viterbinet", _k6_half)
    else:
        monkeypatch.setattr(engine, "detect_decode_score", _ser_altered(engine.detect_decode_score))
    _, out = drive("viterbinet.meta")
    assert not out.correct, out.checks


@pytest.mark.parametrize("fault", ["state unchanged", "half of the batch", "answer altered"])
def test_sweep_faults_are_caught(one_thread, monkeypatch, fault):
    from metaviterbinet_tpu_torch.train import loop, losses, optim

    if fault == "state unchanged":
        monkeypatch.setattr(optim.Optimizer, "apply", lambda self, p, g, state, bc=None: None)
    elif fault == "half of the batch":
        make = losses.make_loss_fn

        def half(*args, **kw):
            fn = make(*args, **kw)
            return lambda p, rx, tx, idx=None: fn(p, rx, tx, None if idx is None else idx[::2])
        monkeypatch.setattr(losses, "make_loss_fn", half)
    else:
        step = loop.sgd_step
        monkeypatch.setattr(loop, "sgd_step", lambda *a, **kw: step(*a, **kw) + 0.01)
    _, out = drive("lstm.train", seconds=1.0)
    assert not out.correct, out.checks
