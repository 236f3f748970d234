"""The port's training pieces against the JAX package's (CPU, small shapes):
optimizers against optax, losses and gradients, the per-word sweep, the MAML
step, sorted_unique_mask and the masked pair loop, checkpoints and
train-on-miss.

Inputs come from numpy seeds or the JAX streams; draws the JAX code makes
from a key (select_batch indices, query draws) are made with jax.random and
passed to the port. Tolerances: the port repeats the f32 arithmetic of the
JAX code in another summation order, so one update agrees to ~1 ulp (1e-7
absolute on values of order 1, 1e-6 relative), and a sweep of many steps
to 1e-5 absolute.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from metaviterbinet_tpu import config as jconfig
from metaviterbinet_tpu.models import lstm as jlstm
from metaviterbinet_tpu.models import viterbinet as jvnet
from metaviterbinet_tpu.train.losses import make_loss_fn as j_make_loss_fn
from metaviterbinet_tpu.train.losses import select_batch as j_select_batch
from metaviterbinet_tpu.train.loop import make_word_sweep
from metaviterbinet_tpu.train.meta import make_maml_step as j_make_maml_step
from metaviterbinet_tpu.train.meta import sorted_unique_mask
from metaviterbinet_tpu.train.optim import make_optimizer
from metaviterbinet_tpu_torch import Config
from metaviterbinet_tpu_torch.evaluation.trainer import Trainer
from metaviterbinet_tpu_torch.models import lstm as tlstm
from metaviterbinet_tpu_torch.models import viterbinet as tvnet
from metaviterbinet_tpu_torch.train.checkpoint import (
    load_checkpoint, save_config_provenance, save_params)
from metaviterbinet_tpu_torch.train.losses import make_loss_fn, select_batch
from metaviterbinet_tpu_torch.train.loop import word_sweep
from metaviterbinet_tpu_torch.train.meta import make_maml_step, make_pair_loop
from metaviterbinet_tpu_torch.train.meta import sorted_unique_mask as t_sorted_unique_mask
from metaviterbinet_tpu_torch.train.optim import Optimizer, OptState
from metaviterbinet_tpu_torch.weights import adam_state_from_jax, params_from_jax, params_to_numpy
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


S, L = 16, 4


def _jparams(seed=0):
    return jvnet.init_params(jax.random.PRNGKey(seed), S)


def _tparams(jp):
    model = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    return model, tvnet.param_dict(model)


def _words(n, T, seed, bits=None):
    rng = np.random.default_rng(seed)
    rx = rng.normal(size=(n, T)).astype(np.float32)
    tx = rng.integers(0, 2, size=(n, bits or T)).astype(np.float32)
    return rx, tx


def _close(got: dict, want: dict, atol, rtol=0.0):
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k].detach()), np.asarray(want[k]),
                                   atol=atol, rtol=rtol, err_msg=k)


# ------------------------------------------------------------------ optimizers

@pytest.mark.parametrize("opt_type", ["Adam", "RMSprop", "SGD"])
@pytest.mark.parametrize("clip", [0.0, 0.05])
def test_optimizer_updates_match_optax(opt_type, clip):
    """Three updates from a carried state: params and moments within 1 ulp
    of optax (the bias correction's float32 power and the divisions may
    round differently)."""
    jp = _jparams()
    rng = np.random.default_rng(1)
    grads = [{k: (0.1 * rng.normal(size=v.shape)).astype(np.float32) for k, v in jp.items()}
             for _ in range(3)]
    opt = make_optimizer(opt_type, 1e-2, clip)
    state = opt.init(jp)
    want = jp
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, want)
        want = optax.apply_updates(want, upd)
    _, tp = _tparams(jp)
    topt = Optimizer(opt_type, 1e-2, clip)
    tstate = topt.init(tp)
    for g in grads:
        topt.step(tp, {k: torch.tensor(v) for k, v in g.items()}, tstate)
    _close(tp, want, atol=1e-7, rtol=1e-6)
    if opt_type == "Adam":
        adam = state[-1][0] if clip else state[0]
        assert tstate.count == int(adam.count) == 3
        _close(tstate.mu, adam.mu, atol=1e-9, rtol=1e-6)
        _close(tstate.nu, adam.nu, atol=1e-12, rtol=1e-6)


def test_clipping_scales_only_above_the_norm():
    p = {"a": torch.zeros(3)}
    opt = Optimizer("SGD", 1.0, clip_grad_norm=1.0)
    opt.step(p, {"a": torch.tensor([3.0, 4.0, 0.0])}, opt.init(p))
    np.testing.assert_allclose(p["a"].numpy(), [-0.6, -0.8, 0.0], rtol=1e-6)
    opt.step(p, {"a": torch.tensor([0.3, 0.4, 0.0])}, opt.init(p))
    np.testing.assert_allclose(p["a"].numpy(), [-0.9, -1.2, 0.0], rtol=1e-6)


def test_unknown_optimizer_raises():
    with pytest.raises(NotImplementedError, match="Adagrad"):
        Optimizer("Adagrad", 1e-3)


# ------------------------------------------------------------------ losses

def test_select_batch_is_index_proportional_without_replacement():
    g = torch.Generator().manual_seed(0)
    draws = torch.stack([select_batch(120, 32, g) for _ in range(200)])
    assert (draws > 0).all() and (draws < 120).all()  # index 0 has weight 0
    assert all(len(set(row.tolist())) == 32 for row in draws)
    assert float(draws.float().mean()) > 70  # weights favour high indices (mean ~80)


@pytest.mark.parametrize("loss_type", ["CrossEntropy", "BCE", "MSE"])
@pytest.mark.parametrize("subsample", [True, False])
def test_loss_and_gradients_match_jax(loss_type, subsample):
    """120-bit labels against 136 symbols: the truncation and the select
    indices (the JAX draw) pick the same symbols in both packages."""
    jp = _jparams(2)
    rx, tx = _words(1, 136, 3, bits=120)
    key = jax.random.PRNGKey(4)
    jloss = j_make_loss_fn(jvnet.score, "states", L, subsample, 32, loss_type=loss_type)
    want, want_g = jax.value_and_grad(jloss)(jp, jnp.asarray(rx), jnp.asarray(tx), key)
    idx = torch.tensor(np.asarray(j_select_batch(key, 120, 32))) if subsample else None
    _, tp = _tparams(jp)
    loss = make_loss_fn(tvnet.logits, "states", L, subsample, loss_type)(
        tp, torch.tensor(rx), torch.tensor(tx), idx)
    grads = torch.autograd.grad(loss, list(tp.values()))
    assert abs(loss.detach().item() - float(want)) <= 1e-6 * max(1.0, abs(float(want)))
    _close(dict(zip(tp, grads)), want_g, atol=1e-7, rtol=1e-5)


def _lstm_params(seed):
    jp = jlstm.init_params(jax.random.PRNGKey(seed))
    model = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    return jp, tlstm.param_dict(model)


@pytest.mark.parametrize("score,subsample,loss_type", [
    ("logits", True, "CrossEntropy"), ("logits", False, "CrossEntropy"),
    ("logits", True, "BCE"), ("logits", False, "MSE"),
    ("logits_unrolled", True, "CrossEntropy"), ("logits_unrolled", False, "CrossEntropy")])
def test_lstm_loss_and_gradients_match_jax(score, subsample, loss_type):
    """The LSTM's bit labels (label_kind 'bits'), 40 labels against 48
    symbols, through either forward: loss and gradients within rtol 1e-4,
    atol 1e-7 of JAX, the contract JAX holds its two scan structures to
    (tests/test_models.py:47-70)."""
    jp, tp = _lstm_params(2)
    rx, tx = _words(1, 48, 3, bits=40)
    key = jax.random.PRNGKey(4)
    jloss = j_make_loss_fn(jlstm.score, "bits", L, subsample, 16, loss_type=loss_type)
    want, want_g = jax.value_and_grad(jloss)(jp, jnp.asarray(rx), jnp.asarray(tx), key)
    idx = torch.tensor(np.asarray(j_select_batch(key, 40, 16))) if subsample else None
    loss = make_loss_fn(getattr(tlstm, score), "bits", L, subsample, loss_type)(
        tp, torch.tensor(rx), torch.tensor(tx), idx)
    grads = torch.autograd.grad(loss, list(tp.values()))
    assert abs(loss.detach().item() - float(want)) <= 1e-6 * max(1.0, abs(float(want)))
    _close(dict(zip(tp, grads)), want_g, atol=1e-7, rtol=1e-4)


def test_subsampled_loss_needs_indices():
    _, tp = _tparams(_jparams())
    rx, tx = _words(1, 24, 0)
    with pytest.raises(ValueError, match="select_batch"):
        make_loss_fn(tvnet.logits, "states", L, True)(tp, torch.tensor(rx), torch.tensor(tx))


# ------------------------------------------------------------------ sweep + MAML

def test_word_sweep_matches_jax():
    """12 words, one Adam step each, with the JAX select_batch draws."""
    jp = _jparams(5)
    rx, tx = _words(12, 32, 6, bits=24)
    jloss = j_make_loss_fn(jvnet.score, "states", L, True, 8)
    opt = make_optimizer("Adam", 1e-3)
    key = jax.random.PRNGKey(7)
    want, _, want_loss = make_word_sweep(jloss, opt)(jp, opt.init(jp), jnp.asarray(rx),
                                                     jnp.asarray(tx), key)
    select = [torch.tensor(np.asarray(j_select_batch(k, 24, 8)))
              for k in jax.random.split(key, 12)]
    _, tp = _tparams(jp)
    topt = Optimizer("Adam", 1e-3)
    state = topt.init(tp)
    loss = word_sweep(make_loss_fn(tvnet.logits, "states", L, True), topt, tp, state,
                      torch.tensor(rx), torch.tensor(tx), select)
    assert state.count == 12
    assert abs(float(loss) - float(want_loss)) < 1e-4
    _close(tp, want, atol=1e-5)


@pytest.mark.parametrize("second_order", [True, False])
def test_maml_step_matches_jax(second_order):
    jp = _jparams(8)
    rx, tx = _words(3, 40, 9)
    jloss = j_make_loss_fn(jvnet.score, "states", L, False, 8)
    opt = make_optimizer("Adam", 1e-3)
    jstep = j_make_maml_step(jloss, opt, 0.1, second_order)
    state = opt.init(jp)
    want = jp
    _, tp = _tparams(jp)
    topt = Optimizer("Adam", 1e-3)
    tstate = topt.init(tp)
    tstep = make_maml_step(make_loss_fn(tvnet.logits, "states", L, False), topt, 0.1,
                           second_order)
    r, t = torch.tensor(rx), torch.tensor(tx)
    for q in (1, 2):
        want, state, wl = jstep(want, state, jnp.asarray(rx[q - 1:q]), jnp.asarray(tx[q - 1:q]),
                                jnp.asarray(rx[q:q + 1]), jnp.asarray(tx[q:q + 1]))
        got_l = tstep(tp, tstate, r[q - 1:q], t[q - 1:q], r[q:q + 1], t[q:q + 1])
        assert abs(float(got_l) - float(wl)) < 1e-5
    _close(tp, want, atol=1e-6)


def test_lstm_word_sweep_matches_jax():
    """The LSTM's word sweep: 6 words, one Adam step each on the
    subsampled bit loss through the fused forward, with the JAX draws.
    Params within 2e-5, 2% of one Adam step at lr 1e-3: Adam divides each
    gradient by its own running RMS, so an element whose gradient sums to
    near zero takes a step set by the rounding of that sum (measured on
    seeds 5-8: one element of b_hh1 1.4e-5 apart, every other one within
    8e-6)."""
    jp, tp = _lstm_params(5)
    rx, tx = _words(6, 32, 6, bits=24)
    jloss = j_make_loss_fn(jlstm.score, "bits", L, True, 8)
    opt = make_optimizer("Adam", 1e-3)
    key = jax.random.PRNGKey(7)
    want, _, want_loss = make_word_sweep(jloss, opt)(jp, opt.init(jp), jnp.asarray(rx),
                                                     jnp.asarray(tx), key)
    select = [torch.tensor(np.asarray(j_select_batch(k, 24, 8)))
              for k in jax.random.split(key, 6)]
    topt = Optimizer("Adam", 1e-3)
    state = topt.init(tp)
    loss = word_sweep(make_loss_fn(tlstm.logits, "bits", L, True), topt, tp, state,
                      torch.tensor(rx), torch.tensor(tx), select)
    assert state.count == 6
    assert abs(float(loss) - float(want_loss)) < 1e-4
    _close(tp, want, atol=2e-5)


@pytest.mark.parametrize("second_order", [True, False])
def test_lstm_maml_step_matches_jax(second_order):
    """meta_lstm's MAML step through the unrolled forward (the spec's
    meta_score), support and query of one 40-symbol coded word each, two
    steps from a carried Adam state: params within PARAMS_ATOL (1e-5) of
    JAX's make_maml_step, whose second order is jax.grad through jax.grad
    of the split scan."""
    from metaviterbinet_tpu_torch.detectors import DETECTORS
    jp, tp = _lstm_params(8)
    rx, tx = _words(3, 40, 9)
    jloss = j_make_loss_fn(jlstm.score, "bits", L, False, 8)
    opt = make_optimizer("Adam", 1e-3)
    jstep = j_make_maml_step(jloss, opt, 0.1, second_order)
    state = opt.init(jp)
    want = jp
    topt = Optimizer("Adam", 1e-3)
    tstate = topt.init(tp)
    tstep = make_maml_step(make_loss_fn(DETECTORS["meta_lstm"].meta_score, "bits", L, False),
                           topt, 0.1, second_order)
    r, t = torch.tensor(rx), torch.tensor(tx)
    for q in (1, 2):
        want, state, wl = jstep(want, state, jnp.asarray(rx[q - 1:q]), jnp.asarray(tx[q - 1:q]),
                                jnp.asarray(rx[q:q + 1]), jnp.asarray(tx[q:q + 1]))
        got_l = tstep(tp, tstate, r[q - 1:q], t[q - 1:q], r[q:q + 1], t[q:q + 1])
        assert abs(float(got_l) - float(wl)) < 1e-5
    _close(tp, want, atol=1e-5)


def test_maml_orders_differ():
    """The second-order term is really there: first- and second-order outer
    gradients give different params from the same start."""
    rx, tx = _words(2, 40, 10)
    out = []
    for second_order in (True, False):
        _, tp = _tparams(_jparams(11))
        opt = Optimizer("SGD", 1.0)
        step = make_maml_step(make_loss_fn(tvnet.logits, "states", L, False), opt, 0.5,
                              second_order)
        step(tp, opt.init(tp), torch.tensor(rx[:1]), torch.tensor(tx[:1]),
             torch.tensor(rx[1:]), torch.tensor(tx[1:]))
        out.append(tp["w2"].detach().clone())
    assert not torch.allclose(out[0], out[1], atol=1e-7)


def test_sorted_unique_matches_jax():
    """sorted_unique_mask on seeded draws: the sorted draws and the
    first-occurrence mask equal JAX's, and the fresh draws are torch.unique's
    (the reference's dedup)."""
    rng = np.random.RandomState(0)
    for _ in range(20):
        draws = rng.randint(0, rng.randint(1, 12), size=10)
        j, fresh = sorted_unique_mask(jnp.asarray(draws))
        got_j, got_fresh = t_sorted_unique_mask(torch.tensor(draws))
        np.testing.assert_array_equal(got_j.numpy(), np.asarray(j))
        np.testing.assert_array_equal(got_fresh.numpy(), np.asarray(fresh))
        np.testing.assert_array_equal(got_j[got_fresh].numpy(),
                                      torch.unique(torch.tensor(draws)).numpy())


@pytest.mark.parametrize("case,draws", [
    ("all equal", [4] * 10), ("all distinct", [9, 0, 3, 7, 1, 8, 2, 6, 5, 4]),
    ("bound 1", [0] * 10), ("one draw", [3]), ("two runs", [2, 5, 2, 5, 5, 2, 2, 5, 2, 5])])
def test_sorted_unique_mask_edge_cases_match_jax(case, draws):
    j, fresh = sorted_unique_mask(jnp.asarray(draws))
    got_j, got_fresh = t_sorted_unique_mask(torch.tensor(draws))
    assert got_j.dtype == torch.int64 and got_fresh.dtype == torch.bool
    np.testing.assert_array_equal(got_j.numpy(), np.asarray(j))
    np.testing.assert_array_equal(got_fresh.numpy(), np.asarray(fresh))
    assert int(got_fresh.sum()) == len(set(draws))


def _jax_run_pairs(loss_fn, opt, second_order, w):
    """The JAX package's masked pair loop, as Trainer.meta_train builds it
    (metaviterbinet_tpu/evaluation/trainer.py:366-392 there): JAX's
    sorted_unique_mask and make_maml_step under lax.cond in a scan."""
    maml_step = j_make_maml_step(loss_fn, opt, 0.1, second_order)

    @jax.jit
    def run_pairs(params, opt_state, rx, tx_coded, j_hats):
        j_hats, fresh = sorted_unique_mask(j_hats)

        def pair(carry, inp):
            j, is_fresh = inp

            def do_pair(c):
                params, opt_state = c
                supp = j + jnp.arange(-w, 0)
                params, opt_state, loss = maml_step(params, opt_state, rx[supp], tx_coded[supp],
                                                    rx[j[None]], tx_coded[j[None]])
                return (params, opt_state), loss

            return jax.lax.cond(is_fresh, do_pair, lambda c: (c, 0.0), carry)

        (params, opt_state), losses = jax.lax.scan(pair, (params, opt_state), (j_hats, fresh))
        return params, opt_state, jnp.sum(losses) / jnp.maximum(jnp.sum(fresh), 1)

    return run_pairs


# two minibatches of query draws, with duplicates
PAIR_DRAWS = ([5, 2, 5, 3, 2, 2], [4, 6, 6, 1, 4, 3])


@pytest.mark.parametrize("chunk", [1, 3])
@pytest.mark.parametrize("second_order", [True, False])
@pytest.mark.parametrize("family", ["vnet", "lstm"])
def test_masked_pair_loop_matches_jax_run_pairs(family, second_order, chunk):
    """train/meta.py::make_pair_loop (the pairs of a meta iteration: the
    draws sorted and masked, each pair under when(fresh), in graphed calls
    of `chunk` pairs) against the JAX scan body of sorted_unique_mask and
    make_maml_step under lax.cond, on the same words and duplicate draws
    over two minibatches from a carried Adam state: the loss within 1e-5,
    params within 1e-5 (the LSTM's bit labels through the unrolled
    forward, as test_lstm_maml_step_matches_jax), the count the fresh
    draws' and the device's pair count theirs."""
    from metaviterbinet_tpu_torch.detectors import DETECTORS
    w, n = 1, 8
    if family == "vnet":
        jp = _jparams(8)
        _, tp = _tparams(jp)
        rx, tx = _words(n, 24, 9)
        jloss = j_make_loss_fn(jvnet.score, "states", L, False, 8)
        tloss = make_loss_fn(tvnet.logits, "states", L, False)
    else:
        jp, tp = _lstm_params(8)
        rx, tx = _words(n, 24, 9)
        jloss = j_make_loss_fn(jlstm.score, "bits", L, False, 8)
        tloss = make_loss_fn(DETECTORS["meta_lstm"].meta_score, "bits", L, False)
    opt = make_optimizer("Adam", 1e-3)
    state = opt.init(jp)
    run_jax = _jax_run_pairs(jloss, opt, second_order, w)
    topt = Optimizer("Adam", 1e-3)
    tstate = topt.init(tp)
    run = make_pair_loop(tloss, topt, 0.1, second_order, w, chunk)
    st = {"rx": torch.tensor(rx), "tx": torch.tensor(tx), "loss": torch.zeros(()),
          "pairs": torch.zeros((), dtype=torch.int32)}
    want = jp
    for draws in PAIR_DRAWS:
        want, state, want_loss = run_jax(want, state, jnp.asarray(rx), jnp.asarray(tx),
                                         jnp.asarray(draws))
        loss = run(tp, tstate, st, torch.tensor(draws))
        assert loss.dtype == torch.float32 and loss.shape == ()
        assert abs(float(loss) - float(want_loss)) < 1e-5
        assert int(st["pairs"]) == len(set(draws))
    assert int(tstate.count) == int(state[0].count) == sum(len(set(d)) for d in PAIR_DRAWS)
    _close(tp, want, atol=1e-5)


def test_meta_train_matches_jax_run_pairs(tmp_path):
    """Trainer.meta_train against the JAX formulation of its minibatches:
    a twin Trainer of the same seeds replays the port's init, train words
    and host query draws (meta_j_num 6 over 10 words: duplicates likely),
    and the JAX run_pairs from the same params takes them; the saved
    checkpoint's params within 1e-5, its loss (the last minibatch's mean
    over the fresh draws) within 1e-5, and its Adam count the fresh draws'
    over all minibatches."""
    from metaviterbinet_tpu_torch.ecc.rs import rs_encode_bits
    cfg = Config(**dict(TINY, meta_j_num=6, train_minibatch_num=3))
    t = Trainer(cfg, "meta_vnet", device="cpu", weights_dir=str(tmp_path), verbose=False)
    t.meta_train()
    ck = load_checkpoint(str(tmp_path), 10.0, cfg.gamma, "cpu")

    twin = Trainer(cfg, "meta_vnet", device="cpu", weights_dir=str(tmp_path / "twin"),
                   verbose=False)
    jp = {k: jnp.asarray(v) for k, v in params_to_numpy(twin.init_params()).items()}
    opt = make_optimizer(cfg.optimizer_type, cfg.lr)
    state = opt.init(jp)
    run_jax = _jax_run_pairs(j_make_loss_fn(jvnet.score, "states", L, False, 8), opt, cfg.MAML,
                             cfg.window_size)
    n_words, fresh = cfg.n_words("train"), 0
    for _ in range(cfg.train_minibatch_num):
        tx, rx = twin.train_dataset.get(10.0, cfg.gamma)
        draws = torch.randint(cfg.window_size, n_words, (cfg.meta_j_num,),
                              generator=twin.host_generator)
        fresh += len(set(draws.tolist()))
        jp, state, loss = run_jax(jp, state, jnp.asarray(rx.numpy()),
                                  jnp.asarray(rs_encode_bits(tx, cfg.n_symbols).numpy()),
                                  jnp.asarray(draws.numpy()))
    assert fresh < cfg.meta_j_num * cfg.train_minibatch_num  # a duplicate was masked
    assert abs(ck["loss"] - float(loss)) < 1e-5
    assert int(ck["opt_state"].count) == int(state[0].count) == fresh
    _close(ck["params"], jp, atol=1e-5)


# ------------------------------------------------------------------ checkpoints

def test_checkpoint_round_trips_params_and_adam_state(tmp_path):
    jp = _jparams(12)
    opt = make_optimizer("Adam", 1e-3)
    state = opt.init(jp)
    g = jax.tree.map(lambda v: 0.01 * jnp.ones_like(v), jp)
    _, state = opt.update(g, state, jp)
    adam = state[0]
    tstate = adam_state_from_jax({k: np.asarray(v) for k, v in adam.mu.items()},
                                 {k: np.asarray(v) for k, v in adam.nu.items()},
                                 adam.count, device="cpu")
    model, tp = _tparams(jp)
    save_params(str(tmp_path), 10.0, 0.2, tp, 0.25, tstate)
    assert os.path.isfile(tmp_path / "snr_10.0_gamma_0.2.pt")
    ck = load_checkpoint(str(tmp_path), 10.0, 0.2, "cpu")
    assert ck["loss"] == 0.25 and ck["opt_state"].count == 1
    for k, v in jp.items():
        np.testing.assert_array_equal(ck["params"][k].numpy(), np.asarray(v))
        np.testing.assert_array_equal(ck["opt_state"].mu[k].numpy(), np.asarray(adam.mu[k]))
        np.testing.assert_array_equal(ck["opt_state"].nu[k].numpy(), np.asarray(adam.nu[k]))
    np.testing.assert_array_equal(params_to_numpy(tvnet.from_params(ck["params"], "cpu"))["w3"],
                                  np.asarray(jp["w3"]))
    assert load_checkpoint(str(tmp_path), 12.0, 0.2, "cpu") is None


def test_config_provenance_is_yaml_of_the_resolved_config(tmp_path):
    cfg = Config(val_SNR_start=7.0, weights_dir=str(tmp_path), eval_mode="by_word")
    path = save_config_provenance(str(tmp_path / "w"), cfg)
    with open(path) as f:
        loaded = yaml.safe_load(f)
    assert Config(**loaded) == cfg
    assert loaded == dataclasses.asdict(jconfig.Config(**loaded))  # the JAX package reads it too
    save_config_provenance(str(tmp_path / "w"), cfg.replace(val_SNR_start=9.0))  # kept once
    with open(path) as f:
        assert yaml.safe_load(f)["val_SNR_start"] == 7.0


TINY = dict(val_block_length=24, train_block_length=24, n_symbols=1, val_frames=2,
            subframes_in_frame=5, train_frames=2, train_minibatch_num=3,
            train_minibatch_size=8, meta_train_iterations=2, meta_j_num=2)


@pytest.mark.parametrize("name", ["vnet", "meta_vnet", "lstm", "meta_lstm"])
def test_train_on_miss_writes_a_checkpoint(tmp_path, name):
    """Train-on-miss writes the family's checkpoint (its JAX param names),
    which loads back as a model of that family."""
    cfg = Config(**TINY)
    t = Trainer(cfg, name, device="cpu", weights_dir=str(tmp_path), verbose=False)
    model = t.load_weights(10.0, cfg.gamma)  # a miss: trains first
    family = tlstm if "lstm" in name else tvnet
    assert isinstance(model, tlstm.WindowedLSTM if "lstm" in name else tvnet.ViterbiNet)
    ck = load_checkpoint(str(tmp_path), 10.0, cfg.gamma, "cpu")
    assert ck is not None and isinstance(ck["opt_state"], OptState) and ck["opt_state"].count > 0
    assert sorted(ck["params"]) == sorted(family.PARAM_NAMES)
    for k, v in params_to_numpy(model).items():
        np.testing.assert_array_equal(v, ck["params"][k].numpy(), err_msg=k)
    assert os.path.isfile(tmp_path / "config.yaml")
    # a second trainer loads it without training
    t2 = Trainer(cfg, name, device="cpu", weights_dir=str(tmp_path), verbose=False)
    mtime = os.path.getmtime(tmp_path / "snr_10.0_gamma_0.2.pt")
    again = t2.load_weights(10.0, cfg.gamma)
    assert os.path.getmtime(tmp_path / "snr_10.0_gamma_0.2.pt") == mtime
    for k, v in params_to_numpy(again).items():
        np.testing.assert_array_equal(v, ck["params"][k].numpy(), err_msg=k)


def test_vnet_training_pulls_below_chance(tmp_path):
    cfg = Config(**dict(TINY, train_frames=4, train_minibatch_num=8))
    t = Trainer(cfg, "vnet", device="cpu", weights_dir=str(tmp_path), verbose=False)
    model = t.train()
    assert t.single_eval_at_point(model, 10.0, cfg.gamma) < 0.35


def test_training_a_parameterless_detector_raises(tmp_path):
    with pytest.raises(NotImplementedError):
        Trainer(Config(**TINY), "va", device="cpu", weights_dir=str(tmp_path)).train()


# ------------------------------------------------------------------ bf16

@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_forward_matches_jax(seed):
    """Config.dtype='bfloat16': the port's bf16 forward against JAX
    viterbinet.score(..., compute_dtype=bfloat16). Both round each product,
    bias add and sigmoid op to bf16, so the logits agree to within one bf16
    ulp at their magnitude (2**-9 here, |logits| < 0.5) on at most 0.1% of
    entries, and the decoded bits to < 1e-3."""
    from metaviterbinet_tpu_torch.ops.trellis import viterbi_decode
    jp = _jparams(seed)
    _, tp = _tparams(jp)
    y, _ = _words(128, 40, seed + 2)
    want = np.asarray(jvnet.score(jp, jnp.asarray(y), compute_dtype=jnp.bfloat16))
    got = tvnet.logits(tp, torch.tensor(y), torch.bfloat16)
    assert got.dtype == torch.float32 and got.shape == want.shape
    diff = np.abs(got.detach().numpy() - want)
    assert diff.max() <= 2.0 ** -9 and np.mean(diff > 0) <= 1e-3
    bits = viterbi_decode(-got.detach()).numpy()
    assert np.mean(bits != np.asarray(jvnet.detect(jp, jnp.asarray(y), compute_dtype=jnp.bfloat16))) < 1e-3
    # and it is not the f32 forward
    assert not torch.equal(got, tvnet.logits(tp, torch.tensor(y)))


def test_bf16_loss_gradients_match_jax():
    """The bf16 forward is differentiable: CE over states through it gives
    JAX's gradient of its bf16 loss within 3% of each tensor's largest
    entry. The two backward passes round their bf16 products in different
    places: bf16 keeps 8 bits (0.4%), and the errors add over the 48
    symbols."""
    from metaviterbinet_tpu_torch.detectors import DETECTORS, with_compute_dtype
    from metaviterbinet_tpu.detectors import DETECTORS as JDETECTORS
    from metaviterbinet_tpu.detectors import with_compute_dtype as j_with_compute_dtype
    jp = _jparams(3)
    _, tp = _tparams(jp)
    rx, tx = _words(2, 24, 4)
    jspec = j_with_compute_dtype(JDETECTORS["meta_vnet"], "bfloat16")
    spec = with_compute_dtype(DETECTORS["meta_vnet"], "bfloat16")
    want = jax.grad(j_make_loss_fn(jspec.score, "states", L, False, 8))(
        jp, jnp.asarray(rx), jnp.asarray(tx))
    loss = make_loss_fn(spec.score, "states", L, False)(tp, torch.tensor(rx), torch.tensor(tx))
    grads = dict(zip(tp, torch.autograd.grad(loss, list(tp.values()))))
    for k, g in grads.items():
        assert g.dtype == torch.float32
        w = np.asarray(want[k])
        assert np.abs(g.numpy() - w).max() <= 3e-2 * np.abs(w).max(), k
