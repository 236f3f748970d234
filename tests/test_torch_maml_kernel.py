"""K7 (kernels/maml_pairs.py) on the CPU, where its wrapper runs its plain
version: the fused MAML pairs against autograd's pair step
(train/meta.py::maml_pair_step) at float64 and against the JAX package's
masked pair loop at float32, masked pairs, the engine's choice of path
(online/engine.py::uses_fused_maml), the wrapper's checks, and the
float64 witness the card holds K7 to.

Tolerances: at float64 the plain version and autograd compute the same
function by different routes (a hand-written backward and R pass against
autograd's double backward), so they agree to ~1e-14 of values of order
1; at float32 against JAX, as tests/test_torch_train.py's pair loop, to
1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from metaviterbinet_tpu.models import viterbinet as jvnet
from metaviterbinet_tpu.train.losses import make_loss_fn as j_make_loss_fn
from metaviterbinet_tpu.train.meta import make_maml_step as j_make_maml_step
from metaviterbinet_tpu.train.meta import sorted_unique_mask as j_sorted_unique_mask
from metaviterbinet_tpu.train.optim import make_optimizer
from metaviterbinet_tpu_torch import Config
from metaviterbinet_tpu_torch.detectors import DETECTORS, with_compute_dtype
from metaviterbinet_tpu_torch.kernels.maml_pairs import maml_pairs_viterbinet, smem_bytes
from metaviterbinet_tpu_torch.models import viterbinet as tvnet
from metaviterbinet_tpu_torch.online.engine import make_meta_steps, uses_fused_maml
from metaviterbinet_tpu_torch.ops.trellis import calculate_states
from metaviterbinet_tpu_torch.train.losses import make_loss_fn
from metaviterbinet_tpu_torch.train.meta import each_pair, maml_pair_step, masked_pairs
from metaviterbinet_tpu_torch.train.optim import Optimizer
from metaviterbinet_tpu_torch.weights import params_from_jax
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

S, L, T, META_LR, LR = 16, 4, 40, 0.1, 1e-3


def _logits64(params, y):
    """viterbinet.logits without its closing cast to float32, so that
    autograd runs the whole pair in the params' dtype."""
    x = torch.sigmoid(y.reshape(-1, 1) @ params["w1"].T + params["b1"])
    x = torch.relu(x @ params["w2"].T + params["b2"])
    return (x @ params["w3"].T + params["b3"]).reshape(y.shape[0], y.shape[1], -1)


def _words(n, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    tx = rng.integers(0, 2, size=(n, T)).astype(np.float32)
    rx = (1.0 - 2.0 * tx + 0.5 * rng.normal(size=(n, T))).astype(np.float32)
    return torch.tensor(rx).to(dtype), torch.tensor(tx)


def _params(seed, dtype=torch.float32):
    model = tvnet.init_params(S, torch.Generator().manual_seed(seed), device="cpu")
    return {k: v.detach().to(dtype=dtype, copy=True) for k, v in tvnet.param_dict(model).items()}


def _rows(st, j):
    """Support the word before each draw j, query word j (window 1)."""
    return st["rx"][j[:, None] - 1], st["tx"][j[:, None] - 1], st["rx"][j[:, None]], \
        st["tx"][j[:, None]]


def _fused(opt, second_order):
    """masked_pairs' `pairs` through K7's wrapper, as the engine's fused path
    calls it."""
    return chip_smoke.k7_pairs(maml_pairs_viterbinet, opt, second_order)


def _run(pairs_of, draws, rx, tx, p, dtype, chunk):
    """The draws' pairs from p and zero moments, `chunk` pairs a call of
    masked_pairs; returns (params, opt state, st)."""
    opt = Optimizer("Adam", LR)
    state = opt.init(p)
    st = {"rx": rx, "tx": tx, "loss": torch.zeros((), dtype=dtype),
          "pairs": torch.zeros((), dtype=torch.int32)}
    pairs = pairs_of(opt)
    for d in draws:
        d = torch.tensor(d)
        for first in range(0, d.shape[0], chunk):
            masked_pairs(pairs, _rows, p, state, st, d, torch.tensor([first]), chunk)
    return p, state, st


def _close(a: dict, b: dict, atol):
    for k in a:
        np.testing.assert_allclose(np.asarray(a[k].detach()), np.asarray(b[k].detach()),
                                   atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("case,draws", [("one pair", [[3]]),
                                        ("chunk of 10 with duplicates",
                                         [[5, 2, 5, 3, 2, 2, 7, 1, 7, 4], [6, 6, 1, 4, 3, 6, 2, 2, 5, 1]])])
@pytest.mark.parametrize("second_order", [True, False])
def test_plain_pairs_match_autograd_pair_step(second_order, case, draws):
    """K7's plain version at float64 against autograd's pair step on the
    same pairs (each under when(take[i])): params and moments within 1e-12,
    the summed query losses within 1e-12, and the Adam count and the pair
    count the distinct draws'."""
    rx, tx = _words(8, 1, torch.float64)
    loss_fn = make_loss_fn(_logits64, "states", L, False)
    fused = _run(lambda opt: _fused(opt, second_order), draws, rx, tx,
                 _params(2, torch.float64), torch.float64, len(draws[0]))
    auto_params = {k: v.requires_grad_(True) for k, v in _params(2, torch.float64).items()}
    auto = _run(lambda opt: each_pair(maml_pair_step(loss_fn, opt, META_LR, second_order)),
                draws, rx, tx, auto_params, torch.float64, len(draws[0]))
    distinct = sum(len(set(d)) for d in draws)
    for p, state, st in (fused, auto):
        assert int(state.count) == int(st["pairs"]) == distinct
    _close(fused[0], auto[0], 1e-12)
    _close(fused[1].mu, auto[1].mu, 1e-12)
    _close(fused[1].nu, auto[1].nu, 1e-12)
    assert abs(float(fused[2]["loss"]) - float(auto[2]["loss"])) < 1e-12
    assert any(not torch.equal(fused[0][k], _params(2, torch.float64)[k]) for k in fused[0])


def _jax_run_pairs(second_order):
    """The JAX package's masked pair loop (window 1), as Trainer.meta_train
    builds it there: sorted_unique_mask and make_maml_step under lax.cond in
    a scan (tests/test_torch_train.py::_jax_run_pairs)."""
    opt = make_optimizer("Adam", LR)
    step = j_make_maml_step(j_make_loss_fn(jvnet.score, "states", L, False, 8), opt, META_LR,
                            second_order)

    @jax.jit
    def run_pairs(params, opt_state, rx, tx, j_hats):
        j_hats, fresh = j_sorted_unique_mask(j_hats)

        def pair(carry, inp):
            j, is_fresh = inp

            def do_pair(c):
                params, opt_state = c
                params, opt_state, loss = step(params, opt_state, rx[j - 1][None], tx[j - 1][None],
                                               rx[j][None], tx[j][None])
                return (params, opt_state), loss

            return jax.lax.cond(is_fresh, do_pair, lambda c: (c, 0.0), carry)

        (params, opt_state), losses = jax.lax.scan(pair, (params, opt_state), (j_hats, fresh))
        return params, opt_state, jnp.sum(losses)

    return opt, run_pairs


@pytest.mark.parametrize("second_order", [True, False])
def test_plain_pairs_match_jax_run_pairs(second_order):
    """K7's plain version at float32 (the wrapper on CPU tensors) against
    the JAX package's pair loop on the same words and duplicate draws over
    two meta iterations from a carried Adam state: params within 1e-5, the
    summed query losses within 1e-5, the count the distinct draws'."""
    draws = ([5, 2, 5, 3, 2, 2, 7, 1, 7, 4], [6, 6, 1, 4, 3, 6, 2, 2, 5, 1])
    rx, tx = _words(8, 3)
    jp = jvnet.init_params(jax.random.PRNGKey(4), S)
    p = tvnet.param_dict(params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu"))
    p = {k: v.detach().clone() for k, v in p.items()}
    opt, run_pairs = _jax_run_pairs(second_order)
    state, want_loss = opt.init(jp), 0.0
    for d in draws:
        jp, state, loss = run_pairs(jp, state, jnp.asarray(rx.numpy()), jnp.asarray(tx.numpy()),
                                    jnp.asarray(d))
        want_loss += float(loss)
    got, got_state, st = _run(lambda o: _fused(o, second_order), draws, rx, tx, p, torch.float32,
                              10)
    assert int(got_state.count) == int(state[0].count) == sum(len(set(d)) for d in draws)
    assert abs(float(st["loss"]) - want_loss) < 1e-5
    for k in jp:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(jp[k]), atol=1e-5, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("masked", ["take false", "do_meta false"])
def test_masked_pairs_change_nothing(masked):
    """A pair not taken changes neither params, moments, the count, the pair
    count nor the loss: the wrapper with take all false, and the engine's
    fused pairs (make_meta_steps) at a fill of 2, where do_meta is false."""
    cfg = Config(val_block_length=24, n_symbols=1, meta_j_num=4, buffer_capacity=16)
    p = _params(5)
    opt = Optimizer("Adam", LR)
    state = opt.init(p)
    state.count.fill_(7)
    before = [t.clone() for t in (*p.values(), *state.mu.values(), *state.nu.values())]
    rx, tx = _words(16, 6)
    st = {"buf_rx": rx, "buf_tx": tx, "start": torch.tensor(3, dtype=torch.int32),
          "n_valid": torch.tensor(2, dtype=torch.int32), "pairs": torch.zeros((), dtype=torch.int32),
          "loss": torch.zeros(())}
    if masked == "take false":
        states = calculate_states(L, tx[:4])
        maml_pairs_viterbinet(p, state, opt.table(torch.device("cpu")), rx[:4],
                              states.reshape(4, T), rx[4:8], states.reshape(4, T).clone(),
                              torch.zeros(4, dtype=torch.bool), st["loss"], META_LR, LR, True)
    else:
        slot = cfg.meta_train_iterations * cfg.meta_j_num
        _, pairs, _ = make_meta_steps(cfg, opt, None, slot, fused=True)
        table = torch.zeros((cfg.meta_train_iterations, 14, 4), dtype=torch.int64)
        pairs(p, state, st, table, torch.tensor([0]))
    after = [*p.values(), *state.mu.values(), *state.nu.values()]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert int(state.count) == 7 and int(st["pairs"]) == 0 and float(st["loss"]) == 0.0


@pytest.mark.parametrize("fill", [2, 5, 24])
@pytest.mark.parametrize("second_order", [True, False])
def test_fused_slot_in_one_call_equals_its_iterations_launch_by_launch(second_order, fill):
    """make_meta_steps' fused pairs, a slot's 20 x 10 pairs in one call and
    one K7 call, against the same slot as 20 iterations of masked_pairs with
    a 10-pair K7 call each (chip_smoke.k7_iterations): params, moments,
    count, summed query loss and pair count torch.equal, at a fill of 2
    (do_meta false: nothing changes), 5 (bound 3: most draws repeat within
    an iteration) and a full ring of 24 started at slot 21. The table
    draws 0 twice in one iteration (taken once) and in two (taken in
    both): a variant that sorted the slot's draws across its iterations, or
    masked a value drawn in an earlier iteration, takes other pairs or
    takes them in another order, and fails."""
    cfg = Config(buffer_capacity=24, val_block_length=24, n_symbols=1, MAML=second_order)
    rx, tx = _words(24, 8)
    table = chip_smoke.k7_slot_table(cfg, torch.Generator().manual_seed(9))
    runs = []
    for one_call in (True, False):
        opt = Optimizer("Adam", cfg.lr)
        p = _params(10)
        state = opt.init(p)
        state.count.fill_(3)
        st = {"buf_rx": rx.clone(), "buf_tx": tx.clone(),
              "start": torch.tensor(21 if fill == 24 else 0, dtype=torch.int32),
              "n_valid": torch.tensor(fill, dtype=torch.int32),
              "pairs": torch.zeros((), dtype=torch.int32), "loss": torch.zeros(())}
        if one_call:
            _, pairs, _ = make_meta_steps(cfg, opt, None,
                                          cfg.meta_train_iterations * cfg.meta_j_num, fused=True)
            pairs(p, state, st, table, torch.tensor([0]))
        else:
            chip_smoke.k7_iterations(cfg, opt, p, state, st, table)
        runs.append([*p.values(), *state.mu.values(), *state.nu.values(), state.count,
                     st["loss"], st["pairs"]])
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    bound = max(fill - 2, 1)
    taken = sum(len(set(d.tolist())) for d in table[:, bound - 1]) if fill > 2 else 0
    assert int(runs[0][-1]) == int(runs[0][-3]) - 3 == taken
    assert taken == 0 or taken < cfg.meta_train_iterations * cfg.meta_j_num
    assert (taken > 0) == any(not torch.equal(a, b) for a, b in zip(runs[0][:6],
                                                                   _params(10).values()))


def test_fused_pairs_only_for_vnet_meta_loss_under_adam():
    cfg = Config()
    meta_vnet = DETECTORS["meta_vnet"]
    assert uses_fused_maml(cfg, meta_vnet)
    for kw in (dict(MAML=False), dict(weights_init="random"), dict(weights_init="meta_training")):
        assert uses_fused_maml(cfg.replace(**kw), meta_vnet)
    assert not uses_fused_maml(cfg, DETECTORS["meta_lstm"])   # unrolled LSTM, bit labels
    assert not uses_fused_maml(cfg, DETECTORS["vnet"])        # subsampled loss
    assert not uses_fused_maml(cfg, DETECTORS["va"])
    for kw in (dict(optimizer_type="RMSprop"), dict(loss_type="MSE"), dict(clip_grad_norm=1.0)):
        assert not uses_fused_maml(cfg.replace(**kw), meta_vnet)
    bf16 = cfg.replace(dtype="bfloat16")
    assert not uses_fused_maml(bf16, with_compute_dtype(meta_vnet, "bfloat16"))
    assert not uses_fused_maml(bf16, meta_vnet)


def test_k7_wrapper_validates_inputs():
    p = _params(0)
    opt = Optimizer("Adam", LR)
    state = opt.init(p)
    table = opt.table(torch.device("cpu"))
    rx = torch.zeros((3, T))
    states = torch.zeros((3, T), dtype=torch.int32)
    take, loss = torch.ones(3, dtype=torch.bool), torch.zeros(())
    args = (META_LR, LR, True)
    with pytest.raises(ValueError, match="int32"):
        maml_pairs_viterbinet(p, state, table, rx, states.float(), rx, states, take, loss, *args)
    with pytest.raises(ValueError, match="take"):
        maml_pairs_viterbinet(p, state, table, rx, states, rx, states, take[:2], loss, *args)
    with pytest.raises(ValueError, match=r"\[chunk, n\]"):
        maml_pairs_viterbinet(p, state, table, rx, states, rx[:2], states[:2], take, loss, *args)
    small = _params(0)
    small["w3"], small["b3"] = small["w3"][:6], small["b3"][:6]
    with pytest.raises(ValueError, match="1-100-50-S"):
        maml_pairs_viterbinet(small, state, table, rx, states, rx, states, take, loss, *args)
    # a CTA of the 16-CTA cluster holds ceil(n / 16) columns of each: the
    # engine's window of 1 at T = 136 fits, up to a window of 6; 7 does not
    assert smem_bytes(136, 136, 16) <= smem_bytes(6 * 136, 136, 16) <= 232448
    assert smem_bytes(7 * 136, 136, 16) > 232448


@pytest.mark.parametrize("fault", sorted(chip_smoke.K7_FAULTS))
def test_k7_witness_rejects_faulty_runs(fault):
    """The card's witness of K7 (chip_smoke.k7_witness, k7_witness_holds)
    on the CPU, where K7's wrapper runs its plain version, over the first 5
    iterations of a slot's pairs: it holds there, and fails when the run in
    K7's place leaves out the Hessian term or takes the duplicate draws
    (chip_smoke.K7_FAULTS)."""
    inputs = chip_smoke.k7_slot(chip_smoke.K7_WITNESS_SEEDS[0], "cpu")
    assert chip_smoke.k7_witness_holds(chip_smoke.k7_witness(*inputs, iterations=5))
    d = chip_smoke.k7_witness(*inputs, fault=chip_smoke.K7_FAULTS[fault], iterations=5)
    assert not chip_smoke.k7_witness_holds(d), d
