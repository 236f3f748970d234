"""The by-word engine's state on the device, on the CPU: Adam's count as a
0-d int32 tensor and its factor table, K6's start-power table and its plain
version from a device count, the buffer append as index arithmetic, `when`,
the loop's host reads, the chunked word sweep, and the count through
checkpoints.

The tables are held bit for bit to the host expressions they replace, so
no tolerance there; K6's plain version against the JAX kernel keeps the JAX
contract of tests/test_online_sgd_kernel.py (5e-6 after 40 steps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hs

from metaviterbinet_tpu.models import viterbinet as jvnet
from metaviterbinet_tpu.train import checkpoint as jcheckpoint
from metaviterbinet_tpu.train.optim import make_optimizer
from metaviterbinet_tpu_torch import Config
from metaviterbinet_tpu_torch.detectors import DETECTORS
from metaviterbinet_tpu_torch.kernels.online_sgd import (
    _start_powers, online_adapt_viterbinet, start_powers_table)
from metaviterbinet_tpu_torch.models import viterbinet as tvnet
from metaviterbinet_tpu_torch.online.engine import Draws, append, run_online
from metaviterbinet_tpu_torch.online.graphs import MAX_GRAPH_NODES, chunk_steps, when
from metaviterbinet_tpu_torch.train.checkpoint import load_checkpoint, save_params
from metaviterbinet_tpu_torch.train.losses import make_loss_fn, select_batch
from metaviterbinet_tpu_torch.train.loop import word_sweep
from metaviterbinet_tpu_torch.train.optim import (
    ADAM_B1, ADAM_B2, Optimizer, OptState, _bias_correction, adam_factors)
from metaviterbinet_tpu_torch.weights import adam_state_from_jax, params_from_jax
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# the first count at which both of Adam's float32 1 - b^count are 1.0f
ADAM_N = 17321


def test_adam_table_is_the_host_expression_at_every_count():
    """Row i of the table holds the factors of step i + 1, bit-equal to the
    host expression (1 / f32(1 - b^count) in float32) at every count up to
    N + 1000 through the clamp at N, where both are exactly 1.0f; the device
    gather (Optimizer._factors) reads them at the state's count and
    advances it."""
    table = adam_factors()
    assert table.shape == (ADAM_N, 2) and table.dtype == np.float32
    one = np.float32(1.0)
    for count in range(1, ADAM_N + 1000):
        want = (one / np.float32(_bias_correction(ADAM_B1, count)),
                one / np.float32(_bias_correction(ADAM_B2, count)))
        got = table[min(count, ADAM_N) - 1]
        assert got[0] == want[0] and got[1] == want[1], count
    assert tuple(table[-1]) == (1.0, 1.0) and tuple(table[-2]) != (1.0, 1.0)
    opt = Optimizer("Adam", 1e-3)
    state = opt.init({"w": torch.zeros(2)})
    for count in (0, 1, 999, ADAM_N - 2, ADAM_N - 1, ADAM_N, ADAM_N + 999):
        state.count.fill_(count)
        row = opt._factors(state)
        assert np.array_equal(row.numpy(), table[min(count, ADAM_N - 1)])
        assert int(state.count) == count + 1


@pytest.mark.parametrize("opt_type", ["RMSprop", "SGD"])
def test_rmsprop_and_sgd_keep_no_count(opt_type):
    opt = Optimizer(opt_type, 1e-2)
    p = {"w": torch.ones(3)}
    state = opt.init(p)
    for _ in range(5):
        opt.step(p, {"w": torch.full((3,), 0.5)}, state)
    assert state.count.dtype == torch.int32 and int(state.count) == 0


def test_k6_power_table_is_start_powers_at_every_count():
    """K6's start powers on the device are gathered from a table built with
    `_start_powers`' expression: bit-equal to it at every count up to the
    table's end + 1000 through the clamp, where both powers are 0.0f."""
    table = start_powers_table(ADAM_B1, ADAM_B2)
    assert table.shape == (103923, 2)
    for count in range(table.shape[0] + 1000):
        p1, p2 = _start_powers(ADAM_B1, ADAM_B2, count)
        got = table[min(count, table.shape[0] - 1)]
        assert got[0] == p1 and got[1] == p2, count


def test_k6_plain_from_a_device_count_matches_the_jax_kernel():
    """K6's plain version resumed from a JAX Adam state at count 1000 (the
    count a 0-d int32 tensor, through weights.adam_state_from_jax) against
    the JAX kernel (interpret mode) given the same count as a device array:
    within the JAX contract of 5e-6 after 40 steps, and the count advanced
    by 40 in place."""
    from metaviterbinet_tpu.kernels.online_sgd import online_adapt_viterbinet as j_adapt
    from metaviterbinet_tpu.ops.trellis import calculate_states as j_states
    T, seed = 40, 1
    params = jvnet.init_params(jax.random.PRNGKey(seed), 16)
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(T,)).astype(np.float32)
    states = np.asarray(j_states(4, jnp.asarray(rng.integers(0, 2, size=(1, T))
                                                .astype(np.float32))))
    mu0 = {k: 1e-3 * np.cos(np.asarray(v)) for k, v in params.items()}
    nu0 = {k: 1e-6 * (1 + np.sin(np.asarray(v)) ** 2) for k, v in params.items()}
    want, _, _, count = j_adapt(params, {k: jnp.asarray(v, jnp.float32) for k, v in mu0.items()},
                                {k: jnp.asarray(v, jnp.float32) for k, v in nu0.items()},
                                jnp.int32(1000), jnp.asarray(y), jnp.asarray(states),
                                n_iters=40, lr=1e-3)
    p = tvnet.param_dict(params_from_jax({k: np.asarray(v) for k, v in params.items()},
                                         device="cpu"))
    state = adam_state_from_jax(mu0, nu0, 1000, device="cpu")
    count_tensor = state.count
    assert count_tensor.dtype == torch.int32 and count_tensor.shape == ()
    online_adapt_viterbinet(p, state, torch.tensor(y), torch.tensor(states), 40, 1e-3)
    assert state.count is count_tensor and int(state.count) == int(count) == 1040
    for k in params:
        np.testing.assert_allclose(p[k].detach().numpy(), np.asarray(want[k]), atol=5e-6, rtol=0)


def _append_model(rows: list, cap: int, n0: int, gates: list, ring: bool):
    """The JAX engine's append rule (its online/engine.py, do_append under
    lax.cond) in plain Python over row ids."""
    buf = list(range(1, n0 + 1)) + [0] * (cap - n0)
    start, n_valid = 0, n0
    states = []
    for i, gate in enumerate(gates):
        if gate:
            buf[(start + n_valid) % cap] = rows[i]
            if ring:
                start = (start + 1) % cap
            else:
                if n_valid >= cap:
                    start = (start + 1) % cap
                n_valid = min(n_valid + 1, cap)
        states.append((list(buf), start, n_valid))
    return states


@settings(max_examples=60, deadline=None)
@given(cap=hs.integers(1, 6), ring=hs.booleans(), data=hs.data())
def test_device_append_is_the_jax_rule(cap, ring, data):
    """online/engine.py::append (index arithmetic on tensors, under a 0-d
    bool gate) against the plain-Python rule, block by block, over gate
    sequences that run an empty-start buffer past its capacity and a ring
    around."""
    n0 = data.draw(hs.integers(1 if ring else 0, cap))
    gates = data.draw(hs.lists(hs.booleans(), min_size=1, max_size=4 * cap + 3))
    rows = [100 + i for i in range(len(gates))]
    T = 3
    buf_rx = torch.zeros((cap, T))
    buf_rx[:n0] = torch.arange(1, n0 + 1, dtype=torch.float32)[:, None]
    buf_tx = -buf_rx
    start = torch.zeros((), dtype=torch.int32)
    n_valid = torch.tensor(n0, dtype=torch.int32)
    for i, (want_buf, want_start, want_n) in enumerate(_append_model(rows, cap, n0, gates, ring)):
        rx = torch.full((1, T), float(rows[i]))
        append(buf_rx, buf_tx, start, n_valid, rx, -rx, torch.tensor(gates[i]), ring)
        assert buf_rx[:, 0].tolist() == [float(r) for r in want_buf]
        assert torch.equal(buf_tx, -buf_rx)
        assert (int(start), int(n_valid)) == (want_start, want_n)
        assert start.dtype == n_valid.dtype == torch.int32


def test_when_on_the_cpu_is_a_host_branch():
    calls = []
    for value in (True, False, True):
        assert when(torch.tensor(value), calls.append, value) is None
    assert calls == [True, True]


TINY = dict(val_block_length=24, train_block_length=24, n_symbols=1, val_frames=2,
            subframes_in_frame=5, train_frames=2, self_supervised_iterations=3,
            meta_train_iterations=2, meta_j_num=2, meta_subframes=3, buffer_capacity=16,
            train_minibatch_size=8)


@pytest.mark.parametrize("name,mode,reads", [
    ("va", {}, 1), ("vnet", {}, 1), ("vnet", dict(self_supervised=True), 1),
    ("lstm", dict(self_supervised=True), 1),
    # candidate meta slots at blocks 3, 6 and 9 of the 10, decided on the
    # device
    ("meta_vnet", dict(self_supervised=True, online_meta=True), 1),
    ("meta_vnet", dict(self_supervised=True, online_meta=True, ser_thresh=0.0), 1)])
def test_a_run_reads_the_device_once(name, mode, reads):
    """OnlineResult.host_reads: one read at the end of a run, a meta run's
    too, whose candidate meta slots fire or not on the device; the counts
    read back are the run's."""
    from metaviterbinet_tpu_torch.data.dataset import ChannelDataset
    cfg = Config(**dict(TINY, **mode))
    spec = DETECTORS[name]
    gen = torch.Generator().manual_seed(3)
    params = spec.init(cfg, gen, "cpu") if spec.trainable else None
    tx, rx = ChannelDataset(cfg, "val", "cpu").get(10.0, cfg.gamma)
    h = torch.zeros((tx.shape[0], cfg.memory_length)) + torch.tensor([0.8, 0.4, 0.2, 0.1])
    result = run_online(cfg, spec, params, tx, rx, h,
                        Draws(cfg, spec, torch.device("cpu"), gen, torch.Generator()))
    assert result.host_reads == reads
    assert result.ser_by_word.dtype == np.float32 and result.ser_by_word.shape == (10,)
    assert 2 <= result.n_gated <= 10 and result.n_buffer == min(result.n_gated, 16)
    if mode.get("self_supervised") and name != "meta_vnet":
        assert result.steps["self_supervised"] == 3 * result.n_gated


def test_chunk_steps_divides_within_the_node_ceiling():
    """The engine's 200 self-supervised steps and the sweep's 300 words in
    chunks: vnet 25 steps a graph, lstm 2, each the largest divisor within
    MAX_GRAPH_NODES; 1 where a step alone exceeds it."""
    from metaviterbinet_tpu_torch.models import lstm as tlstm
    for n in (200, 300):
        assert chunk_steps(n, tvnet.STEP_NODES) == 25
        assert chunk_steps(n, tlstm.STEP_NODES) == 2
    assert 25 * tvnet.STEP_NODES <= MAX_GRAPH_NODES < 40 * tvnet.STEP_NODES
    assert chunk_steps(7, 10 ** 6) == 1 and chunk_steps(13, 1) == 13


@pytest.mark.parametrize("name", ["vnet", "lstm"])
def test_chunked_word_sweep_is_bit_equal_to_one_step_a_call(name):
    """train/loop.py::word_sweep in chunks of 20 steps a call against one
    step a call, over 60 words: params, moments, count and the summed loss
    bit-equal."""
    from metaviterbinet_tpu_torch.online.graphs import GraphedStep
    spec = DETECTORS[name]
    twins = [spec.model.param_dict(spec.init(Config(), torch.Generator().manual_seed(12), "cpu"))
             for _ in range(2)]
    rng = np.random.default_rng(13)
    n, T = 60, 24
    rx = torch.tensor(rng.normal(size=(n, T)).astype(np.float32))
    tx = torch.tensor(rng.integers(0, 2, size=(n, T)).astype(np.float32))
    gen = torch.Generator().manual_seed(14)
    select = [select_batch(T, 8, gen) for _ in range(n)]
    loss_fn = make_loss_fn(spec.score, spec.label_kind, 4, spec.subsample_loss)
    opt = Optimizer("Adam", 1e-3)
    states = [opt.init(p) for p in twins]
    GraphedStep.counts.pop("word_sweep", None)
    totals = [word_sweep(loss_fn, opt, p, s, rx, tx, select, chunk=c)
              for p, s, c in zip(twins, states, (1, 20))]
    assert GraphedStep.counts["word_sweep"]["direct"] == n + n // 20
    assert torch.equal(totals[0], totals[1])
    assert int(states[0].count) == int(states[1].count) == n
    for a, b in ((twins[0], twins[1]), (states[0].mu, states[1].mu),
                 (states[0].nu, states[1].nu)):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    with pytest.raises(ValueError, match="divide"):
        word_sweep(loss_fn, opt, twins[0], states[0], rx, tx, select, chunk=7)


def test_random_weights_init_resets_the_state_in_place():
    """Optimizer.init(params, out=state) zeroes the moments and the count
    of `state` in its own tensors (the graphs captured on them stay
    valid)."""
    opt = Optimizer("Adam", 1e-3)
    p = {"w": torch.ones(4)}
    state = opt.init(p)
    opt.step(p, {"w": torch.full((4,), 0.3)}, state)
    tensors = (state.count, state.mu["w"], state.nu["w"])
    assert opt.init(p, out=state) is state
    assert all(a is b for a, b in zip(tensors, (state.count, state.mu["w"], state.nu["w"])))
    assert int(state.count) == 0 and not state.mu["w"].any() and not state.nu["w"].any()


def test_checkpoints_keep_the_count(tmp_path):
    """The port's checkpoint round trip keeps the device count (a 0-d int32
    tensor on the load's device), and a JAX checkpoint's optax count loads
    as one."""
    p = {"w": torch.ones(3)}
    state = OptState(count=torch.tensor(37, dtype=torch.int32), mu={"w": torch.zeros(3)},
                     nu={"w": torch.zeros(3)})
    save_params(str(tmp_path / "port"), 10.0, 0.2, p, 0.5, state)
    loaded = load_checkpoint(str(tmp_path / "port"), 10.0, 0.2, "cpu")["opt_state"]
    assert loaded.count.dtype == torch.int32 and loaded.count.shape == () and int(loaded.count) == 37
    params = jvnet.init_params(jax.random.PRNGKey(1), 16)
    opt = make_optimizer("Adam", 1e-3)
    jstate = opt.init(params)
    for _ in range(3):
        updates, jstate = opt.update(jax.tree_util.tree_map(jnp.cos, params), jstate, params)
    jcheckpoint.save_params(str(tmp_path / "jax"), 10.0, 0.2, params, 0.25, jstate)
    count = load_checkpoint(str(tmp_path / "jax"), 10.0, 0.2, "cpu")["opt_state"].count
    assert count.dtype == torch.int32 and count.shape == () and int(count) == 3


def test_query_table_is_the_host_draws_at_every_bound():
    """Draws.j_hat_table: row b - 1 of each slot and iteration is what
    torch.randint(0, b, (meta_j_num,)) on the host generator gives when the
    slots' and iterations' draws are made one after another at bound b, for
    every bound the buffer's fill can give; the generator is left where
    those draws leave it."""
    from metaviterbinet_tpu_torch.online.engine import meta_slots, n_bounds
    cfg = Config(**dict(TINY, meta_j_num=5, meta_train_iterations=3))
    slots = meta_slots(cfg, 10)
    assert slots == [3, 6, 9] and n_bounds(cfg) == 14
    host = torch.Generator().manual_seed(21)
    table = Draws(cfg, DETECTORS["meta_vnet"], torch.device("cpu"), torch.Generator(),
                  host).j_hat_table(slots)
    assert table.shape == (3, 3, 14, 5) and table.dtype == torch.int64
    for high in range(1, n_bounds(cfg) + 1):
        twin = torch.Generator().manual_seed(21)
        for s in range(len(slots)):
            for iteration in range(cfg.meta_train_iterations):
                want = torch.randint(0, high, (cfg.meta_j_num,), generator=twin)
                assert torch.equal(table[s, iteration, high - 1], want), (high, s, iteration)
        assert torch.equal(twin.get_state(), host.get_state())


@pytest.mark.parametrize("weights_init", ["last_frame", "random"])
def test_duplicate_pairs_leave_the_count_unchanged(weights_init):
    """online/engine.py::make_meta_steps on a buffer of 6 words: the pairs
    of a meta iteration run one per distinct draw at the fill's bound (4),
    each an Adam step on the device count, a duplicate none; with the fill
    at 2 (do_meta false) nothing runs, the restore and save included."""
    from metaviterbinet_tpu_torch.online.engine import make_meta_steps
    cfg = Config(**dict(TINY, meta_j_num=6, weights_init=weights_init))
    spec = DETECTORS["meta_vnet"]
    p = spec.model.param_dict(spec.init(cfg, torch.Generator().manual_seed(2), "cpu"))
    opt = Optimizer("Adam", cfg.lr)
    state = opt.init(p)
    loss_fn = make_loss_fn(spec.meta_score, "states", cfg.memory_length, False)
    restore, pairs, save = make_meta_steps(cfg, opt, loss_fn, 3)
    rng = np.random.default_rng(5)
    st = {"buf_rx": torch.tensor(rng.normal(size=(16, 24)).astype(np.float32)),
          "buf_tx": torch.tensor(rng.integers(0, 2, size=(16, 24)).astype(np.float32)),
          "start": torch.tensor(3, dtype=torch.int32), "n_valid": torch.tensor(6, dtype=torch.int32),
          "pairs": torch.zeros((), dtype=torch.int32), "loss": torch.zeros(())}
    table = torch.zeros((1, 14, 6), dtype=torch.int64)  # one iteration's draws
    table[0, 3] = torch.tensor([2, 0, 2, 3, 0, 2])  # the row of bound 4
    saved = {k: v.detach().clone() for k, v in p.items()}
    firsts = torch.tensor([0, 3])
    for n_valid, want_count in ((6, 3), (2, 3), (6, 6)):
        st["n_valid"].fill_(n_valid)
        before = {k: v.detach().clone() for k, v in p.items()}
        restore(p, state, st, saved)
        for c in range(2):
            pairs(p, state, st, table, firsts[c:c + 1])
        save(saved, p, st)
        assert int(state.count) == (3 if weights_init == "random" else want_count)
        assert int(st["pairs"]) == want_count
        moved = any(not torch.equal(before[k], p[k]) for k in p)
        assert moved == (n_valid > 2)
        assert all(torch.equal(saved[k], p[k]) for k in p)
