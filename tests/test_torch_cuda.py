"""The port's CUDA kernels against their plain PyTorch versions, and the
LSTM family's forwards, MAML step and online step, on a card.

Marked `cuda`; each test skips without a CUDA device. The file imports no
JAX, so it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import contextlib
import copy

import numpy as np
import pytest
import torch

import chip_smoke
from metaviterbinet_tpu_torch.kernels import acs, maml_pairs, online_sgd
from metaviterbinet_tpu_torch.models import lstm, va, viterbinet
from metaviterbinet_tpu_torch.ops.trellis import calculate_states
from metaviterbinet_tpu_torch.train.optim import Optimizer

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("W,T", [(1000, 41), (300, 136), (33, 136), (1, 7)])
def test_va_kernel_bit_identical_to_plain(gen, W, T):
    y = torch.randn((W, T), generator=gen, device="cuda")
    h = torch.exp(-0.2 * torch.arange(4, device="cuda")) * (
        1 + 0.1 * torch.randn((W, 4), generator=gen, device="cuda"))
    mu = va.state_means(h).contiguous()
    before = acs.fused_va_detect.launches
    got = acs.fused_va_detect(y, mu)
    assert acs.fused_va_detect.launches == before + 1
    assert torch.equal(got, acs.fused_va_detect_plain(y, mu))


@pytest.mark.parametrize("W,T", [(1000, 41), (300, 136), (13, 136)])
def test_viterbinet_kernel_matches_plain(gen, W, T):
    model = viterbinet.init_params(16, gen, device="cuda")
    y = torch.randn((W, T), generator=gen, device="cuda")
    before = acs.fused_viterbinet_detect.launches
    got = acs.fused_viterbinet_detect(model, y)
    assert acs.fused_viterbinet_detect.launches == before + 1
    want = acs.fused_viterbinet_detect_plain(model, y)
    assert float((got != want).float().mean()) < 1e-3


DETECT_SHAPES = [(1, 136), (300, 136), (4096, 41), (33, 7)]


@pytest.mark.parametrize("S", [2, 4, 8, 16])
@pytest.mark.parametrize("W,T", DETECT_SHAPES)
def test_va_kernel_bit_identical_at_every_S(gen, S, W, T):
    """K2 at every S and at the engine's, the protocol's, a wide and a
    ragged shape: the plain version's bits, and the same bits from two
    launches (the ring's hand-off between producer and chain warps)."""
    y, mu = chip_smoke.kernel_inputs(W, T, gen, S)
    before = acs.fused_va_detect.launches
    got, again = acs.fused_va_detect(y, mu), acs.fused_va_detect(y, mu)
    assert acs.fused_va_detect.launches == before + 2
    assert torch.equal(got, acs.fused_va_detect_plain(y, mu))
    assert torch.equal(got, again)


@pytest.mark.parametrize("S", [2, 4, 8, 16])
@pytest.mark.parametrize("W,T", DETECT_SHAPES)
def test_viterbinet_kernel_matches_plain_at_every_S(gen, S, W, T):
    """K1 likewise: < 1e-3 bit mismatch (the tensor cores sum in another
    order), and two launches bit-identical."""
    model = viterbinet.init_params(S, gen, device="cuda")
    y = chip_smoke.kernel_inputs(W, T, gen, S)[0]
    before = acs.fused_viterbinet_detect.launches
    got, again = acs.fused_viterbinet_detect(model, y), acs.fused_viterbinet_detect(model, y)
    assert acs.fused_viterbinet_detect.launches == before + 2
    want = acs.fused_viterbinet_detect_plain(model, y)
    assert float((got != want).float().mean()) < 1e-3
    assert torch.equal(got, again)


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_kernels_read_unaligned_views(gen, offset):
    """y as a contiguous view at a float offset that is no multiple of 4, at
    a width that fills every block (W = 4224 = 32 words x 132 SMs), where K2
    otherwise loads 4 samples per 16-byte load: K2 gives the plain version's
    bits and K1 the bits of an aligned copy."""
    W, T = 4224, 136
    y, mu = chip_smoke.kernel_inputs(W, T, gen)
    view = torch.empty(W * T + offset, device="cuda")[offset:].view(W, T)
    view.copy_(y)
    assert view.is_contiguous() and view.data_ptr() % 16
    assert torch.equal(acs.fused_va_detect(view, mu), acs.fused_va_detect_plain(y, mu))
    model = viterbinet.init_params(16, gen, device="cuda")
    assert torch.equal(acs.fused_viterbinet_detect(model, view),
                       acs.fused_viterbinet_detect(model, y))


@pytest.mark.parametrize("S", [2, 4, 8, 16])
def test_tensor_core_tile_priors_match_plain(gen, S):
    """One 64-symbol wgmma tile (csrc/viterbinet_mlp.cuh::mlp_tile, the code
    K1 and K4 run) against `bf16_priors` on the same samples, within
    chip_smoke.TILE_TOL (its comment gives the reason)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    model = viterbinet.init_params(S, gen, device="cuda")
    y = 2 * torch.randn(64, generator=gen, device="cuda")
    got = acs.viterbinet_tile_priors(model, y)
    want = acs.bf16_priors(model, y[None]).reshape(64, S)
    assert float((got - want).abs().max()) <= chip_smoke.TILE_TOL


def test_kernels_break_exact_ties_toward_state_zero(gen):
    """All-zero params give equal priors: every state stays tied at 0.0 and
    every bit is state 0's LSB, in both kernels."""
    model = viterbinet.init_params(16, gen, device="cuda")
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    y = torch.zeros((64, 20), device="cuda")
    assert not acs.fused_viterbinet_detect(model, y).any()
    assert not acs.fused_va_detect(y, torch.zeros((64, 16), device="cuda")).any()


@pytest.mark.parametrize("S", [2, 4, 8, 16])
@pytest.mark.parametrize("W,T", [(1, 136), (300, 136), (4096, 41), (33, 7), (1, 1000)])
def test_decode_kernel_bit_identical_to_plain(gen, S, W, T):
    priors = torch.randn((W, T, S), generator=gen, device="cuda")
    before = acs.viterbi_decode_kernel.launches
    got = acs.viterbi_decode_kernel(priors)
    assert acs.viterbi_decode_kernel.launches == before + 1
    assert torch.equal(got, acs.viterbi_decode_kernel_plain(priors))


def test_decode_kernel_breaks_exact_ties_toward_state_zero(gen):
    """Equal priors keep every state tied at 0.0: every bit is state 0's
    LSB; and a tie set {1, 2, 9, 10} after step 0 reads state 1's."""
    assert not acs.viterbi_decode_kernel(torch.zeros((64, 20, 16), device="cuda")).any()
    p0 = torch.ones(16, device="cuda")
    p0[[2, 4]] = 0.0
    priors = torch.stack([p0, torch.ones(16, device="cuda")])[None].repeat(4, 1, 1).contiguous()
    got = acs.viterbi_decode_kernel(priors)
    assert torch.equal(got, acs.viterbi_decode_kernel_plain(priors))
    assert bool((got[:, 1] == 1.0).all())


def _adapt_inputs(gen, S, T):
    model = viterbinet.init_params(S, gen, device="cuda")
    y = torch.randn(T, generator=gen, device="cuda")
    bits = torch.randint(0, 2, (1, T), generator=gen, device="cuda").float()
    states = calculate_states(S.bit_length() - 1, bits)
    a = {k: v.detach().clone() for k, v in viterbinet.param_dict(model).items()}
    b = {k: v.detach().clone() for k, v in a.items()}
    opt = Optimizer("Adam", 1e-3)
    return y, states, (a, opt.init(a)), (b, opt.init(b))


@pytest.mark.parametrize("S,T", [(16, 136), (16, 41), (16, 5), (16, 1000), (2, 136), (2, 41)])
def test_online_adapt_kernel_matches_plain(gen, S, T):
    """40 fused Adam steps from the same params and zero moments: within
    5e-6 of the plain version (the JAX kernel's contract). T = 5 leaves CTAs
    of the 16-CTA cluster without columns; T = 1000 gives each 63."""
    torch.backends.cuda.matmul.allow_tf32 = False
    y, states, (a, sa), (b, sb) = _adapt_inputs(gen, S, T)
    before = online_sgd.online_adapt_viterbinet.launches
    online_sgd.online_adapt_viterbinet(a, sa, y, states, 40, 1e-3)
    assert online_sgd.online_adapt_viterbinet.launches == before + 1
    online_sgd.online_adapt_viterbinet_plain(b, sb, y, states, 40, 1e-3)
    assert sa.count == sb.count == 40
    for k in a:
        assert float((a[k] - b[k]).abs().max()) <= 5e-6, k


def test_online_adapt_kernel_is_deterministic(gen):
    """Two launches from the same inputs give the same bits in the params
    and both moments: the cluster sums its partial gradients in rank order,
    with no atomics."""
    y, states, (a, sa), (b, sb) = _adapt_inputs(gen, 16, 136)
    for p, s in ((a, sa), (b, sb)):
        online_sgd.online_adapt_viterbinet(p, s, y, states, 40, 1e-3)
    for k in a:
        assert torch.equal(a[k], b[k]) and torch.equal(sa.mu[k], sb.mu[k]), k
        assert torch.equal(sa.nu[k], sb.nu[k]), k


def _probe_seed0_word():
    """The word of scripts/torch_kernel_probe.py's first K6 case (S = 16,
    T = 136), on which the resumed 40 + 40 first missed 2e-5: its draws from
    a CUDA generator seeded 0, after the probe's K5 draws."""
    g = torch.Generator(device="cuda").manual_seed(0)
    for S in (2, 4, 8, 16):
        for W, T in ((1, 136), (300, 136), (4096, 41), (33, 7), (1, 1000)):
            torch.randn((W, T, S), generator=g, device="cuda")
    model = viterbinet.init_params(16, g, device="cuda")
    y = torch.randn(136, generator=g, device="cuda")
    states = calculate_states(4, torch.randint(0, 2, (1, 136), generator=g, device="cuda").float())
    return {k: v.detach() for k, v in viterbinet.param_dict(model).items()}, y, states


@pytest.mark.parametrize("word", [*chip_smoke.K6_WITNESS_WORDS, "probe"])
def test_online_adapt_kernel_drift_is_rounding(gen, word):
    """After 40 + 40 steps, K6's distance from a float64 run of the plain
    version's arithmetic is within K6_WITNESS_MULTIPLE times the f32 plain
    version's distance plus K6_WITNESS_FLOOR (chip_smoke.py), on the words
    of tests/test_torch_kernels.py's CPU witness (as (T, seed); the port's
    own init) and the probe's seed-0 word."""
    torch.backends.cuda.matmul.allow_tf32 = False
    inputs = _probe_seed0_word() if word == "probe" else chip_smoke.k6_witness_word(*word)
    d = chip_smoke.k6_witness(*inputs)
    assert chip_smoke.witness_holds(d), d


@pytest.mark.parametrize("fault", sorted(chip_smoke.K6_FAULTS))
def test_online_adapt_witness_rejects_faulty_runs(gen, fault):
    """The same witness fails on every witness word when the f32 run in K6's
    place has one Adam constant off (chip_smoke.K6_FAULTS)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    for word in chip_smoke.K6_WITNESS_WORDS:
        d = chip_smoke.k6_witness(*chip_smoke.k6_witness_word(*word),
                                  fault=chip_smoke.K6_FAULTS[fault])
        assert not chip_smoke.witness_holds(d), (word, d)


@pytest.mark.parametrize("label,iterations", [("10 pairs", 1),
                                              ("200 pairs", chip_smoke.K7_ITERATIONS)])
def test_maml_pairs_kernel_matches_plain(gen, label, iterations):
    """K7 against its plain version at f32 on a slot's pairs
    (chip_smoke.k7_slot), over one launch of 10 draws and over the slot's
    20 launches: params within chip_smoke.K7_LIMITS, the Adam counts and the
    pair counts the distinct draws', the summed query losses within 1e-5
    relative, and one launch a call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    inputs = chip_smoke.k7_slot(0)
    before = maml_pairs.maml_pairs_viterbinet.launches
    (pk, sk, stk), (pp, sp, stp) = (chip_smoke.k7_slot_run(*inputs, path, iterations=iterations)
                                    for path in ("kernel", "plain"))
    assert maml_pairs.maml_pairs_viterbinet.launches == before + iterations
    distinct = sum(len(set(d.tolist())) for d in inputs[3][:iterations])
    assert int(sk.count) == int(sp.count) == int(stk["pairs"]) == int(stp["pairs"]) == distinct
    assert abs(float(stk["loss"]) / float(stp["loss"]) - 1.0) < 1e-5
    assert chip_smoke._max_diff(pk, pp) <= chip_smoke.K7_LIMITS[label]


@pytest.mark.parametrize("S,T,window", [(16, 300, 1), (4, 40, 2), (2, 33, 1), (8, 5, 3),
                                         (16, 17, 1), (16, 136, 6), (2, 136, 1)])
def test_maml_pairs_kernel_matches_plain_at_other_shapes(gen, S, T, window):
    """One launch of 6 pairs at other state counts, word lengths and
    windows, some pairs masked, second and first order: within 1e-5 of the
    plain version, the counts and losses equal. T = 5 leaves CTAs of the
    16-CTA cluster without query columns; T = 300 gives each 19; T = 17
    gives ranks 0-7 two columns, rank 8 one and ranks 9-15 none (a tile of
    the products part empty); window 6 at T = 136 gives each 51 support
    columns, the most the wrapper takes (many tiles a CTA); S = 2 at T =
    136 puts 16 lanes on each logit."""
    g = torch.Generator(device="cuda").manual_seed(S + T)
    model = viterbinet.init_params(S, g, device="cuda")
    params = {k: v.detach() for k, v in viterbinet.param_dict(model).items()}
    L = S.bit_length() - 1
    s_tx = torch.randint(0, 2, (6, window, T), generator=g, device="cuda").float()
    q_tx = torch.randint(0, 2, (6, 1, T), generator=g, device="cuda").float()
    s_rx = 1.0 - 2.0 * s_tx + 0.5 * torch.randn(s_tx.shape, generator=g, device="cuda")
    q_rx = 1.0 - 2.0 * q_tx + 0.5 * torch.randn(q_tx.shape, generator=g, device="cuda")
    take = torch.tensor([True, False, True, True, False, True], device="cuda")
    labels = [calculate_states(L, tx.reshape(-1, T)).reshape(6, -1) for tx in (s_tx, q_tx)]
    for second_order in (True, False):
        opt = Optimizer("Adam", 1e-3)
        runs = []
        for fn in (maml_pairs.maml_pairs_viterbinet, maml_pairs.maml_pairs_viterbinet_plain):
            p = {k: v.clone() for k, v in params.items()}
            state = opt.init(p)
            loss = torch.zeros((), device="cuda")
            fn(p, state, opt.table(torch.device("cuda")), s_rx.reshape(6, -1), labels[0],
               q_rx.reshape(6, -1), labels[1], take, loss, 0.1, 1e-3, second_order)
            runs.append((p, state, loss))
        (pk, sk, lk), (pp, sp, lp) = runs
        assert int(sk.count) == int(sp.count) == 4
        assert abs(float(lk) / float(lp) - 1.0) < 1e-5
        assert chip_smoke._max_diff(pk, pp) <= 1e-5, second_order


def test_maml_pairs_kernel_is_deterministic(gen):
    """Two launches from the same inputs give the same bits in the params,
    both moments and the loss: the cluster sums its partials in rank
    order, with no atomics."""
    inputs = chip_smoke.k7_slot(1)
    (a, sa, sta), (b, sb, stb) = (chip_smoke.k7_slot_run(*inputs, "kernel", iterations=1)
                                  for _ in range(2))
    assert torch.equal(sta["loss"], stb["loss"])
    for k in a:
        assert torch.equal(a[k], b[k]) and torch.equal(sa.mu[k], sb.mu[k]), k
        assert torch.equal(sa.nu[k], sb.nu[k]), k


@pytest.mark.parametrize("seed", chip_smoke.K7_WITNESS_SEEDS)
def test_maml_pairs_kernel_drift_is_rounding(gen, seed):
    """Over a slot's 200 draws, K7's distance from a float64 run of its
    plain version's arithmetic is within K7_WITNESS_MULTIPLE times that of
    the autograd pairs it replaced (f32) plus K7_WITNESS_FLOOR
    (chip_smoke.py)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    d = chip_smoke.k7_witness(*chip_smoke.k7_slot(seed))
    assert chip_smoke.k7_witness_holds(d), d


@pytest.mark.parametrize("fault", sorted(chip_smoke.K7_FAULTS))
def test_maml_pairs_witness_rejects_faulty_runs(gen, fault):
    """The same witness fails when the f32 run in K7's place leaves out the
    Hessian term or takes the duplicate draws (chip_smoke.K7_FAULTS)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    d = chip_smoke.k7_witness(*chip_smoke.k7_slot(chip_smoke.K7_WITNESS_SEEDS[0]),
                              fault=chip_smoke.K7_FAULTS[fault])
    assert not chip_smoke.k7_witness_holds(d), d


def _channel_words(W, gen):
    """The protocol's words through the 4-tap time-decay channel at 10 dB:
    W x 136 received samples."""
    from metaviterbinet_tpu_torch.data.dataset import generate_words
    return generate_words(10.0, 0.2, n_words=W, block_length=120, memory_length=4, use_ecc=True,
                          n_symbols=2, channel_coefficients="time_decay", fading=True,
                          fading_taps_type=1, device="cuda", word_generator=gen,
                          noise_generator=gen)[1].contiguous()


@pytest.mark.parametrize("W,T,C,overlap", [
    (300, 136, 2, 32), (300, 136, 4, 32), (1000, 136, 2, 32), (13, 64, 2, 32),  # overlap = Tc
    (1, 136, 4, 32), (4096, 136, 4, 32), (33, 135, 3, 32), (7, 70, 2, 32),  # Tc = 35
    (1001, 136, 4, 32),  # W C = 4004 chains, no multiple of the 32 per block
    (5, 80, 40, 2)])  # C > 32: blocks of chains from several words
def test_chunked_kernel_matches_plain(gen, W, T, C, overlap):
    """K4 at the protocol's shapes and the ragged ones of its geometry
    (kernels/acs.py::chunked_geometry): < 1e-3 bit mismatch, as K1."""
    model = viterbinet.init_params(16, gen, device="cuda")
    y = torch.randn((W, T), generator=gen, device="cuda")
    before = acs.fused_viterbinet_detect_chunked.launches
    got = acs.fused_viterbinet_detect_chunked(model, y, C, overlap)
    assert acs.fused_viterbinet_detect_chunked.launches == before + 1
    want = acs.fused_viterbinet_detect_chunked_plain(model, y, C, overlap)
    assert float((got != want).float().mean()) < 1e-3


@pytest.mark.parametrize("W,C", [(300, 2), (300, 4), (4224, 4)])
def test_chunked_kernel_launches_are_bit_identical(gen, W, C):
    """Two K4 launches from the same inputs give the same bits (the ring's
    hand-off between producer warpgroups and the chain warp)."""
    model = viterbinet.init_params(16, gen, device="cuda")
    y = chip_smoke.kernel_inputs(W, 136, gen)[0]
    assert torch.equal(acs.fused_viterbinet_detect_chunked(model, y, C, 32),
                       acs.fused_viterbinet_detect_chunked(model, y, C, 32))


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_chunked_kernel_reads_unaligned_views(gen, offset):
    """K4 on y as a contiguous view 1-3 floats off a 16-byte boundary gives
    the bits of an aligned copy and its plain version's within 1e-3."""
    W, T = 4224, 136
    y = chip_smoke.kernel_inputs(W, T, gen)[0]
    view = torch.empty(W * T + offset, device="cuda")[offset:].view(W, T)
    view.copy_(y)
    assert view.is_contiguous() and view.data_ptr() % 16
    model = viterbinet.init_params(16, gen, device="cuda")
    got = acs.fused_viterbinet_detect_chunked(model, view, 4, 32)
    assert torch.equal(got, acs.fused_viterbinet_detect_chunked(model, y, 4, 32))
    want = acs.fused_viterbinet_detect_chunked_plain(model, y, 4, 32)
    assert float((got != want).float().mean()) < 1e-3


@pytest.mark.parametrize("C", [2, 4])
def test_chunked_kernel_bit_identical_to_k1_on_channel_words(gen, tmp_path, C):
    """Both kernels compute a symbol's priors with the same code
    (viterbinet_mlp.cuh), and with informative priors (a network trained
    for one minibatch; untrained random params may not do) the trellis
    forgets its start within the 32-step warm-up on channel words: the same
    bits as K1."""
    from metaviterbinet_tpu_torch import Config
    from metaviterbinet_tpu_torch.evaluation.trainer import Trainer
    model = Trainer(Config(train_minibatch_num=1), "vnet", weights_dir=str(tmp_path),
                    verbose=False).train()
    y = _channel_words(300, gen)
    assert torch.equal(acs.fused_viterbinet_detect_chunked(model, y, C, 32),
                       acs.fused_viterbinet_detect(model, y))


# ------------------------------------------------------------------ the LSTM family

def _trained_lstm(tmp_path):
    """An LSTM after one training minibatch on the card (its margins are
    those of a detector, not of random params)."""
    from metaviterbinet_tpu_torch import Config
    from metaviterbinet_tpu_torch.evaluation.trainer import Trainer
    return Trainer(Config(train_minibatch_num=1), "lstm", weights_dir=str(tmp_path),
                   verbose=False).train()


def test_lstm_logits_on_cudnn_match_the_cpu(gen, tmp_path):
    """The fused forward on cuDNN (TF32 off) against PyTorch's CPU LSTM at
    the protocol's 300 x 136: within rtol 1e-4, atol 1e-5, and the bits
    equal except where the CPU's two class logits are within
    chip_smoke.LSTM_MARGIN of each other."""
    model = _trained_lstm(tmp_path)
    y = _channel_words(300, gen)
    assert not torch.backends.cudnn.allow_tf32
    with torch.no_grad():
        card = lstm.logits(lstm.param_dict(model), y).cpu()
        cpu = lstm.logits(lstm.param_dict(copy.deepcopy(model).cpu()), y.cpu())
    torch.testing.assert_close(card, cpu, rtol=1e-4, atol=1e-5)
    assert chip_smoke.bits_outside_margin(card, cpu) == 0


def test_lstm_fused_and_unrolled_forwards_agree_on_the_card(gen, tmp_path):
    """cuDNN's recurrence and the unrolled one round apart in f32; at 300 x
    136 with trained params their bits are equal except where the two class
    logits are within chip_smoke.LSTM_MARGIN of each other."""
    model = _trained_lstm(tmp_path)
    y = _channel_words(300, gen)
    with torch.no_grad():
        fused = lstm.logits(lstm.param_dict(model), y)
        unrolled = lstm.logits_unrolled(lstm.param_dict(model), y)
    torch.testing.assert_close(fused, unrolled, rtol=1e-4, atol=1e-5)
    assert chip_smoke.bits_outside_margin(fused, unrolled) == 0


def test_lstm_second_order_maml_step_on_the_card_matches_the_cpu(gen):
    """meta_lstm's second-order MAML step at T = 136 (support and query one
    coded word each) runs on the card, where cuDNN has no double backward,
    through the spec's meta_score, and gives the CPU's params within 1e-5."""
    from metaviterbinet_tpu_torch.detectors import DETECTORS
    from metaviterbinet_tpu_torch.train.losses import make_loss_fn
    from metaviterbinet_tpu_torch.train.meta import make_maml_step
    model = lstm.init_params(gen, device="cuda")
    start = {k: v.detach().cpu() for k, v in lstm.param_dict(model).items()}
    rx = _channel_words(2, gen)
    tx = torch.randint(0, 2, (2, 136), generator=gen, device="cuda").float()
    out = {}
    for device, m in (("cuda", model), ("cpu", copy.deepcopy(model).cpu())):
        p = lstm.param_dict(m)
        opt = Optimizer("Adam", 1e-3)
        loss_fn = make_loss_fn(DETECTORS["meta_lstm"].meta_score, "bits", 4, False)
        step = make_maml_step(loss_fn, opt, 0.1, second_order=True)
        r, t = rx.to(device), tx.to(device)
        step(p, opt.init(p), r[:1], t[:1], r[1:], t[1:])
        out[device] = {k: v.detach().cpu() for k, v in p.items()}
    for k, v in out["cpu"].items():
        assert float((out["cuda"][k] - v).abs().max()) <= 1e-5, k
        assert not torch.equal(out["cuda"][k], start[k]), k


def test_lstm_online_step_launches_no_kernel(gen):
    """lstm online on the card: the engine's self-supervised step runs as
    autograd steps on the fused forward, writes the module's own (cuDNN-
    flattened) tensors in place, and launches none of the five kernels."""
    import warnings
    from metaviterbinet_tpu_torch import Config
    from metaviterbinet_tpu_torch.detectors import DETECTORS
    from metaviterbinet_tpu_torch.online.engine import Draws, run_online
    cfg = Config(val_block_length=120, n_symbols=2, val_frames=1, subframes_in_frame=25,
                 self_supervised=True, self_supervised_iterations=2, ser_thresh=1.0)
    model = lstm.init_params(gen, device="cuda")
    rx = _channel_words(3, gen)
    tx = torch.randint(0, 2, (3, 120), generator=gen, device="cuda").float()
    draws = Draws(cfg, DETECTORS["lstm"], torch.device("cuda"), gen, torch.Generator())
    chip_smoke.zero_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        result = run_online(cfg, DETECTORS["lstm"], model, tx, rx,
                            torch.zeros((3, 4), device="cuda"), draws)
    assert chip_smoke.read_launches() == dict.fromkeys(chip_smoke.KERNELS, 0)
    assert not [w for w in caught if "contiguous chunk" in str(w.message)]
    assert result.n_gated == 3
    moved = lstm.param_dict(result.params)["w_hh0"]
    assert not torch.equal(moved, lstm.param_dict(model)["w_hh0"])


# ------------------------------------------------------------ the parallel layer

@pytest.fixture
def no_group():
    """A test that forms a process group leaves none behind."""
    import torch.distributed as dist
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_mesh_trainer_on_a_world_one_nccl_group(gen, no_group):
    """Config.mesh_shape=(1,) on the card: a world-1 NCCL group, K2 per
    point, and the mesh-less Trainer's coded BERs from the same seeds."""
    import numpy as np
    import torch.distributed as dist
    from metaviterbinet_tpu_torch import Config
    from metaviterbinet_tpu_torch.evaluation.trainer import Trainer
    cfg = Config(val_frames=2, val_SNR_start=9.0, val_SNR_end=10.0)
    chip_smoke.zero_launches()
    mesh = Trainer(cfg.replace(mesh_shape=(1,)), "va", verbose=False).evaluate()
    assert (dist.get_backend(), dist.get_world_size()) == ("nccl", 1)
    assert chip_smoke.read_launches()["fused_va_detect"] == 2
    np.testing.assert_array_equal(mesh, Trainer(cfg, "va", verbose=False).evaluate())


@pytest.mark.parametrize("decode", ["sequence_parallel", "chunked"])
def test_block_parallel_decodes_are_one_k5_launch(gen, no_group, decode):
    """The sequence-parallel decode over a one-rank 'sp' axis and the chunked
    decode: one K5 launch each, the sequential K5's bits on VA priors, and
    the bits of the same decode through K5's plain version and of the plain
    sequential decode."""
    from metaviterbinet_tpu_torch.parallel.decode import (
        chunked_decode_reference, sequence_parallel_decode)
    from metaviterbinet_tpu_torch.parallel.mesh import make_mesh
    priors = chip_smoke.va_long_priors(16, 1024, gen)
    want = acs.viterbi_decode_kernel(priors)
    assert torch.equal(want, acs.viterbi_decode_kernel_plain(priors))
    mesh = make_mesh((1, 1))

    def run():
        if decode == "chunked":
            return chunked_decode_reference(priors, 8, chip_smoke.OVERLAP)
        return sequence_parallel_decode(mesh, chip_smoke.OVERLAP)(priors)

    before = acs.viterbi_decode_kernel.launches
    got = run()
    assert acs.viterbi_decode_kernel.launches == before + 1
    assert torch.equal(got, want)
    with chip_smoke.k5_plain_in_decode():
        assert torch.equal(run(), got)
    assert acs.viterbi_decode_kernel.launches == before + 1


@pytest.mark.parametrize("W,T", [(8, 37), (1, 136)])
def test_lowlat_decode_equals_k5(gen, W, T):
    """viterbi_decode_lowlat on the card: K5's bits on integer priors at
    W x T, and at least 0.999 of them on float priors at 16 x 136."""
    from metaviterbinet_tpu_torch.ops.trellis import viterbi_decode_lowlat
    ints = torch.randint(0, 12, (W, T, 16), generator=gen, device="cuda").float()
    assert torch.equal(viterbi_decode_lowlat(ints), acs.viterbi_decode_kernel(ints))
    floats = torch.randn((16, 136, 16), generator=gen, device="cuda") ** 2
    agree = (viterbi_decode_lowlat(floats) == acs.viterbi_decode_kernel(floats)).float().mean()
    assert float(agree) >= chip_smoke.LOWLAT_AGREEMENT


# ------------------------------------------------------------ the graphed steps

GRAPH_CASES = [("vnet self-supervised", True), ("lstm self-supervised", True),
               ("meta_lstm self-supervised", True),
               ("meta_vnet maml", True), ("meta_vnet maml", False),
               ("meta_lstm maml", True), ("meta_lstm maml", False)]


def test_bias_correction_factors_equal_the_eager_division_on_the_card(gen):
    """On the card Optimizer.step, which gathers its bias correction from
    the float32 table at the device count (train/optim.py), equals the
    update with the host's float32 reciprocals (apply with a host row, the
    step of a count kept on the host) and the division by the host float
    that PyTorch computes eagerly (its CUDA kernel multiplies by the
    reciprocal), bit for bit, over 300 steps."""
    from metaviterbinet_tpu_torch.train.optim import (
        ADAM_B1, ADAM_B2, ADAM_EPS, _bias_correction)
    params = {"w": torch.randn((50, 100), generator=gen, device="cuda")}
    twin, divided = ({"w": params["w"].clone()} for _ in range(2))
    opt = Optimizer("Adam", 1e-3)
    dev, host = opt.init(params), opt.init(twin)
    mu, nu = torch.zeros_like(params["w"]), torch.zeros_like(params["w"])
    one = np.float32(1.0)
    for count in range(1, 301):
        g = 0.1 * torch.randn((50, 100), generator=gen, device="cuda")
        opt.step(params, {"w": g}, dev)
        bc1, bc2 = _bias_correction(ADAM_B1, count), _bias_correction(ADAM_B2, count)
        opt.apply(twin, {"w": g}, host, (float(one / np.float32(bc1)),
                                         float(one / np.float32(bc2))))
        mu = (1 - ADAM_B1) * g + ADAM_B1 * mu
        nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * nu
        divided["w"].add_((mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS) * -1e-3)
    assert dev.count.device.type == "cuda" and int(dev.count) == 300
    assert torch.equal(params["w"], twin["w"]) and torch.equal(params["w"], divided["w"])


# ------------------------------------------- conditional nodes (lax.cond)

def test_an_if_node_captures_and_replays(gen):
    """online/graphs.py::when in a GraphedStep's capture records a CUDA
    graph IF node (kernels/csrc/if_node.cu): a body that adds 1 and copies
    a row runs at a replay where the predicate holds and is skipped where it
    does not, the predicate read by the device at each replay; in the
    warm-ups it is a host branch."""
    from metaviterbinet_tpu_torch.online.graphs import GraphedStep, when

    def body(st):
        st["x"].add_(1.0)
        st["row"].copy_(st["src"])

    def fn(st, pred, src):
        st["src"].copy_(src)
        when(pred, body, st)

    st = {"x": torch.zeros((), device="cuda"), "row": torch.zeros(136, device="cuda"),
          "src": torch.zeros(136, device="cuda")}
    call = GraphedStep(fn, "if node", n_state=1)
    want_x, want_row = 0.0, torch.zeros(136, device="cuda")
    for i, value in enumerate((True, False, True, False, True, True, False)):
        src = torch.full((136,), float(i), device="cuda")
        call(st, torch.tensor(value, device="cuda"), src)
        if value:
            want_x, want_row = want_x + 1.0, src
        assert float(st["x"]) == want_x, i
        assert torch.equal(st["row"], want_row), i
    assert GraphedStep.counts["if node"]["capture"] == 1
    assert GraphedStep.counts["if node"]["replay"] == 5


@pytest.mark.parametrize("name", ["vnet", "lstm"])
def test_an_if_node_step_runs_where_its_gate_holds(gen, name):
    """The engine's self-supervised chunk (make_adapt_step, 2 steps) under
    gates False, True, then (the capture) True and replays False, True,
    False, True: at a replay with the gate closed the params, moments and
    count are bit-equal to before it; every call equals the same call made
    directly (chip_smoke.no_capture, a host branch)."""
    from metaviterbinet_tpu_torch import Config
    from metaviterbinet_tpu_torch.detectors import DETECTORS
    from metaviterbinet_tpu_torch.online.engine import make_adapt_step
    from metaviterbinet_tpu_torch.online.graphs import GraphedStep
    from metaviterbinet_tpu_torch.train.losses import make_loss_fn, select_batch
    cfg, spec = Config(), DETECTORS[name]
    loss_fn = make_loss_fn(spec.score, spec.label_kind, cfg.memory_length, True)
    gates = (False, True, True, False, True, False, True)
    rx = torch.randn((len(gates), 136), generator=gen, device="cuda")
    tx = torch.randint(0, 2, (len(gates), 136), generator=gen, device="cuda").float()
    idx = torch.stack([select_batch(136, cfg.train_minibatch_size, gen, "cuda")
                       for _ in range(2 * len(gates))])
    after = {}
    for captured in (True, False):
        opt = Optimizer("Adam", cfg.lr)
        p = spec.model.param_dict(spec.init(cfg, torch.Generator(device="cuda").manual_seed(1),
                                            "cuda"))
        state = opt.init(p)
        st = {"gate": torch.zeros((), dtype=torch.bool, device="cuda"),
              "rx": rx.new_zeros((1, 136)), "label": rx.new_zeros((1, 136))}
        adapt = make_adapt_step(cfg, opt, loss_fn, False, 2)
        GraphedStep.counts.pop("self_supervised", None)
        # detached: a clone that autograd records would keep the params'
        # gradient accumulators alive on this stream, which the captured
        # backward on the IF node's stream would then wait for
        tensors = lambda: [t.detach().clone() for t in (*p.values(), *state.mu.values(),
                                                        *state.nu.values(), state.count)]
        runs = []
        with contextlib.nullcontext() if captured else chip_smoke.no_capture():
            for i, gate in enumerate(gates):
                st["gate"].fill_(gate)
                st["rx"].copy_(rx[i:i + 1])
                st["label"].copy_(tx[i:i + 1])
                before = tensors()
                adapt(p, state, st, idx[2 * i:2 * i + 2])
                now = tensors()
                runs.append(now)
                if not gate:
                    assert all(torch.equal(a, b) for a, b in zip(before, now)), i
        after[captured] = runs
        if captured:
            assert GraphedStep.counts["self_supervised"]["replay"] == len(gates) - 2
        assert int(state.count) == 2 * sum(gates)
    for graphed, direct in zip(after[True], after[False]):
        assert all(torch.equal(a, b) for a, b in zip(graphed, direct))


def test_k6_under_an_if_node_equals_an_eager_k6(gen):
    """K6 (a 16-CTA cluster launch through ctypes) captured in the engine's
    fused adapt step under the gate's IF node: replays with the gate open
    equal eager K6 launches on the same words bit for bit, a replay with it
    closed changes nothing, and the launch counter reads the launches that
    ran once the step settles its conditional count."""
    from metaviterbinet_tpu_torch import Config
    from metaviterbinet_tpu_torch.ecc.rs import rs_encode_bits
    from metaviterbinet_tpu_torch.online.engine import make_adapt_step
    cfg = Config()
    gates = (True, False, True, True, False, True)
    params, y, _ = chip_smoke.adapt_inputs(1)
    rs_label = rs_encode_bits(torch.randint(0, 2, (1, 120), generator=gen, device="cuda").float(),
                              2)
    opt = Optimizer("Adam", cfg.lr)
    (pg, sg), (pe, se) = (chip_smoke._copy_state(params, opt.init(params)) for _ in range(2))
    st = {"gate": torch.zeros((), dtype=torch.bool, device="cuda"), "rx": y[None].clone(),
          "label": rs_label.clone()}
    adapt = make_adapt_step(cfg, opt, None, True, 200)
    before = online_sgd.online_adapt_viterbinet.launches
    for gate in gates:
        st["gate"].fill_(gate)
        adapt(pg, sg, st)
        if gate:
            online_sgd.online_adapt_viterbinet(pe, se, y, calculate_states(4, rs_label), 200,
                                               cfg.lr)
    hits = [int(h) for h, _ in adapt.conditional]
    adapt.settle(hits)
    assert online_sgd.online_adapt_viterbinet.launches - before == 2 * sum(gates)
    assert int(sg.count) == int(se.count) == 200 * sum(gates)
    for a, b in ((pg, pe), (sg.mu, se.mu), (sg.nu, se.nu)):
        assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("kind,second_order", GRAPH_CASES)
def test_graphed_step_equals_the_step_called_directly(gen, kind, second_order):
    """The by-word engine's steps at T = 136 (chip_smoke.step_case), each on
    its own inputs: the warm-up steps, the capture and its replay and three
    more replays give the params and moments of the same steps called
    directly on the card, bit for bit (meta_lstm's second-order step within
    chip_smoke.STEP_TOL: eagerly too it does not repeat bit for bit on
    fresh tensors)."""
    from metaviterbinet_tpu_torch.online import graphs
    graphed, calls = chip_smoke.step_run(kind, True, second_order)
    direct, direct_calls = chip_smoke.step_run(kind, False, second_order)
    n = graphs.WARMUP_STEPS + 4
    assert calls == {"direct": 0, "warmup": graphs.WARMUP_STEPS, "capture": 1,
                     "replay": n - graphs.WARMUP_STEPS}
    assert direct_calls == {"direct": n, "warmup": 0, "capture": 0, "replay": 0}
    tol = chip_smoke.STEP_TOL.get((kind, second_order), 0.0)
    assert chip_smoke.tensors_apart(graphed, direct) <= tol


def test_a_capture_that_cannot_happen_raises(gen):
    """A step with a host read cannot be captured: the capture raises with
    CUDA's error after the warm-up steps ran, and nothing runs on eagerly."""
    from metaviterbinet_tpu_torch.online.graphs import WARMUP_STEPS, GraphedStep
    p = {"w": torch.zeros(3, device="cuda")}
    opt = Optimizer("SGD", 1.0)
    state = opt.init(p)

    def step(params, opt_state, g, bc):
        opt.apply(params, {"w": g * float(g.sum())}, opt_state, bc)

    graphed = GraphedStep(step, "host read")
    g, bc = torch.ones(3, device="cuda"), torch.ones(2, device="cuda")
    for _ in range(WARMUP_STEPS):
        graphed(p, state, g, bc)
    # the stream context restores the current stream that a failed capture
    # leaves switched
    with torch.cuda.stream(torch.cuda.current_stream()), pytest.raises(RuntimeError):
        graphed(p, state, g, bc)
    torch.cuda.synchronize()
    assert torch.equal(p["w"], torch.full((3,), -3.0 * WARMUP_STEPS, device="cuda"))


# ------------------------------------- the per-block detect and the word sweep

@pytest.mark.parametrize("kernel", ["fused_va_detect", "viterbi_decode_kernel"])
def test_kernel_replayed_in_a_graph_equals_its_launch(gen, kernel):
    """K2 and K5 at the engine's 1 x 136 as a graphed call, as the engine's
    per-block detect runs them: each of WARMUP_STEPS + 4 calls on its own
    inputs gives the bits of an eager launch on the same inputs, and the
    kernel's launch counter reads one per execution (the warm-ups and the
    replays; the capture, which runs nothing, counts none)."""
    from metaviterbinet_tpu_torch.online.graphs import WARMUP_STEPS, GraphedStep
    fn = getattr(acs, kernel)
    n = WARMUP_STEPS + 4
    if kernel == "fused_va_detect":
        inputs = [chip_smoke.kernel_inputs(1, 136, gen) for _ in range(n)]
    else:
        inputs = [(torch.randn((1, 136, 16), generator=gen, device="cuda") ** 2,)
                  for _ in range(n)]
    name = f"{kernel} alone"
    GraphedStep.counts.pop(name, None)
    call = GraphedStep(fn, name, n_state=0)
    before = fn.launches
    got = [call(*x).clone() for x in inputs]
    torch.cuda.synchronize()
    assert fn.launches == before + n
    assert GraphedStep.counts[name] == {"direct": 0, "warmup": WARMUP_STEPS, "capture": 1,
                                        "replay": n - WARMUP_STEPS}
    for x, bits in zip(inputs, got):
        assert torch.equal(bits, fn(*x))


def test_rs_codec_captured_alone_equals_eager(gen):
    """rs_decode_bits and rs_encode_bits at the engine's shapes (one
    136-bit codeword of RS nsym=2, one 120-bit word), each captured alone
    and replayed on words with 0 to 4 flipped bytes: the eager codec's bits
    and flags."""
    from metaviterbinet_tpu_torch.ecc.rs import rs_decode_bits, rs_encode_bits
    from metaviterbinet_tpu_torch.online.graphs import WARMUP_STEPS, GraphedStep
    decode = GraphedStep(lambda b: rs_decode_bits(b, 2), "rs decode alone", n_state=0)
    encode = GraphedStep(lambda b: rs_encode_bits(b, 2), "rs encode alone", n_state=0)
    for flips in range(WARMUP_STEPS + 5):
        word = torch.randint(0, 2, (1, 120), generator=gen, device="cuda").float()
        code = rs_encode_bits(word, 2)
        for byte in range(flips % 5):
            code[0, 8 * (5 * byte + 1)] = 1 - code[0, 8 * (5 * byte + 1)]
        got_bits, got_flags = (t.clone() for t in decode(code))
        want_bits, want_flags = rs_decode_bits(code, 2)
        assert torch.equal(got_bits, want_bits) and torch.equal(got_flags, want_flags)
        assert torch.equal(encode(word).clone(), rs_encode_bits(word, 2))


@pytest.mark.parametrize("name", ["vnet", "lstm"])
def test_graphed_word_sweep_equals_the_eager_loop_on_the_card(gen, name):
    """train/loop.py::word_sweep on the card (two warm-ups, one capture,
    replays) against the eager loop of loss, gradient and Optimizer.step
    over 300 words at T = 136 with their select_batch draws: params,
    moments and the summed loss 0 apart."""
    from metaviterbinet_tpu_torch import Config
    from metaviterbinet_tpu_torch.detectors import DETECTORS
    from metaviterbinet_tpu_torch.online.graphs import WARMUP_STEPS, GraphedStep
    from metaviterbinet_tpu_torch.train.losses import make_loss_fn, select_batch
    from metaviterbinet_tpu_torch.train.loop import word_sweep
    cfg, spec = Config(), DETECTORS[name]
    eager, graphed = (spec.model.param_dict(spec.init(cfg, torch.Generator(
        device="cuda").manual_seed(3), "cuda")) for _ in range(2))
    n_words, T = 300, 136
    rx = torch.randn((n_words, T), generator=gen, device="cuda")
    tx = torch.randint(0, 2, (n_words, T), generator=gen, device="cuda").float()
    select = [select_batch(T, cfg.train_minibatch_size, gen, "cuda") for _ in range(n_words)]
    loss_fn = make_loss_fn(spec.score, spec.label_kind, cfg.memory_length, True)
    opt = Optimizer("Adam", cfg.lr)
    s_eager, s_graphed = opt.init(eager), opt.init(graphed)
    want = rx.new_zeros(())
    for i in range(n_words):
        loss = loss_fn(eager, rx[i:i + 1], tx[i:i + 1], select[i])
        opt.step(eager, dict(zip(eager, torch.autograd.grad(loss, list(eager.values())))),
                 s_eager)
        want = want + loss.detach()
    GraphedStep.counts.pop("word_sweep", None)
    got = word_sweep(loss_fn, opt, graphed, s_graphed, rx, tx, select)
    torch.cuda.synchronize()
    assert GraphedStep.counts["word_sweep"] == {"direct": 0, "warmup": WARMUP_STEPS,
                                                "capture": 1, "replay": n_words - WARMUP_STEPS}
    assert torch.equal(got, want)
    for a, b in ((eager, graphed), (s_eager.mu, s_graphed.mu), (s_eager.nu, s_graphed.nu)):
        assert chip_smoke.tensors_apart(list(a.values()), list(b.values())) == 0.0


@pytest.mark.parametrize("name", ["va", "vnet", "lstm"])
def test_engine_blocks_graphed_equal_the_blocks_uncaptured(gen, name):
    """run_online's detect, RS decode and score as graphed calls (va: K2,
    vnet: the MLP and K5, lstm: cuDNN) against the same calls with capture
    patched out (chip_smoke.no_capture), on 15 blocks (3 pilots, 12 data
    blocks) at the protocol's width with seeded random params and no
    adaptation: SERs per block equal and the same launches, one K2 or K5
    per block, none for the LSTM."""
    from metaviterbinet_tpu_torch import Config
    from metaviterbinet_tpu_torch.evaluation.trainer import Trainer
    from metaviterbinet_tpu_torch.online.engine import run_online
    cfg = Config(val_frames=3, subframes_in_frame=5, use_ecc=True, n_symbols=2,
                 self_supervised=False, online_meta=False)
    trainer = Trainer(cfg, name, verbose=False)
    params = trainer.spec.init(cfg, gen, "cuda") if trainer.spec.trainable else None
    tx, rx = trainer.val_dataset.get(10.0, cfg.gamma)
    h = trainer.decoder_csi(tx.shape[0])
    runs = {}
    for captured in (True, False):
        chip_smoke.zero_launches()
        with contextlib.nullcontext() if captured else chip_smoke.no_capture():
            result = run_online(cfg, trainer.spec, params, tx, rx, h, trainer.draws)
        runs[captured] = (result.ser_by_word, chip_smoke.read_launches())
    assert tx.shape[0] == 15
    assert np.array_equal(runs[True][0], runs[False][0])
    assert runs[True][1] == runs[False][1]
    want = {"va": "fused_va_detect", "vnet": "viterbi_decode_kernel"}.get(name)
    assert sum(runs[True][1].values()) == (15 if want else 0)
    if want:
        assert runs[True][1][want] == 15


@pytest.mark.parametrize("name,mode", [("vnet", "online"), ("lstm", "online"),
                                       ("meta_vnet", "meta")])
def test_engine_online_blocks_graphed_equal_the_blocks_uncaptured(gen, name, mode):
    """run_online with adaptation on the card, 15 blocks at the protocol's
    width, ser_thresh 1 (every block gated) and 20 self-supervised steps a
    block: the block, restore and adapt graphs (the steps under the gate's
    IF node, K6 for meta_vnet) against the same calls with capture patched
    out, from the same draws: SERs per block and final params equal, the
    same launches (K6 one per gated block) and MAML pair steps, one host
    read (the meta slots decided on the device)."""
    from metaviterbinet_tpu_torch import Config
    from metaviterbinet_tpu_torch.evaluation.trainer import Trainer
    from metaviterbinet_tpu_torch.online.engine import Draws, run_online
    cfg = Config(val_frames=3, subframes_in_frame=5, use_ecc=True, n_symbols=2, ser_thresh=1.0,
                 self_supervised=True, online_meta=mode == "meta", meta_subframes=3,
                 self_supervised_iterations=20)
    trainer = Trainer(cfg, name, verbose=False)
    params = trainer.spec.init(cfg, gen, "cuda")
    tx, rx = trainer.val_dataset.get(10.0, cfg.gamma)
    h = trainer.decoder_csi(tx.shape[0])
    runs = {}
    for captured in (True, False):
        draws = Draws(cfg, trainer.spec, torch.device("cuda"),
                      torch.Generator(device="cuda").manual_seed(5),
                      torch.Generator().manual_seed(5))
        chip_smoke.zero_launches()
        with contextlib.nullcontext() if captured else chip_smoke.no_capture():
            result = run_online(cfg, trainer.spec, params, tx, rx, h, draws)
        runs[captured] = (result, chip_smoke.read_launches())
    (g, g_launches), (u, u_launches) = runs[True], runs[False]
    assert np.array_equal(g.ser_by_word, u.ser_by_word)
    assert g_launches == u_launches
    assert g.n_gated == u.n_gated == 15
    assert g.host_reads == u.host_reads == 1
    assert g.steps["maml"] == u.steps["maml"]
    if mode == "meta":  # slots at blocks 3, 6, 9 and 12
        assert g_launches["online_adapt_viterbinet"] == 15 and g.steps["maml"] > 0
    model = trainer.spec.model
    assert chip_smoke.tensors_apart(list(model.param_dict(g.params).values()),
                                    list(model.param_dict(u.params).values())) == 0.0


@pytest.mark.parametrize("name,mode", [("va", "joint"), ("vnet", "joint"), ("vnet", "online"),
                                       ("meta_vnet", "meta")])
def test_blocks_after_the_captures_make_no_host_sync(gen, name, mode):
    """run_online's block loop on the card under
    torch.cuda.set_sync_debug_mode("error") from the block after its last
    capture up to the end-of-run read (chip_smoke.SyncChecked): no
    operation synchronises with the host, and the run makes one host read.
    The meta run (every block gated, a meta slot every 3 blocks, all its
    graphs captured by block 9) takes its meta slots at blocks 12, 15 and
    18 under the check."""
    from metaviterbinet_tpu_torch import Config
    from metaviterbinet_tpu_torch.evaluation.trainer import Trainer
    from metaviterbinet_tpu_torch.online.engine import run_online
    from metaviterbinet_tpu_torch.online.graphs import GraphedStep
    meta = dict(ser_thresh=1.0, meta_subframes=3) if mode == "meta" else {}
    cfg = Config(val_frames=4, subframes_in_frame=5, use_ecc=True, n_symbols=2,
                 self_supervised=mode != "joint", online_meta=mode == "meta",
                 self_supervised_iterations=20, **meta)
    trainer = Trainer(cfg, name, verbose=False)
    params = trainer.spec.init(cfg, gen, "cuda") if trainer.spec.trainable else None
    tx, rx = trainer.val_dataset.get(10.0, cfg.gamma)
    h = trainer.decoder_csi(tx.shape[0])
    GraphedStep.counts.clear()
    with chip_smoke.SyncChecked(contextlib.nullcontext) as checked:
        result = run_online(cfg, trainer.spec, params, tx, rx, h, trainer.draws, spans=checked)
    assert checked.armed_at == 11  # the pilot graph captures at block 10
    assert result.host_reads == 1
    if mode == "meta":
        assert result.steps["maml"] > 0


# ------------------------------------------------ the meta slot on the card

@pytest.mark.parametrize("name,weights_init", [
    ("meta_vnet", "last_frame"), ("meta_vnet", "meta_training"), ("meta_vnet", "random"),
    ("meta_lstm", "last_frame")])
def test_meta_slot_graphed_equals_the_slot_uncaptured(gen, name, weights_init):
    """run_online's meta slots as graphs on the card (the restore that
    weights_init names and the saved params under IF nodes on do_meta, the
    masked MAML pairs in chunk graphs, each pair under an IF node on
    do_meta & fresh) against the same calls with capture patched out, 10
    blocks at the protocol's width, every block gated, slots at blocks 3, 6
    and 9 (the first with 4 words buffered, so its draws repeat): SERs per
    block, MAML pair steps and launches equal, one host read, final params
    0 apart (meta_lstm within chip_smoke.STEP_TOL: its second-order step
    does not repeat bit for bit on fresh tensors)."""
    from metaviterbinet_tpu_torch import Config
    from metaviterbinet_tpu_torch.evaluation.trainer import Trainer
    from metaviterbinet_tpu_torch.online.engine import Draws, run_online
    lstm_cut = dict(meta_train_iterations=2, meta_j_num=4) if name == "meta_lstm" else {}
    cfg = Config(val_frames=2, subframes_in_frame=5, use_ecc=True, n_symbols=2, ser_thresh=1.0,
                 self_supervised=True, online_meta=True, meta_subframes=3,
                 self_supervised_iterations=4, weights_init=weights_init, **lstm_cut)
    trainer = Trainer(cfg, name, verbose=False)
    params = trainer.spec.init(cfg, gen, "cuda")
    meta_init = trainer.spec.init(cfg, gen, "cuda") if weights_init == "meta_training" else None
    tx, rx = trainer.val_dataset.get(10.0, cfg.gamma)
    h = trainer.decoder_csi(tx.shape[0])
    runs = {}
    for captured in (True, False):
        draws = Draws(cfg, trainer.spec, torch.device("cuda"),
                      torch.Generator(device="cuda").manual_seed(5),
                      torch.Generator().manual_seed(5))
        chip_smoke.zero_launches()
        with contextlib.nullcontext() if captured else chip_smoke.no_capture():
            result = run_online(cfg, trainer.spec, params, tx, rx, h, draws,
                                meta_init_params=meta_init)
        runs[captured] = (result, chip_smoke.read_launches())
    (g, g_launches), (u, u_launches) = runs[True], runs[False]
    assert np.array_equal(g.ser_by_word, u.ser_by_word)
    assert g_launches == u_launches
    assert g.host_reads == u.host_reads == 1
    draws_made = 3 * cfg.meta_train_iterations * cfg.meta_j_num
    assert 0 < g.steps["maml"] == u.steps["maml"] < draws_made
    model = trainer.spec.model
    tol = chip_smoke.STEP_TOL.get((f"{name} maml", True), 0.0) if name == "meta_lstm" else 0.0
    assert chip_smoke.tensors_apart(list(model.param_dict(g.params).values()),
                                    list(model.param_dict(u.params).values())) <= tol


def test_duplicate_pairs_leave_the_count_unchanged_on_the_card(gen):
    """online/engine.py::make_meta_steps' pairs on the card, a slot's 20 x
    10 pairs a graph, one K7 launch under do_meta's IF node (the engine's
    fused path): over warm-ups, the capture and replays, each slot's Adam
    count advances by the distinct draws of each of its iterations at the
    fill's bound and the device's pair count with it; a duplicate draw, and
    every pair at a fill of 2 (do_meta false), leaves params, moments and
    count as they were; the params equal the same calls made directly."""
    from metaviterbinet_tpu_torch import Config
    from metaviterbinet_tpu_torch.detectors import DETECTORS
    from metaviterbinet_tpu_torch.online.engine import make_meta_steps, n_bounds, uses_fused_maml
    from metaviterbinet_tpu_torch.train.losses import make_loss_fn
    cfg = Config(buffer_capacity=32)
    spec = DETECTORS["meta_vnet"]
    rows = [[5, 5, 5, 5, 5, 5, 5, 5, 5, 5], [0, 1, 2, 3, 4, 5, 6, 7, 8, 9],
            [3, 1, 3, 1, 3, 1, 3, 1, 3, 1], [9, 9, 0, 0, 4, 4, 2, 2, 7, 7]]
    fills = (12, 12, 2, 12, 12, 2, 12)  # bound 10 where the fill is 12
    iterations = cfg.meta_train_iterations
    buf_rx = torch.randn((32, 136), generator=gen, device="cuda")
    buf_tx = torch.randint(0, 2, (32, 136), generator=gen, device="cuda").float()
    after = {}
    for captured in (True, False):
        opt = Optimizer("Adam", cfg.lr)
        p = spec.model.param_dict(spec.init(cfg, torch.Generator(device="cuda").manual_seed(1),
                                            "cuda"))
        state = opt.init(p)
        loss_fn = make_loss_fn(spec.meta_score, "states", cfg.memory_length, False)
        _, pairs, _ = make_meta_steps(cfg, opt, loss_fn, iterations * 10,
                                      uses_fused_maml(cfg, spec))
        first = torch.zeros(1, dtype=torch.int64, device="cuda")
        launches = maml_pairs.maml_pairs_viterbinet.launches
        st = {"buf_rx": buf_rx.clone(), "buf_tx": buf_tx.clone(),
              "start": torch.tensor(30, dtype=torch.int32, device="cuda"),
              "n_valid": torch.zeros((), dtype=torch.int32, device="cuda"),
              "pairs": torch.zeros((), dtype=torch.int32, device="cuda"),
              "loss": torch.zeros((), device="cuda")}
        count = 0
        with contextlib.nullcontext() if captured else chip_smoke.no_capture():
            for i, fill in enumerate(fills):
                slot = [rows[(i + r) % len(rows)] for r in range(iterations)]
                table = torch.zeros((iterations, n_bounds(cfg), 10), dtype=torch.int64,
                                    device="cuda")
                table[:, 9] = torch.tensor(slot, device="cuda")
                st["n_valid"].fill_(fill)
                before = [t.detach().clone() for t in (*p.values(), *state.mu.values())]
                pairs(p, state, st, table, first)
                if fill > 2:
                    count += sum(len(set(r)) for r in slot)
                else:
                    now = [t.detach().clone() for t in (*p.values(), *state.mu.values())]
                    assert all(torch.equal(a, b) for a, b in zip(before, now)), i
                assert int(state.count) == int(st["pairs"]) == count, i
        # K7 once a call where do_meta held, counted once the step settles
        # its IF nodes' hits
        pairs.settle([int(h) for h, _ in pairs.conditional])
        assert maml_pairs.maml_pairs_viterbinet.launches - launches == sum(f > 2 for f in fills)
        after[captured] = [t.detach().clone() for t in p.values()]
    assert all(torch.equal(a, b) for a, b in zip(after[True], after[False]))


def test_fused_slot_in_one_call_equals_its_iterations_on_the_card(gen):
    """make_meta_steps' fused pairs on the card, a slot's 20 x 10 pairs in
    one graphed call with one K7 launch under do_meta's IF node, over two
    warm-ups, the capture and two replays, against the same calls
    uncaptured (chip_smoke.no_capture) and against the slots as 20 direct
    K7 launches of an iteration's 10 pairs each (chip_smoke.k7_iterations):
    after every slot, params, moments, count, summed query loss and pair
    count torch.equal; K7's launches up by one a call where do_meta held
    (20 for the iterations). Fills of 12, 2 (do_meta false), 32 (the ring
    full, started at slot 30), 5 (bound 3: most draws repeat) and 12; each
    slot's draws chip_smoke.k7_slot_table's, 0 twice in its first iteration
    and again in its second."""
    from metaviterbinet_tpu_torch import Config
    from metaviterbinet_tpu_torch.detectors import DETECTORS
    from metaviterbinet_tpu_torch.online.engine import make_meta_steps
    cfg = Config(buffer_capacity=32)
    spec = DETECTORS["meta_vnet"]
    fills = (12, 2, 32, 5, 12)
    buf_rx = torch.randn((32, 136), generator=gen, device="cuda")
    buf_tx = torch.randint(0, 2, (32, 136), generator=gen, device="cuda").float()
    tables = [chip_smoke.k7_slot_table(cfg, gen) for _ in fills]
    runs = {}
    for how in ("captured", "uncaptured", "iterations"):
        opt = Optimizer("Adam", cfg.lr)
        p = spec.model.param_dict(spec.init(cfg, torch.Generator(device="cuda").manual_seed(1),
                                            "cuda"))
        state = opt.init(p)
        _, pairs, _ = make_meta_steps(cfg, opt, None, cfg.meta_train_iterations * cfg.meta_j_num,
                                      fused=True)
        first = torch.zeros(1, dtype=torch.int64, device="cuda")
        launches = maml_pairs.maml_pairs_viterbinet.launches
        st = {"buf_rx": buf_rx.clone(), "buf_tx": buf_tx.clone(),
              "start": torch.tensor(30, dtype=torch.int32, device="cuda"),
              "n_valid": torch.zeros((), dtype=torch.int32, device="cuda"),
              "pairs": torch.zeros((), dtype=torch.int32, device="cuda"),
              "loss": torch.zeros((), device="cuda")}
        after = []
        with chip_smoke.no_capture() if how == "uncaptured" else contextlib.nullcontext():
            for fill, table in zip(fills, tables):
                st["n_valid"].fill_(fill)
                if how == "iterations":
                    chip_smoke.k7_iterations(cfg, opt, p, state, st, table)
                else:
                    pairs(p, state, st, table, first)
                after.append([t.detach().clone() for t in (
                    *p.values(), *state.mu.values(), *state.nu.values(), state.count,
                    st["loss"], st["pairs"])])
        pairs.settle([int(h) for h, _ in pairs.conditional])
        per_call = cfg.meta_train_iterations if how == "iterations" else 1
        assert maml_pairs.maml_pairs_viterbinet.launches - launches == \
            per_call * sum(f > 2 for f in fills), how
        runs[how] = after
    assert int(runs["captured"][-1][-1]) > 0
    for how in ("uncaptured", "iterations"):
        for i, (a, b) in enumerate(zip(runs["captured"], runs[how])):
            assert all(torch.equal(x, y) for x, y in zip(a, b)), (how, i)


# ------------------------------------------- the tracer's stamps on the card

def _device_activities(fn) -> list:
    """(start ms on the wall clock, name) of every device activity of fn()
    (kernels, copies, fills) under torch.profiler, in the order they
    started."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted((e.start_ns() / 1e6, e.name()) for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA)


def _meta_run_inputs(gen, n):
    from metaviterbinet_tpu_torch import Config
    from metaviterbinet_tpu_torch.evaluation.trainer import Trainer
    from metaviterbinet_tpu_torch.online.engine import Draws
    cfg = Config(eval_mode="by_word", fading_taps_type=2, val_frames=12, self_supervised=True,
                 online_meta=True)
    trainer = Trainer(cfg, "meta_vnet", verbose=False)
    params = trainer.spec.init(cfg, gen, "cuda")
    tx, rx = trainer.val_dataset.get(10.0, cfg.gamma)
    h = trainer.decoder_csi(tx.shape[0])
    draws = Draws(cfg, trainer.spec, torch.device("cuda"),
                  torch.Generator(device="cuda").manual_seed(5), torch.Generator().manual_seed(5))
    return cfg, trainer.spec, params, tx[:n], rx[:n], h[:n], draws


def test_tracer_stamps_accumulate_in_a_graph_and_its_if_node(gen):
    """Spans opened in a GraphedStep's function and in a `when` body inside
    it (an IF node) stamp at every replay: over the warm-ups and 20
    replays, made under sync debug mode "error" after the capture, the
    inner span counts every call and the body span every call whose
    predicate held, each under the step's own span; the host read only in
    the warm-ups' `when` (host_syncs)."""
    from metaviterbinet_tpu_torch.online.graphs import WARMUP_STEPS, GraphedStep, when
    from metaviterbinet_tpu_torch.utils import profiling
    from metaviterbinet_tpu_torch.utils.profiling import Tracer

    def body(st):
        with profiling.span("body"):
            st["x"].add_(1.0)

    def fn(st, pred):
        with profiling.span("inner"):
            st["y"].add_(1.0)
        when(pred, body, st)

    st = {"x": torch.zeros((), device="cuda"), "y": torch.zeros((), device="cuda")}
    preds = [i % 3 != 1 for i in range(WARMUP_STEPS + 20)]
    pred_tensors = [torch.tensor(v, device="cuda") for v in preds]
    call = GraphedStep(fn, "traced step", n_state=1)
    GraphedStep.counts.pop("traced step", None)
    tracer = Tracer()
    try:
        with tracer:
            for i, pred in enumerate(pred_tensors):
                if i == WARMUP_STEPS + 1:  # after the capture and its replay
                    torch.cuda.set_sync_debug_mode("error")
                call(st, pred)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    s = tracer.summary()
    assert float(st["y"]) == len(preds) and float(st["x"]) == sum(preds)
    assert s.dropped == 0
    assert s.by_name["traced step"].count == s.by_name["inner"].count == len(preds)
    assert s.by_name["body"].count == sum(preds)
    assert s.by_name["traced step.capture"].count == 1
    names = [sp.name for sp in s.spans]
    for sp in s.spans:
        if sp.name in ("inner", "body"):
            assert s.spans[sp.parent].name in ("traced step", "traced step.warmup")
            assert sp.host is None or s.spans[sp.parent].name == "traced step.warmup"
    assert names.count("traced step.warmup") == WARMUP_STEPS
    assert GraphedStep.counts["traced step"]["replay"] == len(preds) - WARMUP_STEPS
    assert s.counters[None]["host_syncs"] == WARMUP_STEPS


def test_tracer_clock_agrees_with_the_profiler(gen):
    """A 50-block meta_vnet run, traced and under torch.profiler: every
    stamp of the tracer's spans, on the host's clock, lies within 50 us of
    the profiler's start of a stamp kernel, and every stamp kernel the
    profiler saw in the run within 50 us of one of the tracer's (matched to
    the nearest: the profiler has been seen to drop an activity in a few
    thousand, PERF.md); the run reads the device once; the tracer holds
    the run's spans, by name as many as its blocks, candidate meta slots and
    graphed steps make, each stamped twice."""
    from collections import Counter

    from metaviterbinet_tpu_torch.online.engine import meta_slots, run_online
    from metaviterbinet_tpu_torch.online.graphs import WARMUP_STEPS
    from metaviterbinet_tpu_torch.utils import profiling
    from metaviterbinet_tpu_torch.utils.profiling import Tracer
    cfg, spec, params, tx, rx, h, draws = _meta_run_inputs(gen, 50)
    tracer = Tracer()
    results = []

    def traced():
        with tracer:
            results.append(run_online(cfg, spec, params, tx, rx, h, draws))

    activities = _device_activities(traced)
    s = tracer.summary()
    # the profiler sees the start's last calibrations, the spans' stamps and
    # the window's end
    profiled = np.asarray([t for t, name in activities if "stamp_kernel" in name])
    ours = np.asarray(sorted(t for sp in s.spans for t in sp.device))
    assert s.dropped == 0 and results[0].host_reads == 1
    # every span of the run, each stamped twice: a block's eight, a
    # candidate meta slot's four (its pairs one graphed call), each graphed
    # step's warm-ups and capture (the block's pilot graph, with two pilots
    # in 50 blocks, only warmed up) and the run's
    slots = len(meta_slots(cfg, 50))
    want = Counter({name: 50 for name in ("detect", "block", "detect.viterbi", "detect.rs_decode",
                                          "detect.label", "adapt", "restore", "self_supervised")})
    want.update({name: slots for name in ("meta", "meta_restore", "maml", "meta_save")})
    for name in ("restore", "self_supervised", "meta_restore", "maml", "meta_save"):
        want.update({f"{name}.warmup": WARMUP_STEPS, f"{name}.capture": 1})
    want.update({"block.warmup": 2 * WARMUP_STEPS, "block.capture": 1, "run": 1, "start": 1,
                 "sync": 1})
    assert Counter(sp.name for sp in s.spans) == want
    assert len(ours) == 2 * sum(want.values())
    assert len(profiled) <= len(ours) + profiling.CALIBRATIONS + 1

    def nearest(a, b):
        i = np.clip(np.searchsorted(b, a), 1, len(b) - 1)
        return np.minimum(np.abs(a - b[i - 1]), np.abs(a - b[i]))

    in_run = profiled[(profiled >= ours[0] - 0.05) & (profiled <= ours[-1] + 0.05)]
    assert float(nearest(ours, profiled).max()) < 0.05
    assert float(nearest(in_run, ours).max()) < 0.05


def test_tracer_accounts_for_a_traced_meta_run(gen):
    """A 50-block meta_vnet run traced (no profiler): the summary's covered
    and idle time add up to its window within 1%; the replayed block graph
    is its three parts within 5% (a warm-up runs them in a "block.warmup"
    span, a capture runs nothing in its "block.capture"); every block has
    its spans, and the counts of graphed calls, launches, host syncs and
    uploads are the card's."""
    from metaviterbinet_tpu_torch.kernels.acs import viterbi_decode_kernel
    from metaviterbinet_tpu_torch.online.engine import run_online
    from metaviterbinet_tpu_torch.online.graphs import WARMUP_STEPS, GraphedStep
    from metaviterbinet_tpu_torch.utils.profiling import Tracer
    cfg, spec, params, tx, rx, h, draws = _meta_run_inputs(gen, 50)
    GraphedStep.counts.pop("block", None)
    viterbi_decode_kernel.launches = 0
    with Tracer() as tracer:
        result = run_online(cfg, spec, params, tx, rx, h, draws)
    s = tracer.summary()
    assert s.dropped == 0 and result.host_reads == 1
    assert s.covered_ms + sum(s.idle_ms.values()) == pytest.approx(s.window_ms, rel=0.01)
    parts: dict = {}
    for sp in s.spans:
        if sp.name.startswith("detect.") and s.spans[sp.parent].name == "block":
            parts[sp.parent] = parts.get(sp.parent, 0.0) + sp.device[1] - sp.device[0]
    for sp in s.spans:
        if sp.name == "block.capture":
            parts.pop(sp.parent, None)
    blocks = sum(s.spans[i].device[1] - s.spans[i].device[0] for i in parts)
    assert len(parts) == 50 - 2 * WARMUP_STEPS - 1  # the data graph's replays
    assert sum(parts.values()) == pytest.approx(blocks, rel=0.05)
    assert s.by_name["detect"].count == s.by_name["block"].count == 50
    assert GraphedStep.counts["block"]["replay"] == 50 - 2 * WARMUP_STEPS  # the capture too
    assert viterbi_decode_kernel.launches == 50
    counts = s.counters[1]
    assert counts["upload_bytes"] > 0 and counts["host_syncs"] > 1


# run in a process of its own: after other tests in the same process the
# profiler has been seen to report a few copies fewer (PERF.md)
_TRACED_OFF_AND_ON = """
import json
from collections import Counter

import torch
from torch.profiler import ProfilerActivity, profile

from metaviterbinet_tpu_torch import Config
from metaviterbinet_tpu_torch.evaluation.trainer import Trainer
from metaviterbinet_tpu_torch.online.engine import run_online
from metaviterbinet_tpu_torch.utils.profiling import Tracer

cfg = Config(val_frames=3, subframes_in_frame=5, use_ecc=True, n_symbols=2,
             self_supervised=False, online_meta=False)
trainer = Trainer(cfg, "vnet", verbose=False)
params = trainer.spec.init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
tx, rx = trainer.val_dataset.get(10.0, cfg.gamma)
h = trainer.decoder_csi(tx.shape[0])


def activities():
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_online(cfg, trainer.spec, params, tx, rx, h, trainer.draws)
        torch.cuda.synchronize()
    return Counter(e.name() for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA)


run_online(cfg, trainer.spec, params, tx, rx, h, trainer.draws)  # tables uploaded once
off = activities()
with Tracer() as tracer:
    on = activities()
print(json.dumps({"off": off, "on": on, "spans": len(tracer.summary().spans)}))
"""


def test_a_run_traced_off_launches_no_stamp(gen):
    """A vnet joint run of 15 blocks with no tracer active captures its
    graphs with no stamp node: it launches no stamp kernel, and every other
    device activity that the same run has under a tracer, as many times
    (torch.profiler's names and counts, in a process of its own); the
    traced run launches two stamps a span."""
    import json
    import os
    import subprocess
    import sys
    from collections import Counter

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", _TRACED_OFF_AND_ON], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    off, on = Counter(got["off"]), Counter(got["on"])
    stamps = {name for name in on if "stamp_kernel" in name}
    assert not [name for name in off if "stamp_kernel" in name]
    assert off == Counter({k: v for k, v in on.items() if k not in stamps})
    assert sum(on[name] for name in stamps) == 2 * got["spans"]
