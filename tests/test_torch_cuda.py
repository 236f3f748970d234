"""The port's CUDA kernels against their plain PyTorch versions, and the
LSTM family's forwards, MAML step and online step, on a card.

Marked `cuda`; each test skips without a CUDA device. The file imports no
JAX, so it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import copy

import pytest
import torch

import chip_smoke
from metaviterbinet_tpu_torch.kernels import acs, online_sgd
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
    K1 and K4 run) against `_bf16_priors` on the same samples, within
    chip_smoke.TILE_TOL (its comment gives the reason)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    model = viterbinet.init_params(S, gen, device="cuda")
    y = 2 * torch.randn(64, generator=gen, device="cuda")
    got = acs.viterbinet_tile_priors(model, y)
    want = acs._bf16_priors(model, y[None]).reshape(64, S)
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
