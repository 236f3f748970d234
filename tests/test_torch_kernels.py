"""The port's fused detect kernels, through their plain PyTorch versions on
the CPU, against the JAX package's Pallas kernels (interpret mode on the
CPU, as tests/test_kernels.py runs them) and unfused detectors. The CUDA
kernels themselves are held against their plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from metaviterbinet_tpu.kernels import acs as jacs
from metaviterbinet_tpu.models import va as jva
from metaviterbinet_tpu.models import viterbinet as jvnet
from metaviterbinet_tpu_torch.detectors import DETECTORS
from metaviterbinet_tpu_torch.kernels import acs as tacs
from metaviterbinet_tpu_torch.models import va as tva
from metaviterbinet_tpu_torch.models import viterbinet as tvnet
from metaviterbinet_tpu_torch.weights import params_from_jax


def _va_inputs(W, T, seed, L=4):
    rng = np.random.default_rng(seed)
    h = (np.exp(-0.2 * np.arange(L))[None] * (1 + 0.1 * rng.normal(size=(W, L)))).astype(np.float32)
    y = rng.normal(size=(W, T)).astype(np.float32)
    return y, h


def test_state_symbols_match_jax():
    for L in (2, 4):
        np.testing.assert_array_equal(tva.state_symbols(2 ** L, L), jva.state_symbols(2 ** L, L))


def test_state_means_match_jax():
    _, h = _va_inputs(128, 1, 0)
    want = np.asarray(jnp.asarray(h) @ jnp.asarray(jva.state_symbols(16, 4)).T)
    np.testing.assert_allclose(tva.state_means(torch.tensor(h)).numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("T", [40, 41])
def test_va_branch_priors_match_jax(T):
    y, h = _va_inputs(128, T, T)
    mu = tva.state_means(torch.tensor(h))
    want = np.asarray(jva.branch_priors(jnp.asarray(y), jnp.asarray(h)))
    np.testing.assert_allclose(tva.branch_priors_from_mu(torch.tensor(y), mu).numpy(), want,
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("T", [40, 41])
def test_fused_va_detect_bit_identical_to_jax(T):
    """Same mu on both sides, so that no matmul order can flip a near-tie:
    the port's kernel (plain version on the CPU) equals JAX fused_va_detect
    in both of its modes and the JAX scan path, bit for bit."""
    y, h = _va_inputs(128, T, 5)
    mu = np.asarray(jnp.asarray(h) @ jnp.asarray(jva.state_symbols(16, 4)).T)
    got = tacs.fused_va_detect(torch.tensor(y), torch.tensor(mu)).numpy()
    for two_step in (False, True):
        np.testing.assert_array_equal(
            got, np.asarray(jacs.fused_va_detect(jnp.asarray(y), jnp.asarray(mu), two_step=two_step)))
    np.testing.assert_array_equal(got, np.asarray(jva.detect(jnp.asarray(y), jnp.asarray(h))))
    # and through the port's own state means
    np.testing.assert_array_equal(tva.detect(torch.tensor(y), torch.tensor(h)).numpy(), got)


def test_params_from_jax_is_a_plain_copy():
    params = jvnet.init_params(jax.random.PRNGKey(0), 16)
    model = params_from_jax({k: np.asarray(v) for k, v in params.items()}, device="cpu")
    for layer, (w, b) in {"fc1": ("w1", "b1"), "fc2": ("w2", "b2"), "fc3": ("w3", "b3")}.items():
        np.testing.assert_array_equal(getattr(model, layer).weight.detach().numpy(), params[w])
        np.testing.assert_array_equal(getattr(model, layer).bias.detach().numpy(), params[b])
    bad = {k: np.asarray(v) for k, v in params.items()}
    bad["w2"] = bad["w2"].T
    with pytest.raises(ValueError, match="w2"):
        params_from_jax(bad, device="cpu")


def test_viterbinet_score_matches_jax():
    params = jvnet.init_params(jax.random.PRNGKey(1), 16)
    model = params_from_jax({k: np.asarray(v) for k, v in params.items()}, device="cpu")
    y = np.random.default_rng(2).normal(size=(32, 24)).astype(np.float32)
    want = np.asarray(jvnet.score(params, jnp.asarray(y)))
    with torch.no_grad():
        got = tvnet.score(model, torch.tensor(y)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("W,T", [(128, 48), (256, 24)])
def test_fused_viterbinet_detect_matches_jax(W, T):
    """The kernel's bf16-rounded MLP (plain version on the CPU) against the
    JAX fused kernel (interpret) and the JAX f32 unfused detector: the JAX
    package's own contract, < 1e-3 bit mismatch (tests/test_kernels.py)."""
    params = jvnet.init_params(jax.random.PRNGKey(0), 16)
    model = params_from_jax({k: np.asarray(v) for k, v in params.items()}, device="cpu")
    y = np.random.default_rng(W + T).normal(size=(W, T)).astype(np.float32)
    got = tacs.fused_viterbinet_detect(model, torch.tensor(y)).numpy()
    assert got.shape == (W, T) and set(np.unique(got)) <= {0.0, 1.0}
    fused = np.asarray(jacs.fused_viterbinet_detect(params, jnp.asarray(y)))
    unfused = np.asarray(jvnet.detect(params, jnp.asarray(y)))
    assert np.mean(got != fused) < 1e-3
    assert np.mean(got != unfused) < 1e-3


def test_viterbinet_init_params_draws_torch_linear_family():
    g = torch.Generator().manual_seed(0)
    model = tvnet.init_params(16, g, device="cpu")
    for layer, fan_in in ((model.fc1, 1), (model.fc2, 100), (model.fc3, 50)):
        for p in (layer.weight, layer.bias):
            assert p.abs().max() <= fan_in ** -0.5
    again = tvnet.init_params(16, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(model.fc2.weight, again.fc2.weight)
    assert model.n_states == 16


@pytest.mark.parametrize("name", ["va", "vnet"])
def test_registry_detects_through_the_kernel_wrappers(name):
    """The registry's batch detect is the fused kernel's wrapper (its plain
    version for CPU tensors), and counts no launch on the CPU."""
    y, h = _va_inputs(64, 24, 7)
    y, h = torch.tensor(y), torch.tensor(h)
    before = (tacs.fused_va_detect.launches, tacs.fused_viterbinet_detect.launches)
    if name == "va":
        got = DETECTORS["va"].detect(None, y, h)
        assert torch.equal(got, tacs.fused_va_detect_plain(y, tva.state_means(h)))
        assert torch.equal(got, tva.detect(y, h))
    else:
        model = tvnet.init_params(16, torch.Generator().manual_seed(1), device="cpu")
        got = DETECTORS["vnet"].detect(model, y, None)
        assert torch.equal(got, tacs.fused_viterbinet_detect_plain(model, y))
    assert (tacs.fused_va_detect.launches, tacs.fused_viterbinet_detect.launches) == before


def test_wrappers_validate_inputs():
    y = torch.zeros((10, 8))
    with pytest.raises(ValueError, match="S must be"):
        tacs.fused_va_detect(y, torch.zeros((10, 5)))
    with pytest.raises(ValueError, match="mu"):
        tacs.fused_va_detect(y, torch.zeros((9, 16)))
    with pytest.raises(ValueError, match="float32"):
        tacs.fused_va_detect(y.double(), torch.zeros((10, 16)))
    with pytest.raises(ValueError, match="contiguous"):
        tacs.fused_va_detect(torch.zeros((8, 10)).T, torch.zeros((10, 16)))
    with pytest.raises(ValueError, match="1-100-50-S"):
        tacs.fused_viterbinet_detect(tvnet.ViterbiNet(6, device="cpu"), y)


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is neither on the CPU nor on the card raises, and a
    kernel cannot be loaded without CUDA: no silent plain-version fallback."""
    y, mu = torch.zeros((4, 8), device="meta"), torch.zeros((4, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tacs.fused_va_detect(y, mu)
    with pytest.raises(ValueError, match="params on"):
        tacs.fused_viterbinet_detect(tvnet.ViterbiNet(16, device="cpu"), y)
    with pytest.raises(ValueError, match="CUDA device"):
        tacs.viterbinet_tile_priors(tvnet.ViterbiNet(16, device="cpu"), torch.zeros(64))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tacs._library("va_detect")


def test_chain_geometry_spreads_words_over_the_sms():
    """K1's and K2's launch (csrc/prior_ring.cuh): ceil(W / SMs) words per
    block, at most one chain warp's 32; a slot of at most 128 symbols."""
    sms = 132  # an H100 SXM
    assert tacs.chain_geometry(1, sms) == (1, 128, 1)
    assert tacs.chain_geometry(300, sms) == (3, 42, 100)
    assert tacs.chain_geometry(300, sms, tacs.VA_SLOT_STEPS) == (3, 32, 100)
    assert tacs.chain_geometry(1, sms, tacs.VA_SLOT_STEPS) == (1, 32, 1)
    assert tacs.chain_geometry(65536, sms) == (32, 4, 2048)
    for W in (1, 2, 33, 131, 132, 133, 300, 1000, 4096, 4225, 65536):
        for max_steps in (tacs.SLOT_ROWS, tacs.VA_SLOT_STEPS):
            words, steps, blocks = tacs.chain_geometry(W, sms, max_steps)
            assert 1 <= words <= tacs.CHAIN_WORDS and 1 <= steps <= max_steps
            assert words * steps <= tacs.SLOT_ROWS
            assert blocks * words >= W > (blocks - 1) * words and blocks <= max(sms, W // 32 + 1)


@pytest.mark.parametrize("W", [1, 300, 65536])
@pytest.mark.parametrize("C,T,overlap", [(2, 136, 32), (3, 135, 32), (4, 136, 32), (40, 80, 2)])
def test_chunked_geometry_covers_every_chain(W, C, T, overlap):
    """K4's launch (csrc/viterbinet_detect_chunked.cu): at most one chain
    warp's 32 chains per set, whole words of them where C <= 32; slots of at
    most 192 symbols, warm-up slots of the warming chains and stored slots
    of all chains, whose steps are a multiple of 4 where 4 divides the
    chunk length (the kernel then stores the bits 4 at a time); every chain
    in one set, and at most one block per SM, each with at least one set."""
    sms = 132
    g = tacs.chunked_geometry(W, C, T, overlap, sms)
    assert 1 <= g.chains <= tacs.CHAIN_WORDS and 1 <= g.slot_steps and 1 <= g.warm_steps <= overlap
    assert g.chains * g.slot_steps <= tacs.K4_SLOT_ROWS
    assert g.warm_steps * tacs.warming_chains(g.chains, C) <= tacs.K4_SLOT_ROWS
    if C <= tacs.CHAIN_WORDS:
        assert g.chains % C == 0
    assert (T // C) % 4 or g.slot_steps % 4 == 0
    assert g.sets * g.chains >= W * C > (g.sets - 1) * g.chains
    assert 1 <= g.blocks <= min(sms, g.sets)


def test_chunked_geometry_at_the_protocol_width():
    """300 words at C = 4 and 2 spread over 100 of the 132 SMs, as K1's
    300 words do; 65536 words fill every chain lane of one block per SM."""
    assert tacs.chunked_geometry(300, 4, 136, 32, 132) == (12, 21, 16, 100, 100)
    assert tacs.chunked_geometry(300, 2, 136, 32, 132) == (6, 32, 32, 100, 100)
    assert tacs.chunked_geometry(65536, 4, 136, 32, 132) == (32, 8, 6, 8192, 132)
    assert tacs.chunked_geometry(1, 4, 136, 32, 132) == (4, 32, 48, 1, 1)
    assert tacs.chunked_geometry(7, 2, 70, 32, 132) == (2, 32, 96, 7, 7)
    assert tacs.warming_chains(12, 4) == 9 and tacs.warming_chains(5, 40) == 5


def test_library_path_tracks_sources():
    a, b = tacs.library_path("va_detect"), tacs.library_path("viterbinet_detect")
    assert a != b and a.parent == tacs.BUILD_DIR and a.suffix == ".so"
    assert a == tacs.library_path("va_detect")


# ------------------------------------------------------------------ K5, K6

@pytest.mark.parametrize("S", [4, 16])
@pytest.mark.parametrize("T", [40, 41])
def test_viterbi_decode_kernel_bit_identical_to_jax(S, T):
    """K5's plain version (the wrapper on CPU tensors) against the JAX
    Pallas decode in interpret mode: the same bits."""
    priors = np.random.default_rng(S * T).normal(size=(128, T, S)).astype(np.float32)
    before = tacs.viterbi_decode_kernel.launches
    got = tacs.viterbi_decode_kernel(torch.tensor(priors)).numpy()
    assert tacs.viterbi_decode_kernel.launches == before
    np.testing.assert_array_equal(got, np.asarray(jacs.pallas_viterbi_decode(jnp.asarray(priors))))


def test_vnet_engine_detect_matches_jax_f32_detect():
    """The engine's ViterbiNet detect (f32 MLP, then K5) gives the JAX
    unfused f32 detector's bits; it is not K1, whose bf16 rounding differs."""
    params = jvnet.init_params(jax.random.PRNGKey(4), 16)
    model = params_from_jax({k: np.asarray(v) for k, v in params.items()}, device="cpu")
    y = np.random.default_rng(5).normal(size=(64, 40)).astype(np.float32)
    got = DETECTORS["meta_vnet"].engine_detect(model, torch.tensor(y), None).numpy()
    np.testing.assert_array_equal(got, np.asarray(jvnet.detect(params, jnp.asarray(y))))


def _k6_inputs(T, seed=0):
    from metaviterbinet_tpu.ops.trellis import calculate_states as j_states
    params = jvnet.init_params(jax.random.PRNGKey(seed), 16)
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(T,)).astype(np.float32)
    states = np.asarray(j_states(4, jnp.asarray(rng.integers(0, 2, size=(1, T)).astype(np.float32))))
    return params, y, states


@pytest.mark.parametrize("T,seed", [(40, 1), (33, 2)])
def test_online_adapt_plain_matches_jax_kernel(T, seed):
    """K6's plain version against the JAX fused kernel (interpret mode), the
    JAX contract of tests/test_online_sgd_kernel.py: 5e-6 after 40 steps and
    2e-5 after resuming from the returned moments and count for 40 more.

    Adam on one word amplifies rounding differences once its fit saturates.
    On seed 0 at T = 40 the JAX kernel itself ends 9.5e-4 from a float64 run
    after 80 steps while the port stays 2.3e-6 from it
    (test_online_adapt_f32_drift_is_rounding holds both to that witness on
    a fixed list of words), so the direct comparison uses words on which the
    JAX kernel stays near float64."""
    from metaviterbinet_tpu.kernels.online_sgd import online_adapt_viterbinet as j_adapt
    from metaviterbinet_tpu_torch.kernels.online_sgd import online_adapt_viterbinet
    from metaviterbinet_tpu_torch.train.optim import Optimizer
    params, y, states = _k6_inputs(T, seed)
    zeros = jax.tree.map(jnp.zeros_like, params)
    want, mu, nu, count = j_adapt(params, zeros, zeros, jnp.int32(0), jnp.asarray(y),
                                  jnp.asarray(states), n_iters=40, lr=1e-3)
    model = params_from_jax({k: np.asarray(v) for k, v in params.items()}, device="cpu")
    p = tvnet.param_dict(model)
    state = Optimizer("Adam", 1e-3).init(p)
    yt, st = torch.tensor(y), torch.tensor(states)
    online_adapt_viterbinet(p, state, yt, st, 40, 1e-3)
    assert state.count == int(count) == 40
    for k in params:
        np.testing.assert_allclose(p[k].detach().numpy(), np.asarray(want[k]), atol=5e-6, rtol=0)
    want2, _, _, _ = j_adapt(want, mu, nu, count, jnp.asarray(y), jnp.asarray(states),
                             n_iters=40, lr=1e-3)
    online_adapt_viterbinet(p, state, yt, st, 40, 1e-3)
    assert state.count == 80
    for k in params:
        np.testing.assert_allclose(p[k].detach().numpy(), np.asarray(want2[k]), atol=2e-5, rtol=0)


# The float64 witness of K6's drift on the CPU: after 40 + 40 steps on each
# of chip_smoke.K6_WITNESS_WORDS the port's f32 plain version is within
# JAX_WITNESS_MULTIPLE times the JAX kernel's own distance from float64,
# plus chip_smoke.K6_WITNESS_FLOOR. Measured on these words (on the CPU): the
# port's distance is 0.00 to 1.31 times the JAX kernel's, largest at T = 40
# seed 3 (1.07e-6 against 8.19e-7); on seed 0 at T = 40 the JAX kernel ends
# 9.5e-4 from float64 and the port 2.3e-6. The multiple leaves 3x room over
# the largest ratio; the floor, a fifth of the 40-step contract (5e-6),
# covers words on which the JAX kernel lands within rounding of float64.
JAX_WITNESS_MULTIPLE = 4.0


@pytest.mark.parametrize("T,seed", chip_smoke.K6_WITNESS_WORDS)
def test_online_adapt_f32_drift_is_rounding(T, seed):
    """The JAX kernel (interpret mode), the port's f32 plain version and a
    float64 run of the same plain arithmetic, from the same params and zero
    moments, 40 steps and a resumed 40: how far each f32 run lies from
    float64 says whether a drift is f32 rounding that Adam amplifies, which
    both packages share, or the port's own."""
    from metaviterbinet_tpu.kernels.online_sgd import online_adapt_viterbinet as j_adapt
    from metaviterbinet_tpu_torch.kernels.online_sgd import online_adapt_viterbinet_plain
    from metaviterbinet_tpu_torch.train.optim import Optimizer
    params, y, states = _k6_inputs(T, seed)
    zeros = jax.tree.map(jnp.zeros_like, params)
    want, mu, nu, count = j_adapt(params, zeros, zeros, jnp.int32(0), jnp.asarray(y),
                                  jnp.asarray(states), n_iters=40, lr=1e-3)
    want, _, _, _ = j_adapt(want, mu, nu, count, jnp.asarray(y), jnp.asarray(states),
                            n_iters=40, lr=1e-3)
    runs = {}
    for dtype in (torch.float32, torch.float64):
        model = params_from_jax({k: np.asarray(v) for k, v in params.items()}, device="cpu")
        p = {k: v.detach().to(dtype) for k, v in tvnet.param_dict(model).items()}
        state = Optimizer("Adam", 1e-3).init(p)
        for _ in range(2):
            online_adapt_viterbinet_plain(p, state, torch.tensor(y).to(dtype),
                                          torch.tensor(states), 40, 1e-3)
        assert state.count == 80
        runs[dtype] = p

    def dist(a):
        return max(float(np.abs(np.asarray(a[k], np.float64)
                                - runs[torch.float64][k].numpy()).max()) for k in params)

    jax_f64 = dist(want)
    port_f64 = dist({k: v.numpy() for k, v in runs[torch.float32].items()})
    assert np.isfinite(jax_f64) and jax_f64 > 0
    limit = JAX_WITNESS_MULTIPLE * jax_f64 + chip_smoke.K6_WITNESS_FLOOR
    assert port_f64 <= limit, (port_f64, jax_f64)


@pytest.mark.parametrize("fault", sorted(chip_smoke.K6_FAULTS))
def test_k6_witness_rejects_faulty_runs(fault):
    """The card's witness of K6 (chip_smoke.k6_witness, witness_holds) on
    the CPU, where K6's wrapper runs its plain version: it holds there, and
    fails on every witness word when the run in K6's place has one Adam
    constant off (chip_smoke.K6_FAULTS)."""
    for T, seed in chip_smoke.K6_WITNESS_WORDS:
        inputs = chip_smoke.k6_witness_word(T, seed, "cpu")
        assert chip_smoke.witness_holds(chip_smoke.k6_witness(*inputs))
        d = chip_smoke.k6_witness(*inputs, fault=chip_smoke.K6_FAULTS[fault])
        assert not chip_smoke.witness_holds(d), ((T, seed), d)


def test_online_adapt_plain_matches_autograd_adam():
    """The hand-written backward with running Adam powers equals autograd
    through the meta loss (CE over the states, all symbols) plus
    train/optim.py's Adam (optax's b1^t) to 5e-6 after 40 steps, the same
    contract."""
    from metaviterbinet_tpu_torch.kernels.online_sgd import online_adapt_viterbinet_plain
    from metaviterbinet_tpu_torch.train.optim import Optimizer
    params, y, states = _k6_inputs(40, seed=1)
    opt = Optimizer("Adam", 1e-3)
    a = tvnet.param_dict(params_from_jax({k: np.asarray(v) for k, v in params.items()}, "cpu"))
    b = tvnet.param_dict(params_from_jax({k: np.asarray(v) for k, v in params.items()}, "cpu"))
    sa, sb = opt.init(a), opt.init(b)
    yt, st = torch.tensor(y), torch.tensor(states)
    online_adapt_viterbinet_plain(a, sa, yt, st, 40, 1e-3)
    for _ in range(40):
        loss = torch.nn.functional.cross_entropy(tvnet.logits(b, yt[None]).reshape(-1, 16),
                                                 st.long())
        grads = torch.autograd.grad(loss, list(b.values()))
        opt.step(b, dict(zip(b, grads)), sb)
    assert sa.count == sb.count == 40
    for k in a:
        np.testing.assert_allclose(a[k].detach().numpy(), b[k].detach().numpy(), atol=5e-6)
        np.testing.assert_allclose(sa.nu[k].numpy(), sb.nu[k].numpy(), atol=1e-9, rtol=1e-4)


def test_k5_k6_wrappers_validate_inputs():
    from metaviterbinet_tpu_torch.kernels.online_sgd import online_adapt_viterbinet, smem_bytes
    from metaviterbinet_tpu_torch.train.optim import Optimizer
    with pytest.raises(ValueError, match="S=5"):
        tacs.viterbi_decode_kernel(torch.zeros((2, 3, 5)))
    with pytest.raises(ValueError, match="3-d"):
        tacs.viterbi_decode_kernel(torch.zeros((2, 3)))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tacs.viterbi_decode_kernel(torch.zeros((2, 3, 16), device="meta"))
    model = tvnet.ViterbiNet(16, device="cpu")
    p = tvnet.param_dict(model)
    state = Optimizer("Adam", 1e-3).init(p)
    y = torch.zeros(24)
    with pytest.raises(ValueError, match="len"):
        online_adapt_viterbinet(p, state, y, torch.zeros(23, dtype=torch.int32), 1, 1e-3)
    with pytest.raises(ValueError, match="int32"):
        online_adapt_viterbinet(p, state, y, torch.zeros(24), 1, 1e-3)
    small = tvnet.param_dict(tvnet.ViterbiNet(6, device="cpu"))
    with pytest.raises(ValueError, match="1-100-50-S"):
        online_adapt_viterbinet(small, Optimizer("Adam", 1e-3).init(small), y,
                                torch.zeros(24, dtype=torch.int32), 1, 1e-3)
    # per CTA of the 16-CTA cluster, which holds ceil(T / 16) columns: the
    # engine's T = 136 and T = 1000 fit a CTA's shared memory, T = 3297 (207
    # columns) is the first that does not
    assert smem_bytes(136, 16) <= smem_bytes(1000, 16) <= smem_bytes(3296, 16) <= 232448
    assert smem_bytes(3297, 16) > 232448


# ------------------------------------------------------------------ K4

def _channel_words(W, T, seed):
    """BPSK words through the 4-tap time-decay ISI channel at 10 dB, from the
    JAX package (as tests/test_kernels.py makes them)."""
    from metaviterbinet_tpu.ops.channel import isi_awgn_transmit
    from metaviterbinet_tpu.ops.modulation import bpsk_modulate
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, size=(W, T)).astype(np.float32)
    h = np.tile(np.exp(-0.2 * np.arange(4)), (W, 1)).astype(np.float32)
    padded = np.concatenate([bits, np.zeros((W, 4))], axis=1)
    return np.asarray(isi_awgn_transmit(jnp.asarray(bpsk_modulate(padded)), jnp.asarray(h),
                                        10.0, jax.random.PRNGKey(seed), 4)[:, :T])


def test_fused_viterbinet_detect_chunked_matches_jax():
    """K4's plain version (the wrapper on CPU tensors) against the JAX
    chunked Pallas kernel in interpret mode on channel words: < 1e-3 bit
    mismatch, K1's cross-package contract (the JAX kernel's bf16 rounding
    on the CPU differs from the card's)."""
    params = jvnet.init_params(jax.random.PRNGKey(0), 16)
    model = params_from_jax({k: np.asarray(v) for k, v in params.items()}, device="cpu")
    y = _channel_words(128, 64, 3)
    before = tacs.fused_viterbinet_detect_chunked.launches
    got = tacs.fused_viterbinet_detect_chunked(model, torch.tensor(y), 2, overlap=32).numpy()
    assert tacs.fused_viterbinet_detect_chunked.launches == before
    want = np.asarray(jacs.fused_viterbinet_detect_chunked(params, jnp.asarray(y), 2, overlap=32))
    assert got.shape == (128, 64) and set(np.unique(got)) <= {0.0, 1.0}
    assert np.mean(got != want) < 1e-3


@pytest.mark.parametrize("n_chunks", [2, 4])
def test_chunked_plain_bit_equal_to_k1_plain(n_chunks):
    """Overlap-save with a 32-step warm-up gives K1's bits exactly on channel
    words (tests/test_kernels.py:106-131): the same per-symbol priors, and
    the trellis forgets its start within the warm-up. Any W: 100 words."""
    model = tvnet.init_params(16, torch.Generator().manual_seed(3), device="cpu")
    y = torch.tensor(_channel_words(100, 128, 5))
    got = tacs.fused_viterbinet_detect_chunked(model, y, n_chunks, overlap=32)
    assert torch.equal(got, tacs.fused_viterbinet_detect_plain(model, y))


@pytest.fixture(scope="module")
def one_minibatch_vnet(tmp_path_factory):
    """A ViterbiNet after one training minibatch at the protocol's train size
    (the network chip_smoke.py holds K4 against K1 with)."""
    from metaviterbinet_tpu_torch import Config
    from metaviterbinet_tpu_torch.evaluation.trainer import Trainer
    return Trainer(Config(train_minibatch_num=1), "vnet", device="cpu", verbose=False,
                   weights_dir=str(tmp_path_factory.mktemp("w"))).train()


@pytest.mark.parametrize("n_chunks", [2, 4])
def test_chunked_equals_k1_at_protocol_size_after_one_minibatch(one_minibatch_vnet, n_chunks):
    """At the protocol's 300 x 136 on the 4-tap fading channel at 10 dB, K4's
    bits equal K1's once the network has trained for one minibatch: its
    priors make the trellis forget its start within the 32-step warm-up.
    (With untrained random params that need not hold: a share of a few
    thousandths of the bits may differ.)"""
    from metaviterbinet_tpu_torch.data.dataset import generate_words
    gen = torch.Generator().manual_seed(20260)
    y = generate_words(10.0, 0.2, n_words=300, block_length=120, memory_length=4, use_ecc=True,
                       n_symbols=2, channel_coefficients="time_decay", fading=True,
                       fading_taps_type=1, device="cpu", word_generator=gen,
                       noise_generator=gen)[1].contiguous()
    got = tacs.fused_viterbinet_detect_chunked(one_minibatch_vnet, y, n_chunks)
    assert torch.equal(got, tacs.fused_viterbinet_detect(one_minibatch_vnet, y))


def test_chunked_head_warm_up_is_a_fresh_start():
    """With overlap == Tc and C = 2, chunk 0 warms up on zeroed priors: its
    bits equal a decode of chunk 0 alone."""
    model = tvnet.init_params(16, torch.Generator().manual_seed(4), device="cpu")
    y = torch.randn((6, 40), generator=torch.Generator().manual_seed(5))
    got = tacs.fused_viterbinet_detect_chunked(model, y, 2, overlap=20)
    assert torch.equal(got[:, :20], tacs.fused_viterbinet_detect_plain(model, y[:, :20].contiguous()))


def test_chunked_wrapper_validates_inputs():
    """The validation errors of tests/test_kernels.py:134-142, and K1's checks."""
    model = tvnet.ViterbiNet(16, device="cpu")
    with pytest.raises(ValueError, match="chunks"):
        tacs.fused_viterbinet_detect_chunked(model, torch.zeros((128, 50)), 4)
    with pytest.raises(ValueError, match="overlap"):
        tacs.fused_viterbinet_detect_chunked(model, torch.zeros((128, 128)), 8, overlap=32)
    with pytest.raises(ValueError, match="overlap"):
        tacs.fused_viterbinet_detect_chunked(model, torch.zeros((128, 128)), 2, overlap=0)
    with pytest.raises(ValueError, match="1-100-50-S"):
        tacs.fused_viterbinet_detect_chunked(tvnet.ViterbiNet(6, device="cpu"),
                                             torch.zeros((4, 64)), 2)
    with pytest.raises(ValueError, match="float32"):
        tacs.fused_viterbinet_detect_chunked(model, torch.zeros((4, 64), dtype=torch.float64), 2)
    with pytest.raises(ValueError, match="params on"):
        tacs.fused_viterbinet_detect_chunked(model, torch.zeros((4, 64), device="meta"), 2)


def test_with_time_chunks_matches_unchunked_detect(monkeypatch):
    """Config.eval_time_chunks routes the batch detect through K4 and gives
    the unchunked detect's bits (tests/test_kernels.py:145-161), with W = 100;
    T = 50 does not divide into 4 chunks and takes K1."""
    from metaviterbinet_tpu_torch.detectors import with_time_chunks
    calls = []
    plain = tacs.fused_viterbinet_detect_chunked_plain
    monkeypatch.setattr(tacs, "fused_viterbinet_detect_chunked_plain",
                        lambda *a, **k: calls.append(a[2]) or plain(*a, **k))
    model = tvnet.init_params(16, torch.Generator().manual_seed(6), device="cpu")
    chunked = with_time_chunks(DETECTORS["vnet"], 4, overlap=32, memory_length=4)
    y = torch.tensor(_channel_words(100, 128, 9))
    np.testing.assert_array_equal(chunked.detect(model, y, None).numpy(),
                                  DETECTORS["vnet"].detect(model, y, None).numpy())
    assert calls == [4]
    y2 = torch.randn((100, 50), generator=torch.Generator().manual_seed(7))
    assert torch.equal(chunked.detect(model, y2, None), tacs.fused_viterbinet_detect_plain(model, y2))
    assert calls == [4]
    # chunks shorter than the overlap take K1 too
    y3 = torch.randn((10, 136), generator=torch.Generator().manual_seed(8))
    eight = with_time_chunks(DETECTORS["meta_vnet"], 8, overlap=32, memory_length=4)
    assert torch.equal(eight.detect(model, y3, None), tacs.fused_viterbinet_detect_plain(model, y3))
    assert calls == [4]
    assert with_time_chunks(DETECTORS["va"], 4) is DETECTORS["va"]
    assert with_time_chunks(DETECTORS["vnet"], 1) is DETECTORS["vnet"]


def test_with_time_chunks_warns_below_the_forgetting_depth():
    """An overlap below 8 * memory_length warns, as the JAX package does, and
    keeps the unchunked kernel."""
    from metaviterbinet_tpu_torch.detectors import with_time_chunks
    with pytest.warns(UserWarning, match="trellis forgetting depth"):
        spec = with_time_chunks(DETECTORS["vnet"], 4, overlap=16, memory_length=4)
    assert spec is DETECTORS["vnet"]
