"""PyTorch port against the JAX package: config, modulation, trellis,
channel and metrics on the same inputs (CPU, small shapes).

Inputs come from numpy seeds; where the JAX function draws noise from a key,
the test draws the same numbers with jax.random and injects them into the
port."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaviterbinet_tpu import config as jconfig
from metaviterbinet_tpu.ops import channel as jchannel
from metaviterbinet_tpu.ops import metrics as jmetrics
from metaviterbinet_tpu.ops import modulation as jmod
from metaviterbinet_tpu.ops import trellis as jtrellis
from metaviterbinet_tpu_torch import config as tconfig
from metaviterbinet_tpu_torch import paths as tpaths
from metaviterbinet_tpu_torch.ops import channel as tchannel
from metaviterbinet_tpu_torch.ops import metrics as tmetrics
from metaviterbinet_tpu_torch.ops import modulation as tmod
from metaviterbinet_tpu_torch.ops import trellis as ttrellis


# ------------------------------------------------------------------ config

def test_config_fields_and_defaults_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(jconfig.Config)}
    tf = {f.name: f.default for f in dataclasses.fields(tconfig.Config)}
    assert tf == jf


@pytest.mark.parametrize("phase", ["train", "val"])
def test_config_derived_quantities_match_jax(phase):
    kw = dict(val_frames=3, val_SNR_start=7.0, val_SNR_end=12.0, n_symbols=4)
    j, t = jconfig.Config(**kw), tconfig.Config(**kw)
    assert t.n_states == j.n_states
    assert t.transmission_length(phase) == j.transmission_length(phase)
    assert t.n_words(phase) == j.n_words(phase)
    assert t.coefficients_for_phase(phase) == j.coefficients_for_phase(phase)
    np.testing.assert_array_equal(t.snr_range(phase), j.snr_range(phase))
    np.testing.assert_array_equal(t.data_indices(phase), j.data_indices(phase))


def test_config_yaml_layering():
    assert tconfig.load_config(tpaths.CONFIG_PATH) == tconfig.Config()
    cfg = tconfig.load_config(tpaths.CONFIG_PATH, val_SNR_start=7.0, use_ecc=False)
    assert (cfg.val_SNR_start, cfg.use_ecc, cfg.memory_length) == (7.0, False, 4)


@pytest.mark.parametrize("field,value", [("mesh_shape", (8,))])
def test_config_unported_mechanisms_raise(field, value):
    with pytest.raises(NotImplementedError, match=field):
        tconfig.Config(**{field: value})


@pytest.mark.parametrize("field,value", [("eval_time_chunks", 4), ("dtype", "bfloat16")])
def test_config_accepts_time_chunks_and_bf16(field, value):
    assert getattr(tconfig.Config(**{field: value}), field) == value


def test_config_rejects_unknown_dtypes_and_negative_chunks():
    with pytest.raises(ValueError, match="dtype"):
        tconfig.Config(dtype="float16")
    with pytest.raises(ValueError, match="eval_time_chunks"):
        tconfig.Config(eval_time_chunks=-1)


@pytest.mark.parametrize("field,value", [
    ("eval_mode", "by_word"), ("self_supervised", True), ("online_meta", True)])
def test_config_accepts_the_online_mechanisms(field, value):
    assert getattr(tconfig.Config(**{field: value}), field) == value


# ------------------------------------------------------------------ modulation + metrics

def test_bpsk_matches_jax():
    c = np.random.default_rng(0).integers(0, 2, size=(5, 17)).astype(np.float32)
    np.testing.assert_array_equal(tmod.bpsk_modulate(torch.tensor(c)).numpy(),
                                  np.asarray(jmod.bpsk_modulate(jnp.asarray(c))))


@pytest.mark.parametrize("flip_p", [0.0, 0.01, 0.3])
def test_error_rates_match_jax(flip_p):
    rng = np.random.default_rng(1)
    tgt = rng.integers(0, 2, size=(40, 120)).astype(np.float32)
    pred = np.where(rng.random(tgt.shape) < flip_p, 1 - tgt, tgt)
    jb, jf, jw = jmetrics.error_rates(jnp.asarray(pred), jnp.asarray(tgt))
    tb, tf, tw = tmetrics.error_rates(torch.tensor(pred), torch.tensor(tgt))
    assert abs(float(tb) - float(jb)) < 1e-7
    assert abs(float(tf) - float(jf)) < 1e-7
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


# ------------------------------------------------------------------ trellis

def test_transition_table_matches_jax():
    for n in (4, 16, 32):
        np.testing.assert_array_equal(ttrellis.transition_table(n), jtrellis.transition_table(n))


@pytest.mark.parametrize("S", [4, 16])
def test_acs_step_matches_jax(S):
    rng = np.random.default_rng(2)
    m, b = (rng.normal(size=(9, S)).astype(np.float32) for _ in range(2))
    np.testing.assert_array_equal(
        ttrellis.acs_step(torch.tensor(m), torch.tensor(b)).numpy(),
        np.asarray(jtrellis.acs_step(jnp.asarray(m), jnp.asarray(b))))


@pytest.mark.parametrize("S,T", [(4, 40), (16, 40), (16, 41), (32, 48)])
def test_viterbi_decode_matches_jax(S, T):
    priors = np.random.default_rng(3 + S + T).normal(size=(64, T, S)).astype(np.float32)
    np.testing.assert_array_equal(ttrellis.viterbi_decode(torch.tensor(priors)).numpy(),
                                  np.asarray(jtrellis.viterbi_decode(jnp.asarray(priors))))


def test_viterbi_decode_with_metrics_matches_jax():
    rng = np.random.default_rng(4)
    priors = rng.normal(size=(16, 24, 16)).astype(np.float32)
    m0 = rng.normal(size=(16, 16)).astype(np.float32)
    tb, tm = ttrellis.viterbi_decode_with_metrics(torch.tensor(priors), torch.tensor(m0))
    jb, jm = jtrellis.viterbi_decode_with_metrics(jnp.asarray(priors), jnp.asarray(m0))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_viterbi_readout_breaks_exact_ties_like_jax():
    """Tied minimum set {1, 2, 9, 10} after step 0: the emitted bit is state 1's LSB."""
    S = 16
    p0 = np.ones(S, np.float32)
    p0[[2, 4]] = 0.0
    priors = np.tile(np.stack([p0, np.ones(S, np.float32)])[None], (4, 1, 1))
    got = ttrellis.viterbi_decode(torch.tensor(priors)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jtrellis.viterbi_decode(jnp.asarray(priors))))
    assert got[0, 1] == 1.0
    zeros = np.zeros((4, 6, S), np.float32)  # every state tied: bit of state 0
    assert (ttrellis.viterbi_decode(torch.tensor(zeros)).numpy() == 0).all()


@pytest.mark.parametrize("L", [2, 4])
def test_calculate_states_matches_jax(L):
    words = np.random.default_rng(5).integers(0, 2, size=(6, 30)).astype(np.float32)
    got = ttrellis.calculate_states(L, torch.tensor(words))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jtrellis.calculate_states(L, jnp.asarray(words))))


# ------------------------------------------------------------------ channel

@pytest.mark.parametrize("coefs,fading,fading_type", [
    ("time_decay", False, 1), ("time_decay", True, 1), ("time_decay", True, 2),
    ("cost2100", False, 1), ("cost2100", True, 2)])
def test_channel_taps_match_jax(coefs, fading, fading_type):
    idx = np.array([0, 1, 7, 150, 299, 301, 450])
    want = np.asarray(jchannel.estimate_channel_batch(
        4, 0.2, jnp.asarray(idx), channel_coefficients=coefs, fading=fading,
        fading_taps_type=fading_type))
    got = tchannel.estimate_channel_batch(
        4, 0.2, torch.tensor(idx), channel_coefficients=coefs, fading=fading,
        fading_taps_type=fading_type)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_noisy_channel_estimate_with_injected_noise_matches_jax():
    idx = np.arange(12)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jchannel.estimate_channel_batch(
        4, 0.2, jnp.asarray(idx), noisy_est_var=0.1, fading=True, noise_key=key))
    keys = jax.random.split(key, len(idx))
    noise = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (3,)))(keys))
    got = tchannel.estimate_channel_batch(4, 0.2, torch.tensor(idx), noisy_est_var=0.1,
                                          fading=True, noise=torch.tensor(noise))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_noisy_channel_estimate_needs_a_source_of_noise():
    with pytest.raises(ValueError, match="noisy_est_var"):
        tchannel.estimate_channel_batch(4, 0.2, torch.arange(3), noisy_est_var=0.1)
    g = torch.Generator().manual_seed(0)
    h = tchannel.estimate_channel_batch(4, 0.2, torch.arange(3), noisy_est_var=0.1, generator=g)
    assert h.shape == (3, 4) and torch.isfinite(h).all()


@pytest.mark.parametrize("snr", [3.0, 10.0])
def test_isi_awgn_transmit_with_injected_noise_matches_jax(snr):
    rng = np.random.default_rng(6)
    W, T, L = 20, 32, 4
    s = 1 - 2 * rng.integers(0, 2, size=(W, T + L)).astype(np.float32)
    h = (np.exp(-0.2 * np.arange(L)) * (1 + 0.1 * rng.normal(size=(W, L)))).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jchannel.isi_awgn_transmit(jnp.asarray(s), jnp.asarray(h), snr, key, L))
    noise = np.asarray(jax.random.normal(key, (W, T)))
    got = tchannel.isi_awgn_transmit(torch.tensor(s), torch.tensor(h), snr, L,
                                     noise=torch.tensor(noise))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
