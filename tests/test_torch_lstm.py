"""The port's LSTM family (models/lstm.py, its specs and its transplant)
against the JAX package's models/lstm.py, on the CPU at small shapes.

Inputs come from numpy seeds, params from the JAX init through
`params_from_jax`. Tolerances: both forwards within rtol 1e-4, atol 1e-6 of
JAX's `score` with equal argmax, the contract JAX holds its own two scan
structures to (tests/test_models.py:36-44); measured up to 5e-8 apart.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaviterbinet_tpu.detectors import DETECTORS as JDETECTORS
from metaviterbinet_tpu.detectors import with_compute_dtype as j_with_compute_dtype
from metaviterbinet_tpu.models import lstm as jlstm
from metaviterbinet_tpu_torch.detectors import (
    DETECTORS, with_compute_dtype, with_time_chunks)
from metaviterbinet_tpu_torch.models import lstm as tlstm
from metaviterbinet_tpu_torch.weights import params_from_jax, params_to_numpy
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _params(seed=0):
    jp = jlstm.init_params(jax.random.PRNGKey(seed))
    return jp, params_from_jax({k: np.asarray(v) for k, v in jp.items()}, device="cpu")


def _y(B, T, seed):
    return np.random.default_rng(seed).normal(size=(B, T)).astype(np.float32)


@pytest.mark.parametrize("B,T", [(1, 1), (1, 5), (4, 48)])
def test_make_windows_bit_equal_to_jax(B, T):
    y = _y(B, T, 0)
    want = np.asarray(jlstm.make_windows(jnp.asarray(y)))
    got = tlstm.make_windows(torch.tensor(y)).numpy()
    assert got.shape == (B, T, tlstm.INPUT_SIZE)
    np.testing.assert_array_equal(got, want)
    assert np.all(got[:, 0, :3] == tlstm.START_VALUE_PADDING)


@pytest.mark.parametrize("forward", ["logits", "logits_unrolled"])
@pytest.mark.parametrize("B,T,seed", [(1, 48, 0), (4, 37, 1)])
def test_forwards_match_jax_score(forward, B, T, seed):
    jp, model = _params(seed)
    y = _y(B, T, seed + 10)
    want = np.asarray(jlstm.score(jp, jnp.asarray(y)))
    with torch.no_grad():
        got = getattr(tlstm, forward)(tlstm.param_dict(model), torch.tensor(y)).numpy()
    assert got.dtype == np.float32 and got.shape == (B, T, 2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_array_equal(tlstm.detect(tlstm.param_dict(model), torch.tensor(y)).numpy(),
                                  np.asarray(jlstm.detect(jp, jnp.asarray(y))))


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_forward_matches_jax(seed):
    """Config.dtype='bfloat16': the unrolled forward in bf16 against JAX
    score(..., compute_dtype=bfloat16), both rounding every op to bf16. The
    logits agree within one bf16 ulp at the largest |logit| (2**-12 and
    2**-11 here), on at most 5% of entries (measured: equal here, 1.2e-4
    apart on 2% of the entries of a 4 x 136 batch), and
    the detected bits agree; the batch detect of the bf16 spec is JAX's."""
    jp, model = _params(seed)
    y = _y(4, 48, seed + 20)
    want = np.asarray(jlstm.score(jp, jnp.asarray(y), compute_dtype=jnp.bfloat16))
    got = tlstm.logits_unrolled(tlstm.param_dict(model), torch.tensor(y), torch.bfloat16)
    assert got.dtype == torch.float32
    diff = np.abs(got.detach().numpy() - want)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert diff.max() <= ulp and np.mean(diff > 0) <= 0.05
    spec = with_compute_dtype(DETECTORS["lstm"], "bfloat16")
    jspec = j_with_compute_dtype(JDETECTORS["lstm"], "bfloat16")
    bits = spec.detect(model, torch.tensor(y), None)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jspec.detect(jp, jnp.asarray(y), None)))
    assert bits.dtype == torch.float32
    # and it is not the f32 forward
    assert not torch.equal(got, tlstm.logits(tlstm.param_dict(model), torch.tensor(y)))


def test_detect_ties_go_to_class_zero():
    _, model = _params()
    p = tlstm.param_dict(model)
    y = torch.tensor(_y(2, 9, 3))
    with torch.no_grad():
        p["w_fc"].zero_()
        p["b_fc"].zero_()
    assert torch.equal(tlstm.detect(p, y), torch.zeros_like(y))
    with torch.no_grad():
        p["b_fc"][1] = 1.0
    assert torch.equal(tlstm.detect(p, y), torch.ones_like(y))


def test_param_dict_is_the_modules_own_tensors():
    """JAX names and shapes, and an in-place update lands in the module
    (as the in-place Adam and the engine's restore need)."""
    jp, model = _params(2)
    p = tlstm.param_dict(model)
    assert list(p) == list(tlstm.PARAM_NAMES)
    assert {k: tuple(v.shape) for k, v in p.items()} == {k: v.shape for k, v in jp.items()}
    assert {id(t) for t in p.values()} == {id(t) for t in model.parameters()}
    y = torch.tensor(_y(1, 12, 4))
    before = model(y).detach()
    with torch.no_grad():
        p["w_hh0"].add_(0.05)
    assert not torch.equal(model(y).detach(), before)


def test_init_params_is_seeded_and_bounded():
    a = tlstm.init_params(torch.Generator().manual_seed(0), device="cpu")
    b = tlstm.init_params(torch.Generator().manual_seed(0), device="cpu")
    c = tlstm.init_params(torch.Generator().manual_seed(1), device="cpu")
    for k, v in tlstm.param_dict(a).items():
        assert torch.equal(v, tlstm.param_dict(b)[k]), k
        assert not torch.equal(v, tlstm.param_dict(c)[k]), k
        assert float(v.detach().abs().max()) <= (1.0 / tlstm.HIDDEN_SIZE) ** 0.5, k
        assert float(v.detach().std()) > 0.02, k  # U(-1/16, 1/16) has std 0.036


def test_transplant_round_trips_and_copies_stay_independent():
    jp, model = _params(3)
    assert isinstance(model, tlstm.WindowedLSTM)
    back = params_to_numpy(model)
    for k, v in jp.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
    twin = copy.deepcopy(model)
    with torch.no_grad():
        tlstm.param_dict(twin)["w_ih1"].add_(1.0)
    np.testing.assert_array_equal(params_to_numpy(model)["w_ih1"], np.asarray(jp["w_ih1"]))
    with pytest.raises(ValueError, match="w_fc"):
        tlstm.from_params(dict(back, w_fc=np.zeros((3, 256), np.float32)), device="cpu")


def test_lstm_specs_match_the_jax_registry():
    """The LSTM and META_LSTM specs carry JAX's flags; the time chunks leave
    them alone, as with_pallas_detect does; the MAML step's score is the
    unrolled forward in f32 and the bf16 one under bfloat16."""
    for name in ("lstm", "meta_lstm"):
        spec, jspec = DETECTORS[name], JDETECTORS[name]
        assert (spec.trainable, spec.label_kind, spec.subsample_loss, spec.meta) == \
            (jspec.trainable, jspec.label_kind, jspec.subsample_loss, jspec.meta)
        assert spec.model is tlstm and spec.score is tlstm.logits
        assert spec.meta_score is tlstm.logits_unrolled
        assert with_time_chunks(spec, 4) is spec and with_compute_dtype(spec, "float32") is spec
        bf16 = with_compute_dtype(spec, "bfloat16")
        assert bf16.meta_score is bf16.score and bf16.score.keywords == {
            "compute_dtype": torch.bfloat16}
    assert DETECTORS["vnet"].meta_score is DETECTORS["vnet"].score


def test_engine_detect_is_the_batch_detect_of_one_word():
    _, model = _params(4)
    y = torch.tensor(_y(3, 40, 5))
    spec = DETECTORS["meta_lstm"]
    batch = spec.detect(model, y, None)
    for i in range(3):
        assert torch.equal(spec.engine_detect(model, y[i:i + 1], None), batch[i:i + 1])
