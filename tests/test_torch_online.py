"""The port's by-word online engine against the JAX engine, on the tiny
config of tests/test_online.py (CPU, where the port's kernels run their
plain versions).

Both engines get the same blocks, CSI and params. The JAX engine draws from
its PRNG key; the port's `Draws` is replaced by one that replays exactly
those keys (select_batch indices, meta query draws, fresh params), as
tests/test_online.py replays them itself.

Tolerances: the VA engine is exact. For the ViterbiNet family the SER of
every block must be equal, and the final params within 1e-5: the port
computes the same f32 updates in another summation order (and the fused
self-supervised step keeps the running Adam powers of the TPU kernel), so
they agree to rounding over the few steps this config takes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaviterbinet_tpu import config as jconfig
from metaviterbinet_tpu.data.dataset import ChannelDataset as JChannelDataset
from metaviterbinet_tpu.detectors import DETECTORS as JDETECTORS
from metaviterbinet_tpu.detectors import with_compute_dtype as j_with_compute_dtype
from metaviterbinet_tpu.ecc.rs import rs_encode_bits as j_rs_encode_bits
from metaviterbinet_tpu.models import lstm as jlstm
from metaviterbinet_tpu.models import viterbinet as jvnet
from metaviterbinet_tpu.online.engine import make_online_engine
from metaviterbinet_tpu.ops.channel import estimate_channel_batch as j_taps
from metaviterbinet_tpu.train.losses import make_loss_fn as j_make_loss_fn
from metaviterbinet_tpu.train.losses import select_batch as j_select_batch
from metaviterbinet_tpu_torch import Config
from metaviterbinet_tpu_torch.detectors import DETECTORS, with_compute_dtype
from metaviterbinet_tpu_torch.evaluation.trainer import Trainer
from metaviterbinet_tpu_torch.online.engine import Draws, run_online, uses_fused_adaptation
from metaviterbinet_tpu_torch.weights import params_from_jax, params_to_numpy
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


PARAMS_ATOL = 1e-5

TINY = dict(val_block_length=24, train_block_length=24, n_symbols=1, val_frames=2,
            subframes_in_frame=5, train_frames=2, self_supervised_iterations=3,
            meta_train_iterations=2, meta_j_num=2, meta_subframes=3, buffer_capacity=16,
            train_minibatch_size=8)


def _inputs(kw, snr=10.0):
    cfg = jconfig.Config(**kw)
    tx, rx = JChannelDataset(cfg, "val").get(snr, cfg.gamma)
    h = j_taps(cfg.memory_length, cfg.gamma, jnp.arange(tx.shape[0]),
               fading=cfg.fading_in_decoder, fading_taps_type=cfg.fading_taps_type)
    return cfg, tx, rx, h


class JaxDraws(Draws):
    """The draws the JAX engine makes from `key` (online/engine.py:243-284
    there: per block, (key, k_init, k_meta) = split(key, 3) when meta runs,
    then (key, k_ss) = split(key) when self-supervision runs)."""

    def __init__(self, cfg, name, key, n_words, meta, self_sup):
        self.cfg, self.name = cfg, name
        self.k_init, self.k_meta, self.k_ss = {}, {}, {}
        for count in range(n_words):
            if meta:
                key, self.k_init[count], self.k_meta[count] = jax.random.split(key, 3)
            if self_sup:
                key, self.k_ss[count] = jax.random.split(key)

    def j_hats(self, count, iteration, high):
        k = jax.random.split(self.k_meta[count], self.cfg.meta_train_iterations)[iteration]
        return torch.tensor(np.asarray(jax.random.randint(k, (self.cfg.meta_j_num,), 0, high)))

    def select(self, count, step, n):
        k = jax.random.split(self.k_ss[count], self.cfg.self_supervised_iterations)[step]
        return torch.tensor(np.asarray(j_select_batch(k, n, self.cfg.train_minibatch_size)))

    def init_params(self, count):
        p = _jax_init(self.cfg, self.name)(self.k_init[count])
        return params_from_jax({k: np.asarray(v) for k, v in p.items()}, device="cpu")


def _jax_init(jcfg, name):
    """The JAX init of the detector's family: key -> params."""
    if "lstm" in name:
        return jlstm.init_params
    return lambda k: jvnet.init_params(k, jcfg.n_states)


def _run_both(name, snr=10.0, init_buffer=False, meta_init=False, **kw):
    kw = dict(TINY, **kw)
    jcfg, tx, rx, h = _inputs(kw, snr)
    jspec = j_with_compute_dtype(JDETECTORS[name], jcfg.dtype)
    spec = with_compute_dtype(DETECTORS[name], jcfg.dtype)
    loss_fn = init_fn = None
    params = None
    if jspec.trainable:
        loss_fn = j_make_loss_fn(jspec.score, jspec.label_kind, jcfg.memory_length,
                                 jspec.subsample_loss, jcfg.train_minibatch_size)
        init_fn = _jax_init(jcfg, name)
        params = init_fn(jax.random.PRNGKey(1))
    extra, t_extra = {}, {}
    if init_buffer:
        # train-channel words labelled with their re-encoded bits, as the
        # trainers pre-fill the buffer
        btx, brx = JChannelDataset(jcfg, "train").get(snr, jcfg.gamma)
        btx = j_rs_encode_bits(btx[:6], jcfg.n_symbols).astype(brx.dtype)
        extra = dict(init_buffer_rx=brx[:6], init_buffer_tx=btx)
        t_extra = dict(init_buffer_rx=torch.tensor(np.asarray(brx[:6])),
                       init_buffer_tx=torch.tensor(np.asarray(btx)))
    if meta_init:
        sentinel = _jax_init(jcfg, name)(jax.random.PRNGKey(9))
        extra["meta_init_params"] = sentinel
        t_extra["meta_init_params"] = params_from_jax(
            {k: np.asarray(v) for k, v in sentinel.items()}, device="cpu")
    key = jax.random.PRNGKey(2)
    want = make_online_engine(jcfg, jspec.detect, loss_fn, init_fn)(params, tx, rx, h, key, **extra)

    cfg = Config(**kw)
    tparams = None if params is None else params_from_jax(
        {k: np.asarray(v) for k, v in params.items()}, device="cpu")
    draws = JaxDraws(cfg, name, key, tx.shape[0], spec.trainable and cfg.online_meta,
                     spec.trainable and cfg.self_supervised)
    got = run_online(cfg, spec, tparams, torch.tensor(np.asarray(tx)),
                     torch.tensor(np.asarray(rx)), torch.tensor(np.asarray(h)), draws, **t_extra)
    return want, got, tparams


def _assert_params_close(want, got):
    got = params_to_numpy(got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], np.asarray(v), atol=PARAMS_ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("snr", [6.0, 10.0])
def test_va_joint_engine_matches_jax_exactly(snr):
    want, got, _ = _run_both("va", snr=snr, ser_thresh=0.05)
    np.testing.assert_array_equal(got.ser_by_word, np.asarray(want.ser_by_word))
    assert got.n_buffer == int(want.n_buffer)
    assert got.params is None


@pytest.mark.parametrize("ser_thresh", [0.02, 1.0])
def test_vnet_online_engine_matches_jax(ser_thresh):
    """Self-supervised vnet: autograd steps on the subsampled loss, with the
    JAX select_batch draws."""
    want, got, start = _run_both("vnet", snr=12.0, self_supervised=True, ser_thresh=ser_thresh)
    np.testing.assert_array_equal(got.ser_by_word, np.asarray(want.ser_by_word))
    assert got.n_buffer == int(want.n_buffer) > 0
    _assert_params_close(want.params, got.params)
    assert not np.array_equal(params_to_numpy(got.params)["w2"], params_to_numpy(start)["w2"])


@pytest.mark.parametrize("weights_init,init_buffer", [
    ("last_frame", False), ("last_frame", True), ("random", False), ("meta_training", False)])
def test_meta_vnet_meta_engine_matches_jax(weights_init, init_buffer):
    """Meta mode: MAML from the buffer every meta_subframes blocks (second
    order, the JAX query draws), then the fused self-supervised step."""
    want, got, _ = _run_both("meta_vnet", self_supervised=True, online_meta=True,
                             ser_thresh=1.0, weights_init=weights_init,
                             buffer_empty=not init_buffer, buffer_capacity=32,
                             init_buffer=init_buffer, meta_init=weights_init == "meta_training")
    np.testing.assert_array_equal(got.ser_by_word, np.asarray(want.ser_by_word))
    assert got.n_buffer == int(want.n_buffer)
    assert got.n_gated == 10
    _assert_params_close(want.params, got.params)


def test_meta_vnet_engine_under_bf16_matches_jax(monkeypatch):
    """Config.dtype='bfloat16': the engine detects through the bf16 forward
    and K5, and self-supervises by autograd steps over the bf16 score (not
    K6, whose loss is f32), as the JAX engine with with_compute_dtype does.
    SER per block equal; params within 5e-4, half of one Adam step (lr
    1e-3): bf16 keeps 3 significant digits, the two frameworks round some
    products apart, and Adam scales an update by the gradient's own history,
    so a rounding difference in a small gradient component moves its
    parameter by a fraction of lr."""
    import metaviterbinet_tpu_torch.online.engine as engine
    monkeypatch.setattr(engine, "online_adapt_viterbinet",
                        lambda *a, **k: pytest.fail("K6 ran under bf16"))
    want, got, _ = _run_both("meta_vnet", self_supervised=True, online_meta=True,
                             ser_thresh=1.0, dtype="bfloat16", buffer_capacity=32)
    np.testing.assert_array_equal(got.ser_by_word, np.asarray(want.ser_by_word))
    assert got.n_buffer == int(want.n_buffer) and got.n_gated == 10
    got_p = params_to_numpy(got.params)
    for k, v in want.params.items():
        np.testing.assert_allclose(got_p[k], np.asarray(v), atol=5e-4, rtol=0, err_msg=k)


@pytest.mark.parametrize("name,mode", [
    ("lstm", dict(ser_thresh=0.3)),
    ("lstm", dict(self_supervised=True, ser_thresh=0.3)),
    ("meta_lstm", dict(self_supervised=True, online_meta=True, ser_thresh=1.0,
                       buffer_capacity=32))])
def test_lstm_engine_matches_jax(name, mode):
    """The LSTM family: detection through the fused forward, the online
    mode's autograd steps on the subsampled bit loss with the JAX draws,
    and the meta mode's second-order MAML through the unrolled forward and
    its full-word self-supervised steps. K6 never runs (bit labels)."""
    want, got, start = _run_both(name, **mode)
    np.testing.assert_array_equal(got.ser_by_word, np.asarray(want.ser_by_word))
    assert got.n_buffer == int(want.n_buffer) > 0
    _assert_params_close(want.params, got.params)
    moved = not np.array_equal(params_to_numpy(got.params)["w_hh1"],
                               params_to_numpy(start)["w_hh1"])
    assert moved == bool(mode.get("self_supervised"))


def test_first_order_meta_without_self_supervision_matches_jax():
    want, got, _ = _run_both("meta_vnet", online_meta=True, MAML=False, ser_thresh=1.0)
    np.testing.assert_array_equal(got.ser_by_word, np.asarray(want.ser_by_word))
    _assert_params_close(want.params, got.params)


def test_buffer_saturation_drops_oldest():
    want, got, _ = _run_both("va", buffer_capacity=4, ser_thresh=1.0)
    assert got.n_buffer == int(want.n_buffer) == 4
    np.testing.assert_array_equal(got.ser_by_word, np.asarray(want.ser_by_word))


def test_oversized_init_buffer_raises():
    cfg = Config(**dict(TINY, buffer_capacity=4, buffer_empty=False))
    rx = torch.zeros((10, 32))
    with pytest.raises(ValueError, match="buffer_capacity"):
        run_online(cfg, DETECTORS["va"], None, torch.zeros((10, 24)), rx, torch.zeros((10, 4)),
                   None, init_buffer_rx=rx, init_buffer_tx=rx)


def test_fused_step_only_for_the_meta_loss_under_adam():
    cfg = Config()
    assert uses_fused_adaptation(cfg, DETECTORS["meta_vnet"])
    assert not uses_fused_adaptation(cfg, DETECTORS["vnet"])       # subsampled loss
    assert not uses_fused_adaptation(cfg, DETECTORS["va"])
    for kw in (dict(optimizer_type="RMSprop"), dict(loss_type="MSE"), dict(clip_grad_norm=1.0),
               dict(dtype="bfloat16")):
        assert not uses_fused_adaptation(cfg.replace(**kw), DETECTORS["meta_vnet"])


def test_by_word_eval_needs_ecc(tmp_path):
    cfg = Config(**dict(TINY, eval_mode="by_word", use_ecc=False))
    with pytest.raises(ValueError, match="ECC"):
        Trainer(cfg, "va", device="cpu", weights_dir=str(tmp_path), verbose=False).evaluate()


@pytest.mark.parametrize("name,mode", [
    ("va", {}), ("vnet", {}), ("vnet", dict(self_supervised=True)),
    ("meta_vnet", dict(self_supervised=True, online_meta=True)),
    ("lstm", {}), ("lstm", dict(self_supervised=True)),
    ("meta_lstm", dict(self_supervised=True, online_meta=True))])
def test_by_word_evaluate_trains_on_miss_then_adapts(tmp_path, name, mode):
    """Trainer.evaluate() in by-word mode: train-on-miss writes the val
    SNR's checkpoint, then the engine runs every block."""
    cfg = Config(**dict(TINY, eval_mode="by_word", train_minibatch_num=2, **mode))
    t = Trainer(cfg, name, device="cpu", weights_dir=str(tmp_path), verbose=False)
    sers = t.evaluate()
    assert sers.shape == (10,) and np.all((sers >= 0) & (sers <= 1))
    assert np.all(sers[::5] == 0)  # pilots
    trained = (tmp_path / "snr_10.0_gamma_0.2.pt").is_file()
    assert trained == (name != "va")
    assert t.online_result.n_buffer >= 2
