"""The port's main path, the aggregated coded-BER eval, against the JAX
package on one protocol batch, plus the port's own statistical anchor, its
device policy and its import hygiene (no JAX, nothing of the JAX package)."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metaviterbinet_tpu.data import dataset as jdataset
from metaviterbinet_tpu.detectors import DETECTORS as JDETECTORS
from metaviterbinet_tpu.ecc.rs import rs_decode_bits_host
from metaviterbinet_tpu.models import lstm as jlstm
from metaviterbinet_tpu.models import viterbinet as jvnet
from metaviterbinet_tpu.ops.channel import estimate_channel_batch as j_taps
from metaviterbinet_tpu.ops.metrics import error_rates as j_error_rates
from metaviterbinet_tpu_torch import Config, bench
from metaviterbinet_tpu_torch.data import dataset as tdataset
from metaviterbinet_tpu_torch.evaluation.trainer import Trainer
from metaviterbinet_tpu_torch.models import lstm as tlstm
from metaviterbinet_tpu_torch.models import viterbinet as tvnet
from metaviterbinet_tpu_torch.parallel.mesh import init_distributed, make_mesh
from metaviterbinet_tpu_torch.paths import RESOURCES_DIR, ROOT_DIR
from metaviterbinet_tpu_torch.weights import adam_state_from_jax, params_from_jax
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


PROTOCOL = dict(n_words=300, block_length=120, memory_length=4, use_ecc=True, n_symbols=2,
                channel_coefficients="time_decay", fading=True, fading_taps_type=1)


def _jax_draws(word_key, noise_key, n_words, block_length, T, L, noisy_est_var):
    """The draws JAX generate_words makes from its keys (data/dataset.py:53,
    :61, ops/channel.py:103, :130), for injection into the port."""
    bits = np.asarray(jax.random.randint(word_key, (n_words, block_length), 0, 2), np.float32)
    est_key, tx_key = jax.random.split(noise_key)
    tx_noise = np.asarray(jax.random.normal(tx_key, (n_words, T)))
    est_noise = None
    if noisy_est_var > 0:
        keys = jax.random.split(est_key, n_words)
        est_noise = torch.tensor(np.asarray(jax.vmap(lambda k: jax.random.normal(k, (L - 1,)))(keys)))
    return torch.tensor(bits), torch.tensor(tx_noise), est_noise


@pytest.mark.parametrize("coefs,noisy_est_var,snr", [
    ("time_decay", 0.0, 10.0), ("time_decay", 0.1, 7.0), ("cost2100", 0.0, 12.0)])
def test_generate_words_with_injected_draws_matches_jax(coefs, noisy_est_var, snr):
    kw = dict(PROTOCOL, n_words=50, channel_coefficients=coefs)
    wk, nk = jax.random.PRNGKey(1), jax.random.PRNGKey(2)
    jb, jy = jdataset.generate_words(wk, nk, snr, 0.2, noisy_est_var=noisy_est_var, **kw)
    bits, tx_noise, est_noise = _jax_draws(wk, nk, 50, 120, 136, 4, noisy_est_var)
    tb, ty = tdataset.generate_words(snr, 0.2, noisy_est_var=noisy_est_var, device="cpu",
                                     bits=bits, tx_noise=tx_noise, est_noise=est_noise, **kw)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert ty.shape == jy.shape == (50, 136)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=0)


def test_channel_dataset_advances_its_streams_in_order():
    cfg = Config(val_frames=2)
    ds = tdataset.ChannelDataset(cfg, "val", device="cpu")
    tx1, rx1 = ds.get(10.0, cfg.gamma)
    tx2, rx2 = ds.get(10.0, cfg.gamma)
    assert tx1.shape == (50, 120) and rx1.shape == (50, 136)
    assert not torch.equal(tx1, tx2) and not torch.equal(rx1, rx2)
    again = tdataset.ChannelDataset(cfg, "val", device="cpu").get(10.0, cfg.gamma)
    assert torch.equal(again[0], tx1) and torch.equal(again[1], rx1)


@pytest.fixture(scope="module")
def protocol_batch():
    """One 300-word protocol batch (val_frames=12, T=136) from the JAX
    package, with the decoder's full-CSI taps."""
    b, y = jdataset.generate_words(jax.random.PRNGKey(21), jax.random.PRNGKey(22), 10.0, 0.2,
                                   **PROTOCOL)
    h = j_taps(4, 0.2, jnp.arange(300), fading=True, fading_taps_type=1)
    return np.asarray(b), np.asarray(y), np.asarray(h)


def _jax_eval_tail(bits, tx, di):
    decoded, _ = rs_decode_bits_host(np.asarray(bits), 2)
    return float(j_error_rates(jnp.asarray(decoded)[di], jnp.asarray(tx)[di])[0])


def test_decoder_csi_matches_jax(protocol_batch):
    t = Trainer(Config(val_frames=12), "va", device="cpu", verbose=False)
    np.testing.assert_allclose(t.decoder_csi(300).numpy(), protocol_batch[2], atol=1e-5, rtol=0)


def test_noisy_decoder_csi_draws_from_the_trainer_generator():
    cfg = Config(val_frames=1, noisy_est_var=0.1)
    t = Trainer(cfg, "va", device="cpu", verbose=False)
    a, b = t.decoder_csi(25), t.decoder_csi(25)
    assert not torch.equal(a, b)
    assert torch.equal(a, Trainer(cfg, "va", device="cpu", verbose=False).decoder_csi(25))
    key = jax.random.PRNGKey(4)
    noise = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (3,)))(jax.random.split(key, 25)))
    want = j_taps(4, 0.2, jnp.arange(25), noisy_est_var=0.1, fading=True, noise_key=key)
    np.testing.assert_allclose(t.decoder_csi(25, noise=torch.tensor(noise)).numpy(),
                               np.asarray(want), atol=1e-5, rtol=0)


def test_trainer_init_params_is_seeded():
    cfg = Config(val_frames=1)
    a = Trainer(cfg, "vnet", device="cpu", verbose=False).init_params()
    b = Trainer(cfg, "vnet", device="cpu", verbose=False).init_params()
    assert a.n_states == 16
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))


def test_slice_va_coded_ber_matches_jax(protocol_batch):
    tx, rx, h = protocol_batch
    cfg = Config(val_frames=12)
    di = cfg.data_indices("val")
    want = _jax_eval_tail(JDETECTORS["va"].detect(None, jnp.asarray(rx), jnp.asarray(h)), tx, di)
    t = Trainer(cfg, "va", device="cpu", verbose=False)
    got = float(t.eval_tail(None, torch.tensor(tx), torch.tensor(rx), torch.tensor(h)))
    assert 0.0 < want < 0.05
    assert abs(got - want) <= 1e-4, (got, want)


def test_slice_vnet_coded_ber_matches_jax(protocol_batch):
    tx, rx, h = protocol_batch
    cfg = Config(val_frames=12)
    params = jvnet.init_params(jax.random.PRNGKey(3), 16)
    want = _jax_eval_tail(JDETECTORS["vnet"].detect(params, jnp.asarray(rx), None), tx,
                          cfg.data_indices("val"))
    model = params_from_jax({k: np.asarray(v) for k, v in params.items()}, device="cpu")
    t = Trainer(cfg, "vnet", device="cpu", params=model, verbose=False)
    got = float(t.eval_tail(model, torch.tensor(tx), torch.tensor(rx), torch.tensor(h)))
    assert abs(got - want) <= 2e-3, (got, want)


def test_slice_lstm_coded_ber_matches_jax(protocol_batch):
    """The LSTM's aggregated eval tail on the first frame of the protocol
    batch (25 words x 136 symbols): JAX's detect -> RS decode -> coded BER
    against the port's, from the same params. The two forwards are 5e-8
    apart, so the detections and the BER are equal."""
    tx, rx, h = (a[:25] for a in protocol_batch)
    cfg = Config(val_frames=1)
    params = jlstm.init_params(jax.random.PRNGKey(3))
    want_bits = np.asarray(JDETECTORS["lstm"].detect(params, jnp.asarray(rx), None))
    want = _jax_eval_tail(want_bits, tx, cfg.data_indices("val"))
    model = params_from_jax({k: np.asarray(v) for k, v in params.items()}, device="cpu")
    t = Trainer(cfg, "lstm", device="cpu", params=model, verbose=False)
    np.testing.assert_array_equal(t.spec.detect(model, torch.tensor(rx), None).numpy(), want_bits)
    got = float(t.eval_tail(model, torch.tensor(tx), torch.tensor(rx), torch.tensor(h)))
    assert got == want, (got, want)


def test_va_coded_ber_in_reference_band():
    """The port alone, with its own generators: VA coded BER at 10 dB within
    0.006 of the recorded reference (as tests/test_parity_anchor.py)."""
    with open(os.path.join(RESOURCES_DIR, "reference_baselines.json")) as f:
        ref = json.load(f)["va_full_csi"]["coded_nsym2"]["points"]["10.0"]
    cfg = Config(val_frames=10)
    ours = Trainer(cfg, "va", device="cpu", verbose=False).single_eval_at_point(None, 10.0, cfg.gamma)
    assert abs(ours - ref) < 0.006, (ours, ref)


def test_evaluate_aggregated_sweep_on_cpu():
    cfg = Config(val_frames=2, val_SNR_start=8.0, val_SNR_end=10.0)
    sers = Trainer(cfg, "va", device="cpu", verbose=False).evaluate()
    assert sers.shape == (3,) and np.all((sers >= 0) & (sers <= 1))


def test_trainable_detector_needs_params_from_its_caller(tmp_path):
    """A trainable detector evaluates the params its caller passes; without
    them, its checkpoint, trained on a miss."""
    cfg = Config(val_frames=1, train_frames=1, train_minibatch_num=1, train_block_length=24,
                 train_minibatch_size=8)
    t = Trainer(cfg, "vnet", device="cpu", weights_dir=str(tmp_path), verbose=False)
    sers = t.evaluate()
    assert sers.shape == (1,) and (tmp_path / "snr_10.0_gamma_0.2.pt").is_file()
    model = tvnet.init_params(16, torch.Generator().manual_seed(0), device="cpu")
    fixed = Trainer(cfg, "vnet", device="cpu", params=model, weights_dir=str(tmp_path / "x"),
                    verbose=False)
    fixed.evaluate()
    assert fixed.params is model and not (tmp_path / "x").exists()
    with pytest.raises(ValueError, match="unknown detector 'multistream_lstm'"):
        Trainer(cfg, "multistream_lstm", device="cpu")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    cfg = Config(val_frames=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg, "va")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdataset.ChannelDataset(cfg, "val")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdataset.generate_words(10.0, 0.2, **dict(PROTOCOL, n_words=2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tvnet.ViterbiNet(16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tvnet.init_params(16, torch.Generator())
    np_params = {k: np.asarray(v) for k, v in jvnet.init_params(jax.random.PRNGKey(0), 16).items()}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax(np_params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tvnet.from_params(np_params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        adam_state_from_jax(np_params, np_params, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg.replace(eval_mode="by_word"), "meta_vnet")
    # the LSTM family
    for name in ("lstm", "meta_lstm"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Trainer(cfg, name)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlstm.WindowedLSTM()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlstm.init_params(torch.Generator())
    lstm_params = {k: np.asarray(v) for k, v in jlstm.init_params(jax.random.PRNGKey(0)).items()}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax(lstm_params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlstm.from_params(lstm_params)
    # the parallel layer and the bench
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_distributed()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg.replace(mesh_shape=(1,)), "va")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(device="cuda")


def test_graphs_and_tracer_import_no_kernel_and_no_model():
    """The graph layer (online/graphs.py) and the tracer (utils/profiling.py)
    reach the CUDA code through the kernels' loader (kernels/native.py)
    only: in a fresh process, importing both loads no other kernel module
    (not kernels/acs.py) and no module of models/."""
    code = ("import sys\n"
            "import metaviterbinet_tpu_torch.utils.profiling\n"
            "import metaviterbinet_tpu_torch.online.graphs\n"
            "print(' '.join(m for m in sys.modules if m.startswith('metaviterbinet_tpu_torch')))\n")
    env = dict(os.environ, PYTHONPATH=ROOT_DIR, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT_DIR, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    loaded = proc.stdout.split()
    kernels = [m for m in loaded if m.startswith("metaviterbinet_tpu_torch.kernels.")]
    assert kernels == ["metaviterbinet_tpu_torch.kernels.native"], loaded
    assert not [m for m in loaded if m.startswith("metaviterbinet_tpu_torch.models")], loaded


def test_port_imports_nothing_of_jax(tmp_path):
    """In a process where jax, flax, optax, yaml, msgpack, matplotlib and the
    JAX package cannot be imported (the port depends on none of them):
    every module of the port and chip_smoke.py import, and the readers run: load_config on the port's config.yaml, on
    a provenance the port writes and on the JAX package's (a mesh_shape
    reads as a tuple), and load_checkpoint on the JAX package's ViterbiNet
    and LSTM checkpoints; the parallel layer runs on a world-1 gloo group
    (the words-sharded detect, the sequence-parallel and chunked decodes,
    the data-parallel step), and so does the bench at a tiny size."""
    from metaviterbinet_tpu import config as jconfig
    from metaviterbinet_tpu.train import checkpoint as jcheckpoint
    from metaviterbinet_tpu_torch.train.checkpoint import save_config_provenance

    port_yaml = save_config_provenance(str(tmp_path / "port"), Config(eval_mode="by_word"))
    jax_yaml = jcheckpoint.save_config_provenance(str(tmp_path / "jax"),
                                                  jconfig.Config(lr=1e-5, val_frames=3))
    mesh_yaml = jcheckpoint.save_config_provenance(str(tmp_path / "mesh"),
                                                   jconfig.Config(mesh_shape=(2,)))
    for name, params in (("vnet", jvnet.init_params(jax.random.PRNGKey(0), 16)),
                         ("lstm", jlstm.init_params(jax.random.PRNGKey(0)))):
        jcheckpoint.save_params(str(tmp_path / name), 10.0, 0.2, params, 0.5)
    code = (
        "import importlib, pkgutil, sys\n"
        "for name in ('jax', 'flax', 'optax', 'yaml', 'msgpack', 'matplotlib',\n"
        "             'metaviterbinet_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import metaviterbinet_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "from metaviterbinet_tpu_torch import Config, load_config\n"
        "from metaviterbinet_tpu_torch.paths import CONFIG_PATH\n"
        "from metaviterbinet_tpu_torch.train.checkpoint import load_checkpoint\n"
        "root = sys.argv[1]\n"
        "assert load_config(CONFIG_PATH) == Config()\n"
        "assert load_config(root + '/port/config.yaml') == Config(eval_mode='by_word')\n"
        "assert load_config(root + '/jax/config.yaml') == Config(lr=1e-5, val_frames=3)\n"
        "assert load_config(root + '/mesh/config.yaml') == Config(mesh_shape=(2,))\n"
        "for name, key in (('vnet', 'w2'), ('lstm', 'w_hh1')):\n"
        "    ckpt = load_checkpoint(f'{root}/{name}', 10.0, 0.2, 'cpu')\n"
        "    assert key in ckpt['params'] and ckpt['loss'] == 0.5, ckpt\n"
        "import torch\n"
        "from metaviterbinet_tpu_torch import bench\n"
        "from metaviterbinet_tpu_torch.detectors import DETECTORS\n"
        "from metaviterbinet_tpu_torch.models import viterbinet\n"
        "from metaviterbinet_tpu_torch.ops.trellis import viterbi_decode, viterbi_decode_lowlat\n"
        "from metaviterbinet_tpu_torch.parallel import (\n"
        "    make_dp_train_step, make_mesh, sequence_parallel_decode, shard_words_decode)\n"
        "from metaviterbinet_tpu_torch.parallel.decode import chunked_decode_reference\n"
        "from metaviterbinet_tpu_torch.train.losses import make_loss_fn\n"
        "from metaviterbinet_tpu_torch.train.optim import Optimizer\n"
        "g = torch.Generator().manual_seed(0)\n"
        "y, h = torch.randn(3, 40, generator=g), torch.rand(3, 4, generator=g)\n"
        "run = shard_words_decode(make_mesh(device='cpu'), DETECTORS['va'].detect)\n"
        "assert torch.equal(run(None, y, h), DETECTORS['va'].detect(None, y, h))\n"
        "p = torch.randn(2, 128, 16, generator=g) ** 2\n"
        "seq = viterbi_decode(p)\n"
        "sp = sequence_parallel_decode(make_mesh((1, 1), device='cpu'), 32)\n"
        "assert torch.equal(sp(p), seq)\n"
        "assert chunked_decode_reference(p, 2, 32).shape == seq.shape\n"
        "assert (viterbi_decode_lowlat(p) == seq).float().mean() > 0.99\n"
        "params = viterbinet.param_dict(viterbinet.init_params(16, g, device='cpu'))\n"
        "opt = Optimizer('SGD', 0.1)\n"
        "step = make_dp_train_step(make_mesh(device='cpu'),\n"
        "                          make_loss_fn(viterbinet.logits, 'states', 4, False), opt)\n"
        "tx = torch.randint(0, 2, (2, 40), generator=g).float()\n"
        "assert torch.isfinite(step(params, opt.init(params), y[:2], tx)[2])\n"
        "line = bench.main(device='cpu', words=8, repeats=1, iters=1, ref_words=8,\n"
        "                  val_frames=1, e2e_repeats=1)\n"
        "assert line['value'] > 0, line\n"
        "print(len(names))\n")
    # one torch thread, as the parallel workers run: the xdist workers
    # share the same cores
    env = dict(os.environ, PYTHONPATH=ROOT_DIR, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT_DIR, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    # 37 modules before the experiment harness (plotters/: 5; train/msgpack.py),
    # 43 before the parallel layer (parallel/: 4) and the bench
    assert int(proc.stdout.split()[-1]) >= 48
