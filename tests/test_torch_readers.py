"""The port's readers that need no `yaml`, `flax` or `msgpack` (the port
depends on none of them), against those libraries on the CPU: the flat
YAML reader of config files (`config.parse_flat_yaml`, `load_config`, `--config`) and
the msgpack decoder of the JAX package's checkpoints (`train/msgpack.py`,
`train/checkpoint.load_checkpoint`, `Trainer.load_weights`)."""
import argparse
import dataclasses
import json
import math

import flax.serialization
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import optax
import pytest
import torch
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from metaviterbinet_tpu import cli as jcli
from metaviterbinet_tpu import config as jconfig
from metaviterbinet_tpu.data import dataset as jdataset
from metaviterbinet_tpu.detectors import DETECTORS as JDETECTORS
from metaviterbinet_tpu.ecc.rs import rs_decode_bits_host
from metaviterbinet_tpu.evaluation.trainer import Trainer as JTrainer
from metaviterbinet_tpu.models import lstm as jlstm
from metaviterbinet_tpu.models import viterbinet as jvnet
from metaviterbinet_tpu.ops.channel import estimate_channel_batch as j_taps
from metaviterbinet_tpu.ops.metrics import error_rates as j_error_rates
from metaviterbinet_tpu.train import checkpoint as jcheckpoint
from metaviterbinet_tpu.train.optim import make_optimizer
from metaviterbinet_tpu_torch import Config, cli, load_config
from metaviterbinet_tpu_torch.config import parse_flat_yaml
from metaviterbinet_tpu_torch.evaluation.trainer import Trainer
from metaviterbinet_tpu_torch.paths import CONFIG_PATH
from metaviterbinet_tpu_torch.train import msgpack as tmsgpack
from metaviterbinet_tpu_torch.train.checkpoint import load_checkpoint, save_config_provenance
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

FIELDS = {f.name for f in dataclasses.fields(Config)}
# a Config away from its defaults in every kind of field the files hold
CHANGED = dict(run_name="it's a \"run\" # not a comment", lr=1e-5, ser_thresh=0.025,
               eval_mode="by_word", val_SNR_start=7.0, use_ecc=False, noise_seed=-3,
               use_pallas=True, weights_dir="/some dir/w: x", dtype="bfloat16")


def _yaml(path) -> dict:
    """yaml.safe_load of a config file, filtered to the Config's fields, its
    sequences as tuples (the reader's form)."""
    with open(path) as f:
        loaded = yaml.safe_load(f)
    return {k: tuple(v) if isinstance(v, list) else v for k, v in loaded.items() if k in FIELDS}


def _read(path) -> dict:
    with open(path) as f:
        return {k: v for k, v in parse_flat_yaml(f.read(), str(path)).items() if k in FIELDS}


def _same(a: dict, b: dict) -> None:
    """Equal values of equal types (1 and 1.0 and True are not the same)."""
    assert a == b
    assert {k: type(v) for k, v in a.items()} == {k: type(v) for k, v in b.items()}


# ------------------------------------------------------- config files

def _config_files(tmp_path) -> dict:
    """The three kinds of file: the port's config.yaml, a provenance the
    port writes and one the JAX package writes (yaml.safe_dump)."""
    port = save_config_provenance(str(tmp_path / "port"), Config(**CHANGED))
    jax_file = jcheckpoint.save_config_provenance(str(tmp_path / "jax"),
                                                  jconfig.Config(**CHANGED))
    return {"config.yaml": CONFIG_PATH, "port provenance": port, "jax provenance": jax_file}


@pytest.mark.parametrize("kind", ["config.yaml", "port provenance", "jax provenance"])
def test_flat_reader_equals_yaml_safe_load(kind, tmp_path):
    path = _config_files(tmp_path)[kind]
    got = _read(path)
    _same(got, _yaml(path))
    if kind == "config.yaml":
        assert load_config(path) == Config()
    else:
        assert got == dataclasses.asdict(Config(**CHANGED))
        assert load_config(path) == Config(**CHANGED)


def test_flat_reader_reads_yaml_11_scalars_as_pyyaml_does(tmp_path):
    """PyYAML's YAML 1.1 rules where they surprise: 1e-3 (no dot) is a string
    and 1.0e-3 a float, yes/on are booleans, ~ is null, _ in numbers.
    So the port's provenance writes lr=1e-5 as 1.0e-05, not JSON's 1e-05."""
    text = ("a: 1e-3\nb: 1.0e-3\nc: yes\nd: On\ne: -1_000\nf: 1_0.5\ng: ~\nh: .inf\ni: -.5e+2\n"
            "j: '1e-3'\nk: [2, 4]\nl: []\nm: x#y  # comment\nn:\n")
    path = tmp_path / "scalars.yaml"
    path.write_text(text)
    with open(path) as f:
        want = {k: tuple(v) if isinstance(v, list) else v for k, v in yaml.safe_load(f).items()}
    got = parse_flat_yaml(text)
    _same(got, want)
    assert got["a"] == "1e-3" and got["b"] == 0.001 and got["n"] is None
    assert parse_flat_yaml("lr: 1e-05") == {"lr": "1e-05"}
    save_config_provenance(str(tmp_path / "w"), Config(lr=1e-5))
    assert "lr: 1.0e-05\n" in (tmp_path / "w" / "config.yaml").read_text()


def test_jax_provenance_with_a_mesh_reads_as_a_tuple_and_raises(tmp_path):
    """The JAX package writes a set mesh_shape as a block sequence; the reader
    returns the tuple, and the port's Config takes it (the mesh is built by
    the Trainer, which raises where the world cannot form it)."""
    path = jcheckpoint.save_config_provenance(str(tmp_path), jconfig.Config(mesh_shape=(2,)))
    assert "mesh_shape:\n- 2\n" in open(path).read()
    got = _read(path)
    _same(got, _yaml(path))
    assert got["mesh_shape"] == (2,)
    assert load_config(path) == Config(mesh_shape=(2,))


@pytest.mark.parametrize("text,line", [
    ("a: 1\nb:\n  c: 1\n", 3),          # nested map
    ("a: &x 1\nb: *x\n", 1),            # anchor, alias
    ("a: {b: 1}\n", 1),                 # flow map
    ("a: !!str 1\n", 1),                # tag
    ("a: |\n  text\n", 1),              # block scalar
    ("- 1\n", 1),                       # a sequence outside a key
    ("a: 1\n---\nb: 2\n", 2),           # several documents
    ("a: 2020-01-01\n", 1),             # timestamp
    ("a: [[1]]\n", 1),                  # nested flow sequence
    ("a: 0x1F\n", 1),                   # hex, octal and binary ints
    ("a: 017\n", 1),
    ("a: -0b10\n", 1),
    ("a: 1:30\n", 1),                   # sexagesimal
    ("a: 'x' y\n", 1),                  # text after a quoted value
])
def test_flat_reader_rejects_what_it_does_not_read(text, line):
    with pytest.raises(ValueError, match=f"^f.yaml:{line}: "):
        parse_flat_yaml(text, "f.yaml")


def test_cli_config_builds_the_jax_clis_config(tmp_path, capsys):
    """--config with --set and --snr: the port's _build_config gives the JAX
    CLI's Config, on the JAX package's provenance; `evaluate --config` runs
    the eval the file describes."""
    path = jcheckpoint.save_config_provenance(str(tmp_path), jconfig.Config(
        eval_mode="by_word", val_frames=1, subframes_in_frame=5, val_block_length=24,
        n_symbols=1, weights_dir=str(tmp_path / "w")))
    args = argparse.Namespace(config=path, set=["lr=0.01", "val_frames=2"], snr=8.0,
                              eval_mode=None, weights_dir=None)
    assert dataclasses.asdict(cli._build_config(args)) == \
        dataclasses.asdict(jcli._build_config(args))
    assert cli.main(["evaluate", "--detector", "va", "--device", "cpu", "--config", path]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (out["eval_mode"], out["n_points"]) == ("by_word", 5)
    cfg = load_config(path)
    assert out["mean_ser"] == float(Trainer(cfg, "va", device="cpu", verbose=False)
                                    .evaluate().mean())


# ------------------------------------------------------- msgpack

SCALARS = (st.none() | st.booleans() | st.integers(-2 ** 63, 2 ** 64 - 1)
           | st.floats(allow_nan=False) | st.text(max_size=40) | st.binary(max_size=40))
TREES = st.recursive(SCALARS, lambda kids: st.lists(kids, max_size=6)
                     | st.dictionaries(st.text(max_size=10), kids, max_size=6), max_leaves=30)


@settings(max_examples=300, deadline=None)
@given(TREES, st.booleans())
def test_msgpack_decoder_equals_msgpack(tree, single_float):
    packed = msgpack.packb(tree, use_bin_type=True, use_single_float=single_float)
    assert tmsgpack.unpackb(packed) == msgpack.unpackb(packed, raw=False)


@pytest.mark.parametrize("n", [15, 16, 31, 32, 255, 256, 65535, 65536])
def test_msgpack_decoder_reads_every_length_form(n):
    """fix, 8-, 16- and 32-bit lengths of str, bin, array and map."""
    tree = {"s": "é" * n, "b": bytes(range(256)) * (n // 256) + bytes(n % 256),
            "a": list(range(-n // 2, n - n // 2)), "m": {str(i): i for i in range(n)}}
    packed = msgpack.packb(tree, use_bin_type=True)
    assert tmsgpack.unpackb(packed) == msgpack.unpackb(packed, raw=False)


def test_msgpack_decoder_reads_flax_ext_types():
    """flax's ndarray (every dtype a checkpoint may hold), numpy scalar and
    complex ext types, as flax's msgpack_restore reads them."""
    tree = {"f32": np.arange(6, dtype=np.float32).reshape(2, 3) / 7, "i32": np.int32(-7),
            "u8": np.arange(3, dtype=np.uint8), "f64": np.float64(math.pi), "bool": np.bool_(True),
            "c": 1.5 - 2j, "c64": np.complex64(1 + 1j), "empty": np.zeros((0, 4), np.float16),
            "jax": jnp.ones((17, 3), jnp.int32), "nested": {"x": [np.ones(2), 3, "t"]}}
    packed = flax.serialization.msgpack_serialize(tree)
    got, want = tmsgpack.unpackb(packed), flax.serialization.msgpack_restore(packed)
    assert set(got) == set(want)
    for k in want:
        if k == "nested":
            np.testing.assert_array_equal(got[k]["x"][0], want[k]["x"][0])
            assert got[k]["x"][1:] == want[k]["x"][1:]
            continue
        assert type(got[k]) is type(want[k]), k
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("data,match", [
    (bytes([0xC1]), "type byte 0xc1"),
    (msgpack.packb(msgpack.ExtType(9, b"xy")), "ext code 9"),
    (bytes([0x92, 0x01]), "truncated"),
    (bytes([0x01, 0x02]), "after the object"),
])
def test_msgpack_decoder_raises_on_what_it_does_not_know(data, match):
    with pytest.raises(ValueError, match=match):
        tmsgpack.unpackb(data)


# ------------------------------------------------------- JAX checkpoints

def _jax_checkpoint(weights_dir, params, snr=10.0, steps=2):
    """The JAX package's save_params of `params` after `steps` Adam steps on
    a made-up gradient, with the Adam state; returns what was written."""
    opt = make_optimizer("Adam", 1e-3)
    state = opt.init(params)
    for i in range(steps):
        grads = jax.tree_util.tree_map(lambda p: jnp.cos(p * (i + 1.5)), params)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    jcheckpoint.save_params(str(weights_dir), snr, 0.2, params, 0.375, state)
    adam = state[0]
    np_tree = lambda t: {k: np.asarray(v) for k, v in t.items()}
    return np_tree(params), np_tree(adam.mu), np_tree(adam.nu), int(adam.count)


@pytest.mark.parametrize("family", ["vnet", "lstm"])
def test_load_checkpoint_reads_jax_checkpoints_bit_equal(family, tmp_path):
    init = jvnet.init_params(jax.random.PRNGKey(1), 16) if family == "vnet" else \
        jlstm.init_params(jax.random.PRNGKey(1))
    params, mu, nu, count = _jax_checkpoint(tmp_path, init)
    ckpt = load_checkpoint(str(tmp_path), 10.0, 0.2, "cpu")
    assert ckpt["loss"] == 0.375 and ckpt["opt_state"].count == count == 2
    for got, want in ((ckpt["params"], params), (ckpt["opt_state"].mu, mu),
                      (ckpt["opt_state"].nu, nu)):
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == torch.float32 and got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    assert load_checkpoint(str(tmp_path), 8.0, 0.2, "cpu") is None


def test_pt_checkpoint_takes_precedence_over_msgpack(tmp_path):
    _jax_checkpoint(tmp_path, jvnet.init_params(jax.random.PRNGKey(1), 16))
    t = Trainer(Config(val_frames=1), "vnet", device="cpu", weights_dir=str(tmp_path),
                verbose=False)
    model = t.init_params()
    params = {k: v.detach() for k, v in t.spec.model.param_dict(model).items()}
    t.save_weights(params, 0.25, 10.0, 0.2)
    ckpt = load_checkpoint(str(tmp_path), 10.0, 0.2, "cpu")
    assert ckpt["loss"] == 0.25 and torch.equal(ckpt["params"]["w2"], params["w2"])


def test_trainer_evaluates_a_jax_checkpoint_without_training(tmp_path, monkeypatch):
    """A port Trainer whose weights dir holds only the JAX package's
    .msgpack (of seeded random params, with its Adam state, and the JAX
    provenance beside it) evaluates it with no training on the miss. Its detections of
    one JAX-generated batch, RS-decoded, give the JAX Trainer's coded BER
    with the params the JAX Trainer loads from the same file, within the
    vnet tolerance of tests/test_torch_slice.py (2e-3)."""
    jcfg = jconfig.Config(val_frames=2)
    _jax_checkpoint(tmp_path, jvnet.init_params(jax.random.PRNGKey(3), 16))
    jcheckpoint.save_config_provenance(str(tmp_path), jcfg)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["config.yaml",
                                                          "snr_10.0_gamma_0.2.msgpack"]
    monkeypatch.setattr(Trainer, "train", lambda self: pytest.fail("trained on the miss"))
    cfg = load_config(str(tmp_path / "config.yaml"))
    t = Trainer(cfg, "vnet", device="cpu", weights_dir=str(tmp_path), verbose=False)
    sers = t.evaluate()
    assert sers.shape == (1,) and 0.0 <= sers[0] <= 1.0
    assert not list(tmp_path.glob("*.pt"))

    b, y = jdataset.generate_words(jax.random.PRNGKey(5), jax.random.PRNGKey(6), 10.0, 0.2,
                                   n_words=50, block_length=120, memory_length=4, use_ecc=True,
                                   n_symbols=2, channel_coefficients="time_decay", fading=True,
                                   fading_taps_type=1)
    h = j_taps(4, 0.2, jnp.arange(50), fading=True, fading_taps_type=1)
    di = Config(val_frames=2).data_indices("val")
    jparams = JTrainer(jcfg, "vnet", weights_dir=str(tmp_path), verbose=False).load_weights(
        10.0, 0.2)
    decoded, _ = rs_decode_bits_host(np.asarray(JDETECTORS["vnet"].detect(jparams, y, None)), 2)
    want = float(j_error_rates(jnp.asarray(decoded)[di], b[di])[0])
    model = t.load_weights(10.0, 0.2)
    got = float(t.eval_tail(model, torch.tensor(np.asarray(b)), torch.tensor(np.asarray(y)),
                            torch.tensor(np.asarray(h))))
    assert abs(got - want) <= 2e-3, (got, want)
