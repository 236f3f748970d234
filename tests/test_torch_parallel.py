"""The port's parallel layer against the JAX package's (parallel/): the
words-sharded detect, the sequence-parallel decode in 1D and 2D, the chunked
decode, the data-parallel training step and the Trainer's Config.mesh_shape.

The JAX side runs in this process on its 8 virtual CPU devices, through the
functions tests/test_parallel.py uses, on the same inputs. The port runs
one process per rank: tests/torch_parallel_worker.py is started in 2 and in
4 gloo processes (one launch per world size, carrying all of its checks,
with a time limit of its own), reads the inputs from an .npz and writes its
outputs back. Bits are held equal; the training step to JAX's tolerances
(scripts/multiproc_worker.py:100-104)."""
import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from metaviterbinet_tpu.detectors import DETECTORS as JDETECTORS, with_pallas_detect
from metaviterbinet_tpu.models import va as jva
from metaviterbinet_tpu.models import viterbinet as jvnet
from metaviterbinet_tpu.ops.channel import isi_awgn_transmit
from metaviterbinet_tpu.ops.modulation import bpsk_modulate
from metaviterbinet_tpu.ops.trellis import viterbi_decode as j_viterbi_decode
from metaviterbinet_tpu.parallel import decode as jdecode
from metaviterbinet_tpu.parallel.mesh import make_mesh as j_make_mesh
from metaviterbinet_tpu.parallel.mesh import make_multihost_mesh as j_make_multihost_mesh
from metaviterbinet_tpu.parallel.training import make_dp_train_step as j_make_dp_train_step
from metaviterbinet_tpu.train.losses import make_loss_fn as j_make_loss_fn
from metaviterbinet_tpu_torch import Config
from metaviterbinet_tpu_torch.data.dataset import ChannelDataset
from metaviterbinet_tpu_torch.detectors import DETECTORS
from metaviterbinet_tpu_torch.evaluation.trainer import Trainer
from metaviterbinet_tpu_torch.models import viterbinet as tvnet
from metaviterbinet_tpu_torch.ops.trellis import viterbi_decode
from metaviterbinet_tpu_torch.parallel.decode import (
    chunked_decode_reference, sequence_parallel_decode, shard_words_decode)
from metaviterbinet_tpu_torch.parallel.mesh import init_distributed, make_mesh
from metaviterbinet_tpu_torch.parallel.training import make_dp_train_step
from metaviterbinet_tpu_torch.paths import ROOT_DIR
from metaviterbinet_tpu_torch.train.losses import make_loss_fn
from metaviterbinet_tpu_torch.train.optim import Optimizer
from metaviterbinet_tpu_torch.weights import params_from_jax
from test_parallel import _make_priors

WORKER = os.path.join(ROOT_DIR, "tests", "torch_parallel_worker.py")
LAUNCH_TIMEOUT_S = 120
OVERLAP = 32


def _va_words(W=16, T=136, L=4, seed=3):
    """tests/test_parallel.py::test_words_sharded_decode_matches_single_device's
    received words and taps at 12 dB."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, size=(W, T)).astype(np.float32)
    h = np.tile(np.exp(-0.2 * np.arange(L)), (W, 1)).astype(np.float32)
    padded = np.concatenate([bits, np.zeros((W, L))], axis=1)
    y = isi_awgn_transmit(jnp.asarray(bpsk_modulate(padded)), jnp.asarray(h), 12.0,
                          jax.random.PRNGKey(seed), L)
    return np.array(y), h


@pytest.fixture(scope="module")
def exchange(tmp_path_factory):
    """The inputs (written to an .npz for the workers) and the JAX package's
    results on its 8 devices."""
    mesh8 = j_make_mesh((8,), ("dp",))
    va_y, va_h = _va_words()
    va_detect = jdecode.shard_words_decode(mesh8, lambda params, y, h: jva.detect(y, h))
    params = jvnet.init_params(jax.random.PRNGKey(0), 16)
    k1_y = np.random.default_rng(5).normal(size=(16, 48)).astype(np.float32)
    k1_detect = jdecode.shard_words_decode(mesh8, with_pallas_detect(JDETECTORS["vnet"]).detect,
                                           via_shard_map=True)
    sp_priors = np.array(_make_priors(W=4, T=1024)[0])
    sp2d_priors = np.array(_make_priors(W=4, T=512)[0])
    mesh2d = j_make_multihost_mesh(chips_per_host=4)
    assert dict(mesh2d.shape) == {"dp": 2, "sp": 4}

    rng = np.random.default_rng(0)
    dp_rx = rng.normal(size=(16, 40)).astype(np.float32)
    dp_tx = rng.integers(0, 2, size=(16, 40)).astype(np.float32)
    loss_fn = j_make_loss_fn(jvnet.score, "states", 4, False, 8)
    opt = optax.sgd(0.1)
    p_dp, _, loss_dp = j_make_dp_train_step(mesh8, loss_fn, opt)(
        params, opt.init(params), jnp.asarray(dp_rx), jnp.asarray(dp_tx), jax.random.PRNGKey(1))

    jax_out = {
        "va_16": np.asarray(va_detect(None, jnp.asarray(va_y), jnp.asarray(va_h))),
        "va_15": np.asarray(va_detect(None, jnp.asarray(va_y[:15]), jnp.asarray(va_h[:15]))),
        "k1": np.asarray(k1_detect(params, jnp.asarray(k1_y), jnp.zeros((16, 4), jnp.float32))),
        "sp": np.asarray(jdecode.sequence_parallel_decode(j_make_mesh((8,), ("sp",)), OVERLAP)(
            jnp.asarray(sp_priors))),
        "sp_sequential": np.asarray(j_viterbi_decode(jnp.asarray(sp_priors))),
        "sp2d": np.asarray(jdecode.sequence_parallel_decode(mesh2d, OVERLAP, words_axis="dp")(
            jnp.asarray(sp2d_priors))),
        "sp2d_sequential": np.asarray(j_viterbi_decode(jnp.asarray(sp2d_priors))),
        "dp_loss": float(loss_dp),
        "dp_params": {k: np.asarray(v) for k, v in p_dp.items()},
    }
    np_params = {k: np.asarray(v) for k, v in params.items()}
    path = tmp_path_factory.mktemp("parallel") / "inputs.npz"
    np.savez(path, va_y=va_y, va_h=va_h, k1_y=k1_y, sp_priors=sp_priors, sp2d_priors=sp2d_priors,
             dp_rx=dp_rx, dp_tx=dp_tx, **{f"vnet_{k}": v for k, v in np_params.items()})
    inputs = {"va_y": va_y, "va_h": va_h, "k1_y": k1_y, "params": np_params,
              "dp_rx": dp_rx, "dp_tx": dp_tx}
    return path, inputs, jax_out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(world: int, inputs_path, out_dir) -> list[dict]:
    """The worker in `world` gloo processes; each rank's outputs. A launch
    that outlives LAUNCH_TIMEOUT_S is killed and fails the test."""
    env = dict(os.environ, PYTHONPATH=ROOT_DIR, OMP_NUM_THREADS="1")
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(key, None)
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, WORKER, str(rank), str(world), str(port),
                               str(inputs_path), str(out_dir)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for rank in range(world)]
    deadline = time.monotonic() + LAUNCH_TIMEOUT_S
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"the {world}-rank launch outlived {LAUNCH_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"OK rank {rank}" in out, f"rank {rank}:\n{out}"
    return [dict(np.load(out_dir / f"rank{rank}.npz")) for rank in range(world)]


@pytest.fixture(scope="module")
def ranks(exchange, tmp_path_factory):
    """ranks(world) -> each rank's outputs of the one launch of that world
    (a launch that failed fails every test of its world, unlaunched again)."""
    done, failed = {}, {}

    def get(world: int) -> list[dict]:
        if world in failed:
            pytest.fail(f"the {world}-rank launch failed: {failed[world]}")
        if world not in done:
            out_dir = tmp_path_factory.mktemp(f"world{world}")
            try:
                done[world] = _launch(world, exchange[0], out_dir)
            except (AssertionError, pytest.fail.Exception) as e:
                failed[world] = str(e)
                raise
        return done[world]

    return get


@pytest.fixture
def no_group():
    """A test that forms a process group in this process leaves none behind."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


# ------------------------------------------------------------ multi-rank

@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("words", [16, 15])
def test_words_sharded_va_detect_matches_jax(exchange, ranks, world, words):
    """Every rank gets all W words' bits: the port's single-rank detect's
    and JAX's shard_words_decode's on 8 devices; W = 15 pads the words."""
    _, inputs, jax_out = exchange
    single = DETECTORS["va"].detect(None, torch.from_numpy(inputs["va_y"][:words]),
                                    torch.from_numpy(inputs["va_h"][:words])).numpy()
    np.testing.assert_array_equal(single, jax_out[f"va_{words}"])
    for out in ranks(world):
        np.testing.assert_array_equal(out[f"va_{words}"], single)


@pytest.mark.parametrize("world", [2, 4])
def test_words_sharded_k1_detect_matches_jax(exchange, ranks, world):
    """ViterbiNet through K1's plain version, words-sharded: the port's
    single-rank detect's bits and JAX's sharded Pallas detect's."""
    _, inputs, jax_out = exchange
    model = params_from_jax(inputs["params"], "cpu")
    y = torch.from_numpy(inputs["k1_y"])
    single = DETECTORS["vnet"].detect(model, y, torch.zeros(16, 4)).numpy()
    np.testing.assert_array_equal(single, jax_out["k1"])
    for out in ranks(world):
        np.testing.assert_array_equal(out["k1"], single)


@pytest.mark.parametrize("world", [2, 4])
def test_sequence_parallel_decode_matches_jax(exchange, ranks, world):
    _, _, jax_out = exchange
    gathered = np.concatenate([out["sp"] for out in ranks(world)], axis=1)
    np.testing.assert_array_equal(gathered, jax_out["sp"])
    np.testing.assert_array_equal(gathered, jax_out["sp_sequential"])


def test_two_dimensional_decode_matches_jax(exchange, ranks):
    """make_multihost_mesh(chips_per_host=2) at world 4 is (2, 2), hosts-major;
    words over 'dp' and time over 'sp' give JAX's (2, 4) decode's bits."""
    _, _, jax_out = exchange
    outs = ranks(4)
    want = jax_out["sp2d"]
    assert [tuple(out["mesh2_shape"]) for out in outs] == [(2, 2)] * 4
    assert [tuple(out["sp2d_index"]) for out in outs] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for out in outs:
        dp, sp = out["sp2d_index"]
        np.testing.assert_array_equal(out["sp2d"], want[2 * dp:2 * dp + 2, 256 * sp:256 * sp + 256])
    np.testing.assert_array_equal(want, jax_out["sp2d_sequential"])


def test_multihost_mesh_rejects_hosts_that_do_not_divide(ranks):
    assert all("chips_per_host_3_raises" in out for out in ranks(4))


@pytest.mark.parametrize("world", [2, 4])
def test_dp_train_step_matches_jax(exchange, ranks, world):
    """psum-of-grads over the ranks == JAX's dp step on 8 devices == one
    full-batch step on one device; every rank holds the same params."""
    _, inputs, jax_out = exchange
    model = params_from_jax(inputs["params"], "cpu")
    params = tvnet.param_dict(model)
    loss_fn = make_loss_fn(tvnet.logits, "states", 4, False)
    rx, tx = torch.from_numpy(inputs["dp_rx"]), torch.from_numpy(inputs["dp_tx"])
    loss = loss_fn(params, rx, tx)
    grads = torch.autograd.grad(loss, list(params.values()))
    opt = Optimizer("SGD", 0.1)
    opt.step(params, dict(zip(params, grads)), opt.init(params))
    for out in ranks(world):
        np.testing.assert_allclose(float(out["dp_loss"]), jax_out["dp_loss"], rtol=1e-5)
        np.testing.assert_allclose(float(out["dp_loss"]), loss.item(), rtol=1e-5)
        for k, v in params.items():
            np.testing.assert_allclose(out[f"dp_param_{k}"], jax_out["dp_params"][k],
                                       rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(out[f"dp_param_{k}"], v.detach().numpy(),
                                       rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("detector", ["va", "vnet"])
def test_trainer_mesh_shape_equals_plain_eval(ranks, detector):
    """Config.mesh_shape=(2,) at world 2 on 5 words (padded to 6): the VA
    sweep's and a seeded ViterbiNet point's coded BERs equal the Trainer's
    with no mesh from the same seeds, on every rank."""
    outs = ranks(2)
    for out in outs:
        np.testing.assert_array_equal(out[f"trainer_{detector}_mesh"],
                                      out[f"trainer_{detector}_plain"])
        np.testing.assert_array_equal(out[f"trainer_{detector}_mesh"],
                                      outs[0][f"trainer_{detector}_mesh"])
    assert outs[0][f"trainer_{detector}_mesh"].shape == ((6,) if detector == "va" else (1,))


# ------------------------------------------------------------ in process

def test_chunked_decode_reference_matches_jax():
    priors = np.array(_make_priors(W=4, T=1024)[0])
    want = np.asarray(jdecode.chunked_decode_reference(jnp.asarray(priors), 8, OVERLAP))
    got = chunked_decode_reference(torch.from_numpy(priors), 8, OVERLAP).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, viterbi_decode(torch.from_numpy(priors)).numpy())
    with pytest.raises(ValueError, match="does not split"):
        chunked_decode_reference(torch.from_numpy(priors), 7, OVERLAP)


def test_init_distributed_forms_a_world_one_group(no_group, monkeypatch):
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    init_distributed(device="cpu")
    group = dist.group.WORLD
    assert (dist.get_backend(), dist.get_world_size(), dist.get_rank()) == ("gloo", 1, 0)
    init_distributed(device="cpu")  # a no-op: the same group
    assert dist.group.WORLD is group
    mesh = make_mesh(device="cpu")
    assert (mesh.mesh_dim_names, tuple(mesh.shape)) == (("dp",), (1,))


def test_world_one_paths_equal_the_single_device_ones(no_group):
    """At world 1 the words-sharded detect is the detect, the sequence-
    parallel decode the sequential one, and the dp step the plain step."""
    y, h = (torch.from_numpy(a) for a in _va_words(W=5))
    run = shard_words_decode(make_mesh((1,), ("dp",), device="cpu"), DETECTORS["va"].detect)
    assert torch.equal(run(None, y, h), DETECTORS["va"].detect(None, y, h))
    priors = torch.from_numpy(np.array(_make_priors(W=2, T=128)[0]))
    decode = sequence_parallel_decode(make_mesh((1, 1), device="cpu"), OVERLAP)
    assert torch.equal(decode(priors), viterbi_decode(priors))
    model = tvnet.init_params(16, torch.Generator().manual_seed(0), device="cpu")
    rx = torch.randn(4, 40, generator=torch.Generator().manual_seed(1))
    tx = torch.randint(0, 2, (4, 40), generator=torch.Generator().manual_seed(2)).float()
    loss_fn = make_loss_fn(tvnet.logits, "states", 4, True)
    opt = Optimizer("Adam", 1e-3)
    params = tvnet.param_dict(model)
    step = make_dp_train_step(make_mesh((1,), ("dp",), device="cpu"), loss_fn, opt,
                              minibatch_size=8)
    _, state, loss = step(params, opt.init(params), rx, tx, seed=3)
    assert state.count == 1 and torch.isfinite(loss)
    with pytest.raises(ValueError, match="minibatch_size"):
        make_dp_train_step(make_mesh((1,), ("dp",), device="cpu"), loss_fn, opt)(
            params, opt.init(params), rx, tx, seed=3)


def test_a_mesh_the_world_cannot_form_raises(no_group):
    with pytest.raises(ValueError, match=r"needs 2 devices, have 1"):
        make_mesh((2,), device="cpu")
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        Trainer(Config(mesh_shape=(2,), val_frames=1), "va", device="cpu", verbose=False)


def test_mesh_trainer_joins_the_group_before_it_allocates(no_group, monkeypatch):
    """With mesh_shape the Trainer joins the process group, which on the card
    sets the rank's device, before its datasets, generators or indices
    exist; so under torchrun they land on the rank's GPU."""
    from metaviterbinet_tpu_torch.evaluation import trainer as trainer_mod
    order = []

    def joining(device):
        order.append(("init_distributed", str(device)))
        init_distributed(device=device)

    def dataset(*args):
        order.append(("ChannelDataset", dist.is_initialized()))
        return ChannelDataset(*args)

    monkeypatch.setattr(trainer_mod, "init_distributed", joining)
    monkeypatch.setattr(trainer_mod, "ChannelDataset", dataset)
    Trainer(Config(mesh_shape=(1,), val_frames=1), "va", device="cpu", verbose=False)
    assert order == [("init_distributed", "cpu"), ("ChannelDataset", True),
                     ("ChannelDataset", True)]


def test_sequence_parallel_decode_needs_the_overlap_in_each_block(no_group):
    decode = sequence_parallel_decode(make_mesh((1, 1), device="cpu"), OVERLAP)
    with pytest.raises(ValueError, match="fewer than the overlap"):
        decode(torch.zeros(2, OVERLAP - 1, 16))
