"""One rank of a multi-process run of the port's parallel layer on gloo (CPU).

Started by tests/test_torch_parallel.py as N processes of

    torch_parallel_worker.py <rank> <world size> <port> <inputs.npz> <out dir>

It imports torch, numpy and the port only. It joins the group through
init_distributed, runs every parallel path of its world on the inputs the
test wrote, writes this rank's outputs to <out dir>/rank<r>.npz and prints
"OK rank r"; the test compares them with the JAX package's.
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from metaviterbinet_tpu_torch import Config
from metaviterbinet_tpu_torch.detectors import DETECTORS
from metaviterbinet_tpu_torch.evaluation.trainer import Trainer
from metaviterbinet_tpu_torch.models import viterbinet
from metaviterbinet_tpu_torch.parallel.decode import sequence_parallel_decode, shard_words_decode
from metaviterbinet_tpu_torch.parallel.mesh import (
    init_distributed, make_mesh, make_multihost_mesh, mesh_axis)
from metaviterbinet_tpu_torch.parallel.training import make_dp_train_step
from metaviterbinet_tpu_torch.train.losses import make_loss_fn
from metaviterbinet_tpu_torch.train.optim import Optimizer
from metaviterbinet_tpu_torch.weights import params_from_jax

OVERLAP = 32
# tests/test_parallel.py::test_trainer_mesh_shape_matches_plain_eval's sizes
# (5 words: the words axis is padded), over the VA sweep's SNRs
TRAINER_BASE = dict(val_block_length=24, n_symbols=1, val_frames=1, subframes_in_frame=5)


def _block(x: np.ndarray, axis: int, index: int, n: int) -> torch.Tensor:
    size = x.shape[axis] // n
    return torch.from_numpy(np.ascontiguousarray(
        np.take(x, range(index * size, (index + 1) * size), axis=axis)))


def main() -> None:
    rank, world, port = (int(a) for a in sys.argv[1:4])
    inputs, out_dir = sys.argv[4], sys.argv[5]
    torch.set_num_threads(1)
    init_distributed(f"localhost:{port}", world, rank, device="cpu")
    d = np.load(inputs)
    jax_params = {k[len("vnet_"):]: d[k] for k in d.files if k.startswith("vnet_")}
    out = {}

    # words-sharded detect: the VA (K2's plain version) at 16 and 15 words
    # (the padding), ViterbiNet through K1's plain version
    mesh = make_mesh((world,), ("dp",), device="cpu")
    run_va = shard_words_decode(mesh, DETECTORS["va"].detect)
    y, h = torch.from_numpy(d["va_y"]), torch.from_numpy(d["va_h"])
    out["va_16"] = run_va(None, y, h)
    out["va_15"] = run_va(None, y[:15], h[:15])
    model = params_from_jax(jax_params, "cpu")
    run_k1 = shard_words_decode(mesh, DETECTORS["vnet"].detect)
    out["k1"] = run_k1(model, torch.from_numpy(d["k1_y"]), torch.zeros(d["k1_y"].shape[0], 4))

    # sequence-parallel decode over all ranks, each with its time block
    sp_mesh = make_mesh((world,), ("sp",), device="cpu")
    out["sp"] = sequence_parallel_decode(sp_mesh, OVERLAP)(_block(d["sp_priors"], 1, rank, world))

    # 2D: words over hosts ('dp'), time over each host's ranks ('sp')
    if world == 4:
        try:
            make_multihost_mesh(chips_per_host=3, device="cpu")
        except ValueError:
            out["chips_per_host_3_raises"] = np.ones(1)
        mesh2 = make_multihost_mesh(chips_per_host=2, device="cpu")
        (_, n_dp, dp), (_, n_sp, sp) = mesh_axis(mesh2, "dp"), mesh_axis(mesh2, "sp")
        out["mesh2_shape"] = np.asarray(mesh2.shape)
        local = _block(d["sp2d_priors"], 0, dp, n_dp)
        local = local[:, sp * local.shape[1] // n_sp:(sp + 1) * local.shape[1] // n_sp].contiguous()
        out["sp2d"] = sequence_parallel_decode(mesh2, OVERLAP, words_axis="dp")(local)
        out["sp2d_index"] = np.asarray([dp, sp])

    # data-parallel step: SGD(0.1), no subsampling, this rank's rows
    model = params_from_jax(jax_params, "cpu")
    params = viterbinet.param_dict(model)
    opt = Optimizer("SGD", 0.1)
    loss_fn = make_loss_fn(viterbinet.logits, "states", 4, False)
    step = make_dp_train_step(mesh, loss_fn, opt)
    rx, tx = _block(d["dp_rx"], 0, rank, world), _block(d["dp_tx"], 0, rank, world)
    _, _, loss = step(params, opt.init(params), rx, tx)
    out["dp_loss"] = loss.detach()
    for k, v in params.items():
        out[f"dp_param_{k}"] = v.detach()

    # the Trainer with Config.mesh_shape against the Trainer with no mesh
    if world == 2:
        sweep = dict(TRAINER_BASE, val_SNR_start=7.0, val_SNR_end=12.0)
        point = dict(TRAINER_BASE, val_SNR_start=10.0, val_SNR_end=10.0)
        net = viterbinet.init_params(16, torch.Generator().manual_seed(0), device="cpu")
        for key, cfg, detector, p in (("va", sweep, "va", None), ("vnet", point, "vnet", net)):
            for mesh_shape in ((world,), None):
                trainer = Trainer(Config(mesh_shape=mesh_shape, **cfg), detector, device="cpu",
                                  params=p, verbose=False)
                out[f"trainer_{key}_{'mesh' if mesh_shape else 'plain'}"] = trainer.evaluate()

    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: np.asarray(v) for k, v in out.items()})
    dist.destroy_process_group()
    print(f"OK rank {rank}", flush=True)


if __name__ == "__main__":
    main()
