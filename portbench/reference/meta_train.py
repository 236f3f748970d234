"""Offline MAML meta-training of ViterbiNet, written plainly (the
Meta-ViterbiNet reference's trainers/trainer.py `meta_train`): per
minibatch of train words, `meta_j_num` query words drawn uniformly from
[window, words), and for each distinct one, in ascending order, a
second-order MAML pair with the `window` words before it as support;
Adam over all the minibatches. The benchmark makes a by-word cell's start
params with it, so that both sides start from trained weights that neither
made."""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference import byword, channel, rs
from portbench.reference.adam import Adam


def meta_train(params: dict[str, torch.Tensor], proto: byword.Protocol, minibatches: int,
               train_words: int, snr_db: float, gamma: float, fading_type: int,
               generator: torch.Generator, host_generator: torch.Generator,
               info_bits: int) -> dict[str, torch.Tensor]:
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    adam = Adam(p, proto.lr)
    device = next(iter(p.values())).device
    bits, rx, _ = channel.words(minibatches, train_words, info_bits, proto.n_symbols,
                                proto.memory_length, gamma, snr_db, fading_type, generator, device)
    coded = torch.from_numpy(rs.encode_bits(
        bits.reshape(-1, info_bits).cpu().numpy(), proto.n_symbols)).to(device, rx.dtype)
    coded = coded.reshape(minibatches, train_words, -1)
    w = proto.window
    for b in range(minibatches):
        js = torch.randint(w, train_words, (proto.meta_j_num,), generator=host_generator)
        for j in np.unique(js.numpy()):
            byword.maml_pair(p, adam, proto, rx[b, j - w:j], coded[b, j - w:j], rx[b, j:j + 1],
                             coded[b, j:j + 1])
    return {k: v.detach() for k, v in p.items()}
