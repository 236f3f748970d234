"""The plain reference's RS codec against the port's batched one on words
with 0 to 3 symbol errors, and its windows and states against hand-made
ones."""
import numpy as np
import pytest
import torch

from portbench.reference import lstm, rs, viterbinet


@pytest.mark.parametrize("nsym", [2, 4])
def test_rs_codec_equals_the_ports(nsym):
    from metaviterbinet_tpu_torch.ecc import rs as port_rs

    rng = np.random.default_rng(nsym)
    bits = rng.integers(0, 2, (400, 120))
    coded = rs.encode_bits(bits, nsym)
    np.testing.assert_array_equal(
        coded, port_rs.rs_encode_bits(torch.as_tensor(bits, dtype=torch.float32), nsym).numpy())
    noisy = coded.copy()
    for w in range(noisy.shape[0]):
        for _ in range(w % 4):
            noisy[w, rng.integers(0, noisy.shape[1])] ^= 1
    ours = rs.decode_bits(noisy, nsym)
    theirs = port_rs.rs_decode_bits(torch.as_tensor(noisy, dtype=torch.float32), nsym)[0]
    np.testing.assert_array_equal(ours, theirs.numpy())
    assert (ours == bits).all(axis=1)[::4].all()  # no errors: every word back


def test_states_and_viterbi_readout():
    bits = torch.tensor([[1, 0, 1, 1, 0]])
    # state at t: b_t + 2 b_(t+1) + 4 b_(t+2) + 8 b_(t+3), zero past the end
    assert viterbinet.states(bits, 4).tolist() == [[1 + 4 + 8, 2 + 4, 1 + 2, 1, 0]]
    priors = np.zeros((3, 16))
    priors[:, 1::2] = 1.0  # odd states cost more: every bit reads 0
    assert viterbinet.viterbi(priors).tolist() == [0, 0, 0]


def test_lstm_windows_read_the_padding():
    p = {k: torch.zeros(s, dtype=torch.float64) for k, s in lstm.shapes().items()}
    p["b_fc"] += torch.tensor([0.0, 1.0], dtype=torch.float64)
    z = lstm.logits(p, torch.randn(1, 7, dtype=torch.float64))
    assert z.shape == (1, 7, 2) and torch.allclose(z[..., 1], torch.ones(1, 7, dtype=torch.float64))
