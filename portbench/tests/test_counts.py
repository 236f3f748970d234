"""The frozen operation and byte counts against values worked by hand."""
import pytest

from portbench import counts


def test_vnet_params():
    assert counts.vnet_params(16) == 100 * 2 + 50 * 101 + 16 * 51 == 6066


def test_adapt_ops_and_bound():
    # per symbol: forward 600 + 10000 + 100 + 1600 + 16, softmax 112,
    # backward 1600 + 1600 + 16 + 50 + 20000 + 50 + 300 + 200 + 100
    per_symbol = 12316 + 112 + 23916
    assert counts.adapt_ops(136, 16, 200) == 200 * (136 * per_symbol + 14 * 6066)
    assert counts.adapt_ops(136, 16, 200) == pytest.approx(1.006e9, rel=1e-3)
    ms, by = counts.adapt_bound_ms(136, 16, 200)
    assert by == "operations" and ms == pytest.approx(0.01501, rel=1e-3)


def test_decode_bound():
    ms, by = counts.decode_bound_ms(1, 136, 16)
    assert by == "bytes" and ms == pytest.approx(1e3 * 4 * (136 * 16 + 136) / 3.35e12)


def test_lstm_step_ops():
    per_t = (2 * 1024 * 260 + 2 * 1024 + 9 * 256) + (2 * 1024 * 512 + 2 * 1024 + 9 * 256) + 1026
    assert counts.lstm_params() == 1024 * 262 + 1024 * 514 + 2 * 257 == 795138
    assert counts.lstm_step_ops(136) == 3 * 136 * per_t + 14 * 795138
    assert counts.lstm_step_ops(136) == pytest.approx(0.660e9, rel=1e-3)


def test_maml_pair_ops():
    g = counts.vnet_gradient_ops(136, 16)
    assert counts.maml_pair_ops(136, 16, 1) == 4 * g + 16 * 6066
