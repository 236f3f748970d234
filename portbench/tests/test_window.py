"""The window's arithmetic: items counted by the time they ended, the
95th percentile over every item, and a stall inside the window showing in
the rate and in the tail alike."""
import numpy as np
import pytest

from portbench import window


def test_items_partition_the_runs():
    runs = [[0.0, 1.0, 3.0], [3.0, 4.0, 4.5]]
    assert window.items(runs) == [(1.0, 1.0), (3.0, 2.0), (4.0, 1.0), (4.5, 0.5)]
    assert sum(lat for _, lat in window.items(runs)) == runs[-1][-1] - runs[0][0]


def test_only_items_that_ended_count():
    runs = [[0.0, 1.0, 2.0, 3.0, 4.0]]
    assert window.in_window(runs, 2.5) == [1.0, 1.0]
    assert window.rate(runs, 2500.0) == pytest.approx(4 / 2.5)
    assert window.rate(runs, 2.0, per_item=2) == pytest.approx(2 * 2 / 0.002)


def test_p95_is_over_every_latency():
    lat = list(np.arange(1.0, 101.0))
    assert window.p95(lat) == pytest.approx(np.percentile(lat, 95))


def test_a_stall_shows_in_rate_and_tail():
    steady = [[float(t) for t in range(0, 1001, 10)]]           # 100 items of 10 ms
    stalled = [[float(t) for t in range(0, 501, 10)]
               + [float(t) for t in range(800, 1001, 10)]]      # one item waits 300 ms
    assert window.rate(stalled, 1000.0) < window.rate(steady, 1000.0)
    lat_steady, lat_stalled = (window.in_window(r, 1000.0) for r in (steady, stalled))
    assert max(lat_stalled) == 300.0
    assert window.p95(lat_stalled + [300.0] * 5) > window.p95(lat_steady)
