"""Reading a profiled pass: the union of the device's intervals, its idle
gaps and the host span each began in."""
import pytest

from portbench import trace


def test_union_counts_overlap_once():
    assert trace.union_ms([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == pytest.approx(4.0)
    assert trace.union_ms([]) == 0.0
    assert trace.union_ms([(2, 3), (0, 10)]) == pytest.approx(10.0)


def test_gaps_between_busy_stretches():
    assert trace.gaps([(0, 2), (1, 3), (5, 6), (8, 9)]) == [(3, 5), (6, 8)]
    assert trace.gaps([(0, 10), (2, 3)]) == []


def test_gaps_named_by_the_open_host_span():
    spans = [(0.0, 4.0, "detect"), (4.0, 7.0, "meta")]
    named = trace.name_gaps([(3.0, 3.5), (5.0, 6.0), (8.0, 9.0)], spans)
    assert named == {"detect": 0.5, "meta": 1.0, "outside spans": 1.0}


def test_top_keeps_the_largest_ten():
    by_name = {f"k{i}": float(i) for i in range(15)}
    out = trace.top(by_name, 1e-3)
    assert len(out) == trace.TOP and out[0] == ["k14", pytest.approx(0.014)]
