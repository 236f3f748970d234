"""The port's tracer (utils/profiling.py::Tracer) on the CPU, where the
device's times are the host's clock: a traced run computes what an untraced
one does, its spans nest as the engine opens them, the idle time and self
time add up, the counts are per run, and no tracer is touched while none is
active."""
import contextlib

import numpy as np
import pytest
import torch

from metaviterbinet_tpu_torch import Config
from metaviterbinet_tpu_torch.evaluation.trainer import Trainer
from metaviterbinet_tpu_torch.online.engine import Draws, run_online
from metaviterbinet_tpu_torch.utils import profiling
from metaviterbinet_tpu_torch.utils.profiling import Tracer
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TINY = dict(val_block_length=24, train_block_length=24, n_symbols=1, val_frames=2,
            subframes_in_frame=5, train_frames=2, self_supervised_iterations=3,
            meta_train_iterations=2, meta_j_num=2, meta_subframes=3, buffer_capacity=16,
            train_minibatch_size=8, eval_mode="by_word", self_supervised=True, ser_thresh=1.0)
CELLS = {"meta_vnet": dict(online_meta=True), "vnet": dict(online_meta=False)}
ENGINE_SPANS = {"start", "detect", "meta", "adapt", "sync"}
BLOCK_PARTS = ["detect.viterbi", "detect.rs_decode", "detect.label"]


def _run(name, tracer=None, runs=1):
    cfg = Config(**TINY, **CELLS[name])
    trainer = Trainer(cfg, name, device="cpu", verbose=False)
    params = trainer.spec.init(cfg, torch.Generator().manual_seed(3), "cpu")
    tx, rx = trainer.val_dataset.get(10.0, cfg.gamma)
    h = trainer.decoder_csi(tx.shape[0])
    out = []
    with tracer or contextlib.nullcontext():
        for _ in range(runs):
            draws = Draws(cfg, trainer.spec, torch.device("cpu"),
                          torch.Generator().manual_seed(5), torch.Generator().manual_seed(5))
            out.append(run_online(cfg, trainer.spec, params, tx, rx, h, draws))
    return trainer.spec, out


@pytest.mark.parametrize("name", sorted(CELLS))
def test_a_traced_run_equals_an_untraced_one(name):
    spec, (plain,) = _run(name)
    _, (traced,) = _run(name, Tracer("cpu"))
    np.testing.assert_array_equal(plain.ser_by_word, traced.ser_by_word)
    assert (plain.n_gated, plain.n_buffer, plain.steps, plain.host_reads) == \
        (traced.n_gated, traced.n_buffer, traced.steps, traced.host_reads)
    assert traced.host_reads == 1
    a, b = spec.model.param_dict(plain.params), spec.model.param_dict(traced.params)
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_spans_nest_as_the_engine_opens_them(name):
    """Every span belongs to a run and, but for the runs themselves, has a
    parent; the engine's spans lie in their run, a block graph in its
    "detect" span, and its three parts tile it in order; self time is a
    span's device time less its children's."""
    tracer = Tracer("cpu")
    _, results = _run(name, tracer, runs=2)
    s = tracer.summary()
    n_words = len(results[0].ser_by_word)
    assert s.dropped == 0
    assert {sp.run for sp in s.spans} == {1, 2}
    children = {i: [] for i in range(len(s.spans))}
    for i, sp in enumerate(s.spans):
        if sp.name == "run":
            assert sp.parent == -1
            continue
        assert 0 <= sp.parent < i
        parent = s.spans[sp.parent]
        assert parent.run == sp.run
        assert parent.device[0] <= sp.device[0] <= sp.device[1] <= parent.device[1]
        children[sp.parent].append(i)
        if sp.name in ENGINE_SPANS:
            assert parent.name == "run"
        if sp.name == "block":
            assert parent.name == "detect"
    assert s.by_name["detect"].count == s.by_name["block"].count == 2 * n_words
    assert s.by_name["start"].count == s.by_name["sync"].count == 2
    self_ms = profiling.self_ms(s.spans)
    for i, sp in enumerate(s.spans):
        kids = [s.spans[j] for j in children[i]]
        if sp.name == "block":
            assert [k.name for k in kids] == BLOCK_PARTS
        for a, b in zip(kids, kids[1:]):  # siblings one after another
            assert a.device[1] <= b.device[0]
        inside = sum(k.device[1] - k.device[0] for k in kids)
        assert self_ms[i] == pytest.approx(sp.device[1] - sp.device[0] - inside, abs=1e-9)
    assert s.by_name["run"].self_ms == pytest.approx(
        sum(own for sp, own in zip(s.spans, self_ms) if sp.name == "run"))
    for part in BLOCK_PARTS:
        assert s.by_name[part].count == 2 * n_words
    assert s.covered_ms + sum(s.idle_ms.values()) == pytest.approx(s.window_ms, rel=1e-9)


def test_graphed_calls_are_direct_on_the_cpu_and_counted_per_run():
    """On the CPU every graphed call is direct (GraphedStep.counts, the
    one count of calls by kind), no kernel wrapper launches, and the
    tracer's counts of each run read no host sync and no upload. The
    graphs' LAUNCH_COUNTED is the loader's registry, which holds exactly
    the six kernel wrappers."""
    from metaviterbinet_tpu_torch.kernels import acs, maml_pairs, native, online_sgd
    from metaviterbinet_tpu_torch.online.graphs import LAUNCH_COUNTED, GraphedStep

    assert LAUNCH_COUNTED is native.LAUNCH_COUNTED
    assert sorted(LAUNCH_COUNTED, key=id) == sorted(
        [acs.fused_va_detect, acs.fused_viterbinet_detect, acs.fused_viterbinet_detect_chunked,
         acs.viterbi_decode_kernel, online_sgd.online_adapt_viterbinet,
         maml_pairs.maml_pairs_viterbinet], key=id)
    tracer = Tracer("cpu")
    GraphedStep.counts.clear()
    launches = [w.launches for w in LAUNCH_COUNTED]
    _, results = _run("meta_vnet", tracer, runs=2)
    n_words = len(results[0].ser_by_word)
    calls = GraphedStep.counts
    assert calls["block"]["direct"] == calls["self_supervised"]["direct"] == 2 * n_words
    assert calls["maml"]["direct"] > 0
    assert all(c["direct"] == sum(c.values()) for c in calls.values())
    assert [w.launches for w in LAUNCH_COUNTED] == launches
    counters = tracer.summary().counters
    assert set(counters) <= {1, 2}
    for run in (1, 2):
        c = counters.get(run, {})
        assert c.get("host_syncs", 0) == 0 and c.get("upload_bytes", 0) == 0


def test_no_tracer_is_touched_while_none_is_active(monkeypatch):
    idle = Tracer("cpu")

    def touched(*args, **kwargs):
        raise AssertionError("a tracer was touched")

    for method in ("span", "run", "count"):
        monkeypatch.setattr(Tracer, method, touched)
    _run("meta_vnet")
    assert profiling._active is None
    assert idle.records == [] and idle.counters == {} and idle._cpu_stamps == []


def test_a_full_buffer_drops_stamps_and_counts_them():
    tracer = Tracer("cpu", capacity=7)
    with tracer:
        for _ in range(3):
            with profiling.span("a"):
                with profiling.span("b"):
                    pass
    s = tracer.summary()
    # a, b, b closed, a closed, a: the second a has no exit stamp
    assert s.dropped == 12 - 7
    assert [sp.name for sp in s.spans] == ["a", "b", "b"]
    assert s.spans[1].parent == 0 and s.spans[2].parent == -1


def test_spans_enter_the_callers_hook_with_or_without_a_tracer():
    entered = []

    @contextlib.contextmanager
    def hook(name):
        entered.append(name)
        yield

    with profiling.span("x", hook):
        pass
    with Tracer("cpu") as tracer:
        with profiling.span("y", hook):
            pass
    assert entered == ["x", "y"]
    assert [sp.name for sp in tracer.summary().spans] == ["y"]


def test_union_and_gaps_of_device_intervals():
    assert profiling.union([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == [(0, 3), (5, 6)]
    assert profiling.gaps((0, 10), [(1, 3), (2, 4), (6, 7)]) == [(0, 1), (4, 6), (7, 10)]
    assert profiling.gaps((2, 5), [(0, 3), (4, 9)]) == [(3, 4)]
    assert profiling.gaps((0, 1), []) == [(0, 1)]


def test_idle_gaps_named_by_the_innermost_open_host_span():
    # host: run [0, 10] holding detect [1, 4] (holding block [1.5, 3.5]) and
    # meta [5, 9]
    host = [(0.0, 10.0, "run", -1), (1.0, 4.0, "detect", 0), (1.5, 3.5, "block", 1),
            (5.0, 9.0, "meta", 0)]
    named = profiling.name_gaps([(2.0, 2.5), (3.8, 4.8), (4.5, 5.0), (9.5, 11.0), (12.0, 13.0),
                                 (-2.0, -1.0)], host)
    assert named == {"block": 0.5, "detect": 1.0, "run": 2.0, "outside spans": 2.0}


def test_self_time_subtracts_the_union_of_children():
    spans = [profiling.SpanTimes("p", 1, -1, None, (0.0, 10.0)),
             profiling.SpanTimes("a", 1, 0, None, (1.0, 4.0)),
             profiling.SpanTimes("b", 1, 0, None, (3.0, 5.0)),
             profiling.SpanTimes("c", 1, 2, None, (3.5, 4.5))]
    assert profiling.self_ms(spans) == pytest.approx([6.0, 3.0, 1.0, 1.0])
