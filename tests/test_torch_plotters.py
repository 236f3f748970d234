"""The port's experiment harness (plotters/ and the CLI's `sweep` and `taps`)
against the JAX package's, on the CPU: the same curve table, sweep configs,
style, weights-dir and cache names and plotted data; the port's cache and
figures in its own directories; the seven-curve sweep end to end at a tiny
size; and a sweep or `taps` without matplotlib failing before any curve."""
import dataclasses
import json
import os
import subprocess
import sys

import matplotlib
import matplotlib.pyplot as plt
import numpy as np
import pytest

import metaviterbinet_tpu.paths as jpaths
import metaviterbinet_tpu.plotters.cache as jcache
import metaviterbinet_tpu.plotters.experiments as jexperiments
import metaviterbinet_tpu.plotters.figures as jfigures
import metaviterbinet_tpu.plotters.style as jstyle
from metaviterbinet_tpu_torch import Config, cli, paths
from metaviterbinet_tpu_torch.evaluation.trainer import Trainer
from metaviterbinet_tpu_torch.plotters import cache, experiments, figures, style
from metaviterbinet_tpu_torch.train.checkpoint import save_config_provenance
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# a sweep small enough for the CPU: 10 blocks of 24 info bits + RS nsym=1,
# the LSTM's and the meta loops' few steps
TINY = dict(val_frames=2, subframes_in_frame=5, train_frames=2, train_minibatch_num=2,
            train_minibatch_size=8, meta_train_iterations=2, meta_j_num=2, meta_subframes=3,
            buffer_capacity=16, self_supervised_iterations=3)
BLOCK, NSYM, N_BLOCKS = 24, 1, 10


@pytest.fixture
def port_dirs(tmp_path, monkeypatch):
    """The port's weights, cache and figure directories in tmp_path."""
    dirs = {name: str(tmp_path / name) for name in ("weights", "plots", "figures")}
    monkeypatch.setattr(experiments, "WEIGHTS_DIR", dirs["weights"])
    monkeypatch.setattr(cache, "PLOTS_DIR", dirs["plots"])
    monkeypatch.setattr(figures, "FIGURES_DIR", dirs["figures"])
    return dirs


def _files(root: str) -> list:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


# ------------------------------------------------------- against the JAX package

def test_curves_are_the_jax_rows():
    assert [dataclasses.astuple(c) for c in experiments.CURVES] == \
        [dataclasses.astuple(c) for c in jexperiments.CURVES]
    from metaviterbinet_tpu_torch.plotters import CURVES, run_sweep
    assert CURVES is experiments.CURVES and run_sweep is experiments.run_sweep


@pytest.mark.parametrize("channel", ["cost2100", "time_decay"])
@pytest.mark.parametrize("overrides", [{}, dict(TINY, lr=0.01, weights_init="random")])
def test_sweep_config_equals_jax(channel, overrides):
    for snr in (7.0, 12.0):
        got = experiments.sweep_config(snr, 120, 2, channel, **overrides)
        want = jexperiments.sweep_config(snr, 120, 2, channel, **overrides)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_style_equals_jax(monkeypatch):
    for name in ("COLORS", "MARKERS", "LINESTYLES", "DISPLAY_NAMES", "MIN_BER_COEF",
                 "MARKER_EVERY"):
        assert getattr(style, name) == getattr(jstyle, name), name
    applied = []
    for module in (jstyle, style):
        monkeypatch.setattr(matplotlib, "rcParams", {})
        module.apply_style()
        applied.append(matplotlib.rcParams)
    assert applied[0] == applied[1] == style.RC_PARAMS


def test_the_port_keeps_its_own_result_dirs():
    for name, leaf in (("WEIGHTS_DIR", "torch_weights"), ("PLOTS_DIR", "torch_plots"),
                       ("FIGURES_DIR", "torch_figures")):
        ours, theirs = getattr(paths, name), getattr(jpaths, name)
        assert ours == os.path.join(paths.ROOT_DIR, "results", leaf) and ours != theirs
    assert cache.PLOTS_DIR == paths.PLOTS_DIR and figures.FIGURES_DIR == paths.FIGURES_DIR
    assert experiments.WEIGHTS_DIR == paths.WEIGHTS_DIR


class _RecordingTrainer:
    """Stands in for a Trainer: records its weights dir, evaluates to zeros."""
    made = []

    def __init__(self, cfg, detector, weights_dir=None, verbose=True, device=None):
        self.cfg = cfg
        self.made.append((detector, weights_dir))

    def evaluate(self):
        return np.zeros(3)


@pytest.mark.parametrize("channel", ["cost2100", "time_decay"])
def test_weights_dirs_and_cache_names_equal_jax(channel, tmp_path, monkeypatch):
    """build_curve's weights dirs and the cache's pickle names are the JAX
    package's, each under its own package's results."""
    got = {}
    for name, module, cache_module in (("jax", jexperiments, jcache),
                                       ("port", experiments, cache)):
        recorder = type("Recorder", (_RecordingTrainer,), {"made": []})
        monkeypatch.setattr(module, "Trainer", recorder)
        monkeypatch.setattr(cache_module, "PLOTS_DIR", str(tmp_path / name))
        cfg = module.sweep_config(8.0, channel_coefficients=channel)
        for spec in module.CURVES:
            module.build_curve(spec, cfg, verbose=False)
        root = module.WEIGHTS_DIR
        got[name] = ([(d, os.path.relpath(w, root)) for d, w in recorder.made],
                     _files(str(tmp_path / name)))
        assert all(w.startswith(root + os.sep) for _, w in recorder.made)
    assert got["port"] == got["jax"]
    assert len(got["port"][1]) == 7 and f"ViterbiNet_{channel}_8.0_120_2_ISI_AWGN.pkl" \
        in got["port"][1]


class _FakeTrainer:
    def __init__(self, ser):
        self.cfg = Config()
        self._ser = ser
        self.calls = 0

    def evaluate(self):
        self.calls += 1
        return self._ser


def test_ser_cache_memoizes_and_honours_run_over(port_dirs):
    t = _FakeTrainer(np.array([0.1, 0.2]))
    s1 = cache.get_ser_curve(t, run_over=False, method_name="m1")
    s2 = cache.get_ser_curve(t, run_over=False, method_name="m1")
    assert t.calls == 1
    np.testing.assert_array_equal(s1, s2)
    cache.get_ser_curve(t, run_over=True, method_name="m1")
    assert t.calls == 2
    assert _files(port_dirs["plots"]) == ["m1_ISI_AWGN.pkl"]


@pytest.fixture
def plotted(monkeypatch):
    """Records the data of every plt.plot call."""
    calls = []
    real = plt.plot
    monkeypatch.setattr(plt, "plot", lambda x, y, **kw: calls.append(
        (np.asarray(x, dtype=np.float64), np.asarray(y, dtype=np.float64), kw.get("label")))
        or real(x, y, **kw))
    return calls


def _both(plotted, run) -> tuple:
    """run(module) for the JAX package's figures module, then the port's:
    what each plotted and the path each returned."""
    out = []
    for module in (jfigures, figures):
        plotted.clear()
        path = run(module)
        out.append((list(plotted), path))
    return tuple(out)


def _assert_same_plots(a, b, atol=0.0):
    assert len(a) == len(b) > 0
    for (xa, ya, la), (xb, yb, lb) in zip(a, b):
        assert la == lb
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_allclose(ya, yb, rtol=0, atol=atol)


def _curves(n_snrs: int) -> list:
    rng = np.random.default_rng(0)
    names = [c.method_name for c in experiments.CURVES]
    return [(rng.uniform(1e-4, 1e-1, 50), name, 120, 2) for _ in range(n_snrs) for name in names]


def test_figures_plot_the_jax_data(port_dirs, tmp_path, plotted, monkeypatch):
    monkeypatch.setattr(jfigures, "FIGURES_DIR", str(tmp_path / "jax_figures"))
    curves = _curves(2)
    (jax_calls, _), (calls, path) = _both(
        plotted, lambda m: m.plot_by_block(curves[:7], 120, 2, 10.0))
    _assert_same_plots(jax_calls, calls)
    assert path.startswith(port_dirs["figures"] + os.sep) and os.path.isfile(path)
    (jax_calls, _), (calls, path) = _both(
        plotted, lambda m: m.plot_ber_vs_snr(curves, [10.0, 12.0]))
    _assert_same_plots(jax_calls, calls)
    assert len(calls) == 7 and all(len(y) == 2 for _, y, _ in calls)
    assert path.startswith(port_dirs["figures"] + os.sep) and os.path.isfile(path)


@pytest.mark.parametrize("channel", ["time_decay", "cost2100"])
@pytest.mark.parametrize("fading_type", [1, 2])
def test_tap_trajectories_equal_jax(channel, fading_type, port_dirs, tmp_path, plotted,
                                    monkeypatch):
    """The taps each package plots, within the 1e-5 of the port's other
    channel tests (float32 cosines computed by two libraries)."""
    monkeypatch.setattr(jfigures, "FIGURES_DIR", str(tmp_path / "jax_figures"))
    (jax_calls, _), (calls, path) = _both(plotted, lambda m: m.plot_tap_trajectories(
        channel_coefficients=channel, fading_taps_type=fading_type, n_blocks=60))
    _assert_same_plots(jax_calls, calls, atol=1e-5)
    assert len(calls) == 4 and path.startswith(port_dirs["figures"] + os.sep)


# ------------------------------------------------------- the sweep end to end

def test_run_sweep_builds_the_seven_curves_on_the_cpu(port_dirs):
    snrs = [8.0, 10.0]
    all_curves, fig = experiments.run_sweep(snrs, BLOCK, NSYM, device="cpu", **TINY)
    assert [name for _, name, _, _ in all_curves] == \
        [c.method_name for c in experiments.CURVES] * len(snrs)
    for ser, _, block, nsym in all_curves:
        assert ser.shape == (N_BLOCKS,) and np.all((ser >= 0) & (ser <= 1))
        assert (block, nsym) == (BLOCK, NSYM)
    assert fig.startswith(port_dirs["figures"] + os.sep) and os.path.isfile(fig)
    assert len(_files(port_dirs["plots"])) == 14
    # the JAX package's weights-dir names under the port's weights dir
    assert sorted(os.listdir(port_dirs["weights"])) == sorted(
        {f"{c.weights_prefix}_{BLOCK}_{NSYM}_channel1" for c in experiments.CURVES
         if c.detector != "va"})


def test_cli_sweep_then_from_the_cache(port_dirs, tmp_path, capsys, monkeypatch):
    """`sweep --device cpu` builds the seven curves and prints the JAX CLI's
    last line, with the tiny sizes from --set; the same command again, here
    with --by-block, reads every curve from the cache; --run-over recomputes
    each. A sweep takes no --config: its Config is the paper's protocol,
    and a config file (a provenance holds every field) would replace it."""
    config = tmp_path / "config.yaml"
    save_config_provenance(str(tmp_path), Config(**TINY))
    with pytest.raises(SystemExit):
        cli.main(["sweep", "--snrs", "8", "--device", "cpu", "--config", str(config)])
    assert _files(port_dirs["plots"]) == []
    argv = ["sweep", "--snrs", "8", "--device", "cpu", "--set",
            *(f"{k}={v}" for k, v in TINY.items()),
            f"val_block_length={BLOCK}", f"n_symbols={NSYM}"]
    assert cli.main(argv) == 0
    assert _files(port_dirs["plots"])[0].endswith(f"_8.0_{BLOCK}_{NSYM}_ISI_AWGN.pkl")
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"curves", "figure"} and os.path.isfile(out["figure"])
    assert [c["method"] for c in out["curves"]] == [c.method_name for c in experiments.CURVES]
    assert all(set(c) == {"method", "mean_ser"} and 0 <= c["mean_ser"] <= 1
               for c in out["curves"])
    evaluated = []
    monkeypatch.setattr(Trainer, "evaluate", lambda self: evaluated.append(self) or
                        np.full(N_BLOCKS, 0.5))
    assert cli.main(argv + ["--by-block"]) == 0
    again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert evaluated == [] and again["figure"] is None
    assert again["curves"] == out["curves"]
    assert any(f.endswith("Error symbols 1.png") for f in _files(port_dirs["figures"]))
    assert cli.main(argv + ["--run-over"]) == 0
    capsys.readouterr()
    assert len(evaluated) == 7


def test_cli_taps_writes_a_figure(port_dirs, capsys):
    assert cli.main(["taps", "--channel", "cost2100", "--fading-type", "2", "--blocks", "20"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["figure"].endswith("taps_cost2100_type2.png") and os.path.isfile(out["figure"])
    assert out["figure"].startswith(port_dirs["figures"] + os.sep)
    with pytest.raises(SystemExit):  # taps computes on the CPU: it takes no --device
        cli.main(["taps", "--device", "cpu"])


def test_without_matplotlib_sweep_and_taps_fail_before_any_curve(tmp_path):
    """matplotlib blocked, as on the card's machine: run_sweep, the CLI's
    sweep and taps raise before building a curve; build_curve, the path a
    sweep there takes, builds its curve into the cache."""
    code = f"""
import os, sys
sys.modules["matplotlib"] = None
import numpy as np
from metaviterbinet_tpu_torch import cli
from metaviterbinet_tpu_torch.plotters import cache, experiments, figures
cache.PLOTS_DIR = {str(tmp_path / "plots")!r}
experiments.WEIGHTS_DIR = {str(tmp_path / "weights")!r}
figures.FIGURES_DIR = {str(tmp_path / "figures")!r}
built = []
real = experiments.build_curve
experiments.build_curve = lambda *a, **k: built.append(a) or real(*a, **k)
tiny = {TINY!r}
for run in (lambda: experiments.run_sweep([8.0], {BLOCK}, {NSYM}, device="cpu", **tiny),
            lambda: cli.main(["sweep", "--device", "cpu"]),
            lambda: cli.main(["taps"])):
    try:
        run()
        raise SystemExit("no error")
    except RuntimeError as e:
        assert "matplotlib is not installed" in str(e), e
assert built == [], built
cfg = experiments.sweep_config(8.0, {BLOCK}, {NSYM}, **tiny)
ser = experiments.build_curve(experiments.CURVES[-1], cfg, verbose=False, device="cpu")
assert ser.shape == ({N_BLOCKS},) and len(os.listdir(cache.PLOTS_DIR)) == 1
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=paths.ROOT_DIR)
    proc = subprocess.run([sys.executable, "-c", code], cwd=paths.ROOT_DIR, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.split()[-1] == "ok", proc.stderr
    assert not (tmp_path / "figures").exists()
