"""The port's fused SNR sweep, CLI and utils against the JAX package's (CPU,
small shapes): the sweep equals the per-SNR loop bit for bit, the CLI takes
the JAX CLI's arguments for `train` and `evaluate`, and the metrics records
have the JAX package's schema and events."""
import json

import numpy as np
import pytest
import torch

from metaviterbinet_tpu import config as jconfig
from metaviterbinet_tpu.evaluation.trainer import Trainer as JTrainer
from metaviterbinet_tpu.utils.logging import MetricsLogger as JMetricsLogger
from metaviterbinet_tpu_torch import Config
from metaviterbinet_tpu_torch import cli
from metaviterbinet_tpu_torch.evaluation.trainer import Trainer
from metaviterbinet_tpu_torch.kernels import acs
from metaviterbinet_tpu_torch.models import viterbinet
from metaviterbinet_tpu_torch.utils.logging import MetricsLogger
from metaviterbinet_tpu_torch.utils.profiling import Timer, trace
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


# 56 info bits + 8 parity bits: T = 64 splits into two chunks of 32, the
# default decode_overlap
TINY = dict(val_block_length=56, train_block_length=56, n_symbols=1, val_frames=2,
            subframes_in_frame=5, train_frames=2, train_minibatch_num=2, train_minibatch_size=8,
            meta_train_iterations=2, meta_j_num=2, meta_subframes=3, buffer_capacity=16,
            self_supervised_iterations=3)
SWEEP = dict(TINY, val_SNR_start=8.0, val_SNR_end=10.0)

# the fields of each event the JAX Trainer logs (evaluation/trainer.py:223-235,
# :319-321, :346-347, :412-413 there), besides step, time, event and detector
JAX_EVENTS = {"eval_point": {"snr", "ser", "elapsed_s"},
              "by_word_eval": {"snr", "mean_ser", "n_blocks", "buffer_fill", "elapsed_s"},
              "train_minibatch": {"snr", "minibatch", "ser", "loss"},
              "meta_train_minibatch": {"snr", "minibatch", "ser", "loss"}}
RECORD_KEYS = {"step", "time", "event", "detector"}


def _cli_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# ------------------------------------------------------------------ sweep

def test_va_sweep_bit_equal_to_the_loop():
    """VA over 3 SNRs: evaluate() (the sweep) equals the per-SNR loop of
    single_eval_at_point from the same seeds, bit for bit."""
    cfg = Config(**SWEEP)
    snrs = [float(s) for s in cfg.snr_range("val")]
    looped = Trainer(cfg, "va", device="cpu", verbose=False)
    loop = np.asarray([looped.single_eval_at_point(None, s, cfg.gamma) for s in snrs])
    sweep = Trainer(cfg, "va", device="cpu", verbose=False).evaluate()
    assert sweep.shape == (3,) and sweep.dtype == loop.dtype
    np.testing.assert_array_equal(sweep, loop)


@pytest.mark.parametrize("time_chunks", [0, 2])
def test_vnet_sweep_with_per_snr_params_bit_equal_to_the_loop(tmp_path, time_chunks):
    """vnet with a checkpoint per SNR, unchunked and through K4's plain
    version: evaluate() (the sweep) equals the loop over the same
    checkpoints."""
    cfg = Config(**SWEEP, eval_time_chunks=time_chunks)
    snrs = [float(s) for s in cfg.snr_range("val")]
    writer = Trainer(cfg, "vnet", device="cpu", weights_dir=str(tmp_path), verbose=False)
    for i, snr in enumerate(snrs):
        model = viterbinet.init_params(16, torch.Generator().manual_seed(i), device="cpu")
        writer.save_weights(viterbinet.param_dict(model), 0.0, snr, cfg.gamma)
    t = Trainer(cfg, "vnet", device="cpu", weights_dir=str(tmp_path), verbose=False)
    loop = np.asarray([t.single_eval_at_point(t.load_weights(s, cfg.gamma), s, cfg.gamma)
                       for s in snrs])
    sweep = Trainer(cfg, "vnet", device="cpu", weights_dir=str(tmp_path), verbose=False).evaluate()
    np.testing.assert_array_equal(sweep, loop)
    assert len(set(loop.tolist())) > 1


# ------------------------------------------------------------------ CLI

def test_cli_evaluate_va_on_the_cpu(capsys):
    rc = cli.main(["evaluate", "--detector", "va", "--snr", "10", "--device", "cpu",
                   "--set", "val_block_length=24", "n_symbols=1", "val_frames=1",
                   "subframes_in_frame=5"])
    assert rc == 0
    out = _cli_json(capsys)
    assert (out["detector"], out["eval_mode"], out["n_points"]) == ("va", "aggregated", 1)
    cfg = Config(val_block_length=24, n_symbols=1, val_frames=1, subframes_in_frame=5)
    assert out["mean_ser"] == Trainer(cfg, "va", device="cpu", verbose=False).evaluate().mean()


def test_cli_rejects_unknown_field_and_unported_commands():
    with pytest.raises(SystemExit):
        cli.main(["evaluate", "--detector", "va", "--device", "cpu", "--set", "nonsense=1"])
    for command in ("sweep", "taps", "bench"):
        with pytest.raises(SystemExit):
            cli.main([command])
    with pytest.raises(SystemExit):
        cli.main(["evaluate", "--detector", "multistream_lstm", "--device", "cpu"])


def test_cli_set_parses_like_the_jax_cli():
    from metaviterbinet_tpu.cli import _parse_set_overrides as j_parse
    pairs = ["val_frames=3", "lr=0.01", "use_ecc=false", "mesh_shape=(8,)",
             "weights_dir=/w", "dtype=bfloat16", "eval_time_chunks=4"]
    assert cli._parse_set_overrides(pairs) == j_parse(pairs)


def test_cli_train_then_chunked_evaluate(tmp_path, capsys, monkeypatch):
    """`train` writes the checkpoint; `evaluate --set eval_time_chunks=2`
    then detects through K4 (its plain version here) with no training."""
    common = ["--detector", "vnet", "--snr", "10", "--device", "cpu",
              "--weights-dir", str(tmp_path)]
    sets = ["--set"] + [f"{k}={v}" for k, v in TINY.items()]
    assert cli.main(["train", *common, *sets]) == 0
    out = _cli_json(capsys)
    assert out == {"status": "trained", "weights_dir": str(tmp_path)}
    assert (tmp_path / "snr_10.0_gamma_0.2.pt").is_file()
    chunked = []
    plain = acs.fused_viterbinet_detect_chunked_plain
    monkeypatch.setattr(acs, "fused_viterbinet_detect_chunked_plain",
                        lambda *a, **k: chunked.append(a[2]) or plain(*a, **k))
    monkeypatch.setattr(Trainer, "train", lambda self: pytest.fail("trained again"))
    assert cli.main(["evaluate", *common, *sets, "eval_time_chunks=2"]) == 0
    got = _cli_json(capsys)
    assert chunked == [2] and got["n_points"] == 1
    assert cli.main(["evaluate", *common, *sets]) == 0
    assert _cli_json(capsys)["mean_ser"] == got["mean_ser"]


@pytest.mark.parametrize("detector", ["lstm", "meta_lstm"])
def test_cli_evaluate_lstm_trains_on_the_miss(tmp_path, capsys, monkeypatch, detector):
    """`evaluate --detector lstm|meta_lstm`, the choices the registry gives:
    the miss trains the family's checkpoint, then the aggregated eval runs;
    the same command again loads it with no training, and twice gives the
    same BER (the first run's training drew val batches for its minibatch
    scores, so its own eval batch comes later in the stream)."""
    argv = ["evaluate", "--detector", detector, "--snr", "10", "--device", "cpu",
            "--weights-dir", str(tmp_path), "--set"] + [f"{k}={v}" for k, v in TINY.items()]
    assert cli.main(argv) == 0
    out = _cli_json(capsys)
    assert (out["detector"], out["eval_mode"], out["n_points"]) == (detector, "aggregated", 1)
    assert 0.0 <= out["mean_ser"] <= 1.0
    ckpt = torch.load(tmp_path / "snr_10.0_gamma_0.2.pt", weights_only=True)
    assert "w_hh1" in ckpt["params"]
    monkeypatch.setattr(Trainer, "train", lambda self: pytest.fail("trained again"))
    assert cli.main(argv) == 0
    again = _cli_json(capsys)["mean_ser"]
    assert cli.main(argv) == 0
    assert _cli_json(capsys)["mean_ser"] == again


def test_cli_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["evaluate", "--detector", "va", "--snr", "10"])


# ------------------------------------------------------------------ utils

def test_metrics_logger_writes_the_jax_record_schema(tmp_path):
    ours, theirs = tmp_path / "ours.jsonl", tmp_path / "jax.jsonl"
    for logger, path in ((MetricsLogger(str(ours)), ours), (JMetricsLogger(str(theirs)), theirs)):
        logger.log("eval_point", detector="va", snr=10.0, ser=np.float32(0.25), elapsed_s=1)
        logger.log("train_minibatch", detector="vnet", snr=10.0, minibatch=1, ser=0.5,
                   loss=torch.tensor(0.125))
    a = [json.loads(line) for line in ours.read_text().splitlines()]
    b = [json.loads(line) for line in theirs.read_text().splitlines()]
    for x, y in zip(a, b, strict=True):
        assert x.pop("time") > 0 and y.pop("time") > 0
        assert x == y


def test_trainer_emits_the_jax_events(tmp_path):
    """Each event with the JAX Trainer's fields; the eval_point record is
    compared with one the JAX Trainer writes."""
    logger = MetricsLogger(str(tmp_path / "m.jsonl"))
    cfg = Config(**TINY)
    Trainer(cfg, "va", device="cpu", verbose=False, metrics=logger).evaluate()
    Trainer(cfg, "vnet", device="cpu", weights_dir=str(tmp_path / "v"), verbose=False,
            metrics=logger).train()
    Trainer(cfg.replace(eval_mode="by_word"), "meta_vnet", device="cpu",
            weights_dir=str(tmp_path / "m"), verbose=False, metrics=logger).evaluate()
    records = [json.loads(line) for line in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == list(range(len(records)))
    seen = {}
    for r in records:
        assert set(r) == RECORD_KEYS | JAX_EVENTS[r["event"]], r
        seen.setdefault(r["event"], []).append(r["detector"])
    assert seen == {"eval_point": ["va"], "train_minibatch": ["vnet"] * 2,
                    "meta_train_minibatch": ["meta_vnet"] * 2, "by_word_eval": ["meta_vnet"]}
    jlog = JMetricsLogger(str(tmp_path / "j.jsonl"))
    JTrainer(jconfig.Config(**dict(TINY, val_block_length=24)), "va", verbose=False,
             metrics=jlog).evaluate()
    jrec = json.loads((tmp_path / "j.jsonl").read_text().splitlines()[0])
    assert set(jrec) == set(records[0]) and jrec["event"] == "eval_point"


def test_timer_and_trace_on_the_cpu(tmp_path):
    with Timer(device="cpu") as t:
        x = torch.ones(64, 64) @ torch.ones(64, 64)
        t.sync(x)
    assert t.elapsed is not None and t.elapsed >= 0
    with trace(str(tmp_path / "tr"), device="cpu"):
        torch.ones(32, 32) @ torch.ones(32, 32)
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Timer()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            with trace(str(tmp_path / "x")):
                pass
