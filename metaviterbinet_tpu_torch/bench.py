"""The port's headline benchmark (the JAX package's bench.py): decoded
symbols per second of ViterbiNet detection (the 1 -> 100 -> 50 -> 16 MLP
branch metric fused with the 16-state ACS, L = 4) on one card, through K1
(kernels/acs.py::fused_viterbinet_detect).

    python -m metaviterbinet_tpu_torch bench [--device cpu]

Prints the card's name and power limit (nvidia-smi) on one line, then ONE
JSON line with bench.py's keys:
  {"metric": ..., "value": N, "unit": "symbols/s", "vs_baseline": N, ...}

`vs_baseline` is the speedup over the reference's evaluation inner loop in
torch on the CPU (vnet_detector.py:35-61: batched MLP priors, then a
per-symbol Python loop of gather-based add-compare-select), measured in
this run on the host of the card. resources/baseline_cpu.json holds the same
loop measured on another machine's CPU: it is read, reported beside under
a key of its own, and never written. `e2e_eval` times the aggregated
coded-BER eval of the full-CSI VA (datagen, K2 detect, RS decode on the
device, scoring) at one point and over the fused 7..12 dB sweep.
"""
from __future__ import annotations

import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from metaviterbinet_tpu_torch.config import Config
from metaviterbinet_tpu_torch.device import resolve_device
from metaviterbinet_tpu_torch.evaluation.trainer import Trainer
from metaviterbinet_tpu_torch.kernels.acs import fused_va_detect, fused_viterbinet_detect
from metaviterbinet_tpu_torch.models import viterbinet
from metaviterbinet_tpu_torch.paths import RESOURCES_DIR

BASELINE_CACHE = os.path.join(RESOURCES_DIR, "baseline_cpu.json")
REFERENCE_RUNTIME = os.path.join(RESOURCES_DIR, "reference_baselines.json")

# the reference's evaluation geometry: 300-word batches of 136-symbol codewords
REF_WORDS, T, L = 300, 136, 4
N_STATES = 2 ** L
# the card's batch: many independent blocks in flight (the words axis is the
# throughput axis)
CARD_WORDS = 65536
REPEATS, ITERS_PER_REPEAT = 5, 16
E2E_FRAMES, E2E_REPEATS = 12, 3


def measure_cpu_reference(words: int = REF_WORDS) -> float:
    """Reference-equivalent torch CPU decode throughput (symbols/s)."""
    torch.manual_seed(0)
    net = torch.nn.Sequential(
        torch.nn.Linear(1, 100), torch.nn.Sigmoid(),
        torch.nn.Linear(100, 50), torch.nn.ReLU(),
        torch.nn.Linear(50, N_STATES),
    )
    s = torch.arange(N_STATES)
    transition_table = torch.cat([(2 * s) % N_STATES, (2 * s + 1) % N_STATES]).reshape(
        2, N_STATES).T  # [n_states, 2] predecessor states
    y = torch.randn(words, T)

    def run():
        with torch.no_grad():
            priors = -net(y.reshape(-1, 1)).reshape(words, T, N_STATES)
            in_prob = torch.zeros(words, N_STATES)
            out = torch.zeros(words, T)
            for i in range(T):
                out[:, i] = torch.argmin(in_prob, dim=1) % 2
                trellis = (in_prob + priors[:, i])[:, transition_table]
                in_prob, _ = torch.min(trellis, dim=2)
            return out

    run()  # warm-up
    n_iters, t0 = 3, time.perf_counter()
    for _ in range(n_iters):
        run()
    dt = (time.perf_counter() - t0) / n_iters
    return words * T / dt


def _fence(device: torch.device) -> None:
    """Wait for the device's queued work (CPU tensor ops are synchronous)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_card(device: torch.device, words: int = CARD_WORDS, repeats: int = REPEATS,
                 iters: int = ITERS_PER_REPEAT) -> dict:
    """K1 on `words` x 136 received samples with seeded params: `iters`
    launches between fences, `repeats` times; symbols/s of each repeat."""
    model = viterbinet.init_params(N_STATES, torch.Generator(device=device).manual_seed(0),
                                   device)
    rng = np.random.default_rng(0)
    ys = [torch.as_tensor(rng.normal(size=(words, T)).astype(np.float32), device=device)
          for _ in range(2)]
    fused_viterbinet_detect(model, ys[0])  # the first call builds and loads the kernel
    _fence(device)

    def once() -> float:
        t0 = time.perf_counter()
        for i in range(iters):
            fused_viterbinet_detect(model, ys[i % len(ys)])
        _fence(device)
        return words * T * iters / (time.perf_counter() - t0)

    vals = sorted(once() for _ in range(repeats))
    median = vals[len(vals) // 2]
    return {"median": median, "best": vals[-1], "worst": vals[0],
            "spread_pct": round(100 * (vals[-1] - vals[0]) / median, 1)}


def measure_e2e_eval(device: torch.device, val_frames: int = E2E_FRAMES,
                     repeats: int = E2E_REPEATS) -> dict:
    """The aggregated coded-BER eval of the full-CSI VA through the Trainer
    (datagen, K2 detect, RS decode on the device, scoring): one point at
    10 dB through single_eval_at_point, and the 7..12 dB sweep through
    sweep_eval_fused, each `repeats` times after a warm-up. Both return
    host numbers, which waits for the device."""
    with open(REFERENCE_RUNTIME) as f:
        ref = json.load(f)["reference_runtime"]["va_eval_1000_words_coded_s"]
    base = dict(use_ecc=True, n_symbols=2, val_block_length=120, val_frames=val_frames,
                eval_mode="aggregated")
    with tempfile.TemporaryDirectory() as weights_dir:
        cfg = Config(val_SNR_start=10.0, val_SNR_end=10.0, **base)
        t = Trainer(cfg, "va", device=device, weights_dir=weights_dir, verbose=False)
        t.single_eval_at_point(None, 10.0, cfg.gamma)  # warm-up
        words = cfg.n_words("val")
        t0 = time.perf_counter()
        for _ in range(repeats):
            t.single_eval_at_point(None, 10.0, cfg.gamma)
        per_1000 = (time.perf_counter() - t0) / repeats / words * 1000.0

        sweep_cfg = Config(val_SNR_start=7.0, val_SNR_end=12.0, **base)
        ts = Trainer(sweep_cfg, "va", device=device, weights_dir=weights_dir, verbose=False)
        snrs = [float(s) for s in sweep_cfg.snr_range("val")]
        no_params = [None] * len(snrs)
        ts.sweep_eval_fused(snrs, no_params)  # warm-up
        before = fused_va_detect.launches
        t0 = time.perf_counter()
        for _ in range(repeats):
            ts.sweep_eval_fused(snrs, no_params)
        sweep_per_1000 = (time.perf_counter() - t0) / repeats / (words * len(snrs)) * 1000.0
        sweep_launches = (fused_va_detect.launches - before) // repeats
    return {"seconds_per_1000_words": round(per_1000, 4),
            "vs_reference_cpu": round(ref / per_1000, 1),
            "includes": "datagen+detect+on-device-RS-decode+scoring",
            "words_per_eval": words, "repeats": repeats,
            "sweep": {
                "seconds_per_1000_words": round(sweep_per_1000, 4),
                "vs_reference_cpu": round(ref / sweep_per_1000, 1),
                "snr_points": len(snrs), "words_per_sweep": words * len(snrs),
                "va_kernel_launches": sweep_launches, "repeats": repeats,
            }}


def device_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them; for the
    CPU, the word cpu."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def main(device: str | torch.device = "cuda", words: int = CARD_WORDS, repeats: int = REPEATS,
         iters: int = ITERS_PER_REPEAT, ref_words: int = REF_WORDS,
         val_frames: int = E2E_FRAMES, e2e_repeats: int = E2E_REPEATS) -> dict:
    """Run the benchmark on `device` and print its two lines; returns the
    JSON line's object. Any failure raises: there is no retry."""
    device = resolve_device(device)
    with open(BASELINE_CACHE) as f:
        cached = json.load(f)["symbols_per_sec"]
    cpu_reference = measure_cpu_reference(ref_words)
    k1_before, k2_before = fused_viterbinet_detect.launches, fused_va_detect.launches
    stats = measure_card(device, words, repeats, iters)
    e2e = measure_e2e_eval(device, val_frames, e2e_repeats)
    sync = ("torch.cuda.synchronize()" if device.type == "cuda"
            else "none: CPU tensor ops are synchronous")
    line = {
        "metric": "viterbinet_decoded_symbols_per_sec_per_chip",
        "value": round(stats["median"], 1),
        "unit": "symbols/s",
        "vs_baseline": round(stats["median"] / cpu_reference, 2),
        "best": round(stats["best"], 1),
        "worst": round(stats["worst"], 1),
        "spread_pct": stats["spread_pct"],
        "methodology": {
            "stat": "median over repeats (best/worst alongside)",
            "repeats": repeats,
            "dispatches_per_sync": iters,
            "batch_words": words,
            "sync": sync,
            "kernel": "fused_viterbinet_detect (K1)" if device.type == "cuda"
                      else "fused_viterbinet_detect_plain (K1's plain version, CPU tensors)",
            "baseline": f"the reference loop on this host's CPU at {ref_words} words, "
                        "measured in this run",
        },
        "e2e_eval": e2e,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "cpu_reference_symbols_per_sec": round(cpu_reference, 1),
        "cached_baseline_cpu": {
            "symbols_per_sec": cached,
            "vs": round(stats["median"] / cached, 2),
            "source": "resources/baseline_cpu.json, measured on another machine's CPU",
        },
        "launches": {"fused_viterbinet_detect": fused_viterbinet_detect.launches - k1_before,
                     "fused_va_detect": fused_va_detect.launches - k2_before},
    }
    print(device_line(device))
    print(json.dumps(line))
    return line
