"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, each of which fails the run on error:
  1. card     print the card's name and power limit (nvidia-smi);
  2. build    compile the five CUDA kernels from
              metaviterbinet_tpu_torch/kernels/csrc (one nvcc per source,
              started together);
  3. kernels  hold each kernel against its plain PyTorch version on the card:
              K1 (ViterbiNet detect, < 1e-3 bit mismatch) and K2 (VA detect,
              bit-identical) at 4096 and 1000 words x 136 and 41 steps and at
              the aggregated path's 300 x 136, K2 at the VA engine's 1 x 136,
              both at S = 2, 4, 8, 16 at 300 x 136 with two launches from the
              same inputs bit-identical, and one tensor-core tile of K1's
              priors against the plain version's; K4 (K1 over overlap-save time
              chunks, overlap 32, < 1e-3) at 300 x 136 with 2 and 4 chunks,
              4096 x 136 with 4 and 1000 x 136 with 2, two launches
              bit-identical, and bit-identical to K1 (trained params) on
              channel words at 300 x 136 with 2 and 4 chunks; K5 (ACS over
              priors from the f32 MLP, bit-identical) at the engine's
              1 x 136, 300 x 136 and 4096 x 41; K6 (fused
              online Adam) at T = 136 from the same params and moments: 40
              steps, a resumed second call of 40, and the protocol's 200
              steps on nine received words; and two K6 launches from the same
              inputs, bit-identical;
  4. slice    the aggregated coded-BER eval at the protocol's full width
              (300 words x 136 symbols, RS nsym=2, 4-tap time-decay fading
              channel), each path's launch counts zeroed just before and read
              just after it: VA over 7..12 dB through Trainer.evaluate (the
              fused sweep, bit-equal to a per-SNR loop from the same seeds),
              a ViterbiNet with seeded random params at 10 dB, and one
              trained for one minibatch at 10 dB with eval_time_chunks=4
              (K4) and 0 (K1), with the same coded BER; then
              eval_time_chunks=8 (chunks shorter than the overlap: K1) and
              an overlap below 8 * memory_length (the warning: K1); one VA
              and one ViterbiNet point under torch.profiler for the device's
              busy time; and two anchors of the reference: uncoded VA at
              10 dB and VA on the COST2100 channel at 8 dB;
  5. online   the paper's by-word protocol through Trainer.evaluate: 300
              blocks on the type-2 test channel at 10 dB, in a temporary
              weights directory so that the checkpoint is trained on the
              miss: meta_vnet in meta mode (meta_train, then MAML every 5
              blocks and K6 on every gated block), vnet in joint mode
              (train, then detection only) and va in joint mode (K2 per
              block, nothing trained), each against its recorded
              reference band; launch counts, buffer fill, seconds of
              train-on-miss, of the 300 blocks and of their parts (CUDA
              events), and the device's idle share (torch.profiler, a
              second run over PROFILED_BLOCKS blocks); then the first 25
              meta-mode blocks once on the card and once on the CPU;
  5b. lstm    the LSTM family (2 x 256 LSTM, window 4), which has no kernel,
              in two processes of its own started after phase 4 and run
              beside phases 5-7 (see start_phase_lstm); no path of it may
              launch one of the five kernels. In one process: the
              aggregated point at 10 dB with seeded random params (cuDNN),
              its logits and eval tail on the card against the CPU, and
              under torch.profiler; lstm joint (Trainer.train on the miss,
              25 minibatches) and lstm online (self-supervised autograd
              steps, the same checkpoint) over 300 blocks against their
              reference bands, each also under the profiler
              (PROFILED_BLOCKS); cuDNN's forward against the unrolled one
              with the trained params (bits equal outside a margin of
              1e-4). In the other: meta_lstm's meta_train on the miss (25
              minibatches) and the first 6 blocks of its meta run, through
              the first meta event (second-order MAML steps), on the card
              and on the CPU, with the seconds per step and an estimate of a
              300-block run. Their output is printed after phase 7;
  6. cli      in the vnet weights directory of phase 5: `evaluate` of the
              trained checkpoint, aggregated through K4 (no training), in
              process, against the vnet joint band and against the same
              command unchunked; and `python -m metaviterbinet_tpu_torch
              evaluate --detector va` in a subprocess, against the same eval
              in process;
  7. bf16     Config.dtype='bfloat16': the bf16 logits and the engine detect
              on the card against the CPU, one bf16 word sweep, and no K6;
              the LSTM's bf16 logits on the card against the CPU;
  8. width    time the kernels and their plain versions on the device (a CUDA
              graph of back-to-back calls) and per eager call: K1 and K2 at
              300 x 136 and 65536 x 136, K2 at 1 x 136, K4 at 300 x 136 with
              2 and 4 chunks and 65536 x 136 with 4 (beside K1 at the same
              shape, K1's and K4's SFU floors and K4's chain floor: K5 over
              the chunked chains' (W C) x (overlap + T / C) priors at 300
              words), K5 at 1 x 136 and 300 x 136, K6 at
              T = 136 with 200 steps (with its cluster size, its bound at
              the cluster's share of the card and at one SM's, and its time
              per step);
  9. report   a `{"kernels": [...]}` line, then the card line, then
              `{"ok": true, "device": {...}}` as the last line.

Exits non-zero, printing no result, when no CUDA device is present.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import io
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from metaviterbinet_tpu_torch import Config, cli
from metaviterbinet_tpu_torch.data.dataset import ChannelDataset, generate_words
from metaviterbinet_tpu_torch.ecc.rs import rs_encode_bits
from metaviterbinet_tpu_torch.evaluation.trainer import Trainer
from metaviterbinet_tpu_torch.kernels import acs, online_sgd
from metaviterbinet_tpu_torch.models import lstm, va, viterbinet
from metaviterbinet_tpu_torch.online.engine import Draws, run_online, uses_fused_adaptation
from metaviterbinet_tpu_torch.ops.trellis import calculate_states
from metaviterbinet_tpu_torch.paths import RESOURCES_DIR, ROOT_DIR
from metaviterbinet_tpu_torch.train.losses import select_batch
from metaviterbinet_tpu_torch.train.loop import word_sweep
from metaviterbinet_tpu_torch.train.optim import ADAM_B1, ADAM_B2, ADAM_EPS, Optimizer

SEED = 20260
# H100 SXM published peaks (NVIDIA data sheet, dense): device memory rate,
# bf16 tensor-core rate, f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_TC_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12
N_SMS = 132
# special-function results per clock per SM (an exp, a tanh or a
# reciprocal each) and the boost clock, H100 SXM published figures
SFU_PER_CLOCK_PER_SM, SM_CLOCK_HZ = 16, 1.98e9
VA_BAND = (0.014036, 0.006)  # resources/reference_baselines.json va_full_csi coded_nsym2 10 dB
# resources/reference_baselines.json by_word_campaign_snr10.mean_data_ber, the
# mean of the reference's two seeds, with tests/test_parity_anchor.py's band
META_VNET_BAND = (0.028588, 0.012)
VNET_JOINT_BAND = (0.031814, 0.012)
# va_joint: the VA trains nothing, so only the binomial noise of the 288
# data blocks' bits is in it; the VA's band of VA_BAND
VA_JOINT_BAND = (0.014149, 0.006)
# blocks of the by-word runs under torch.profiler: a whole run where it is
# short, the first blocks where the profiler's record of millions of eager
# launches would take minutes (meta_vnet) or the host's memory (lstm online)
PROFILED_BLOCKS = {"meta_vnet": 50, "vnet": 300, "va": 300, "lstm joint": 300,
                   "lstm online": 5}
# the LSTM family's cells, the same source and band
LSTM_JOINT_BAND = (0.030295, 0.012)
LSTM_ONLINE_BAND = (0.054008, 0.012)
# meta_lstm on the card and on the CPU: the first 6 blocks, through the
# first meta event (at block 5), each block's SER within CARD_CPU_BLOCK_TOL
META_LSTM_BLOCKS = 6
# the LSTM's two f32 forwards (cuDNN's and the unrolled one), and the card
# against the CPU, may detect different bits only where the two class
# logits are within LSTM_MARGIN of each other
LSTM_MARGIN = 1e-4
# meta events of a 300-block meta run (blocks 5, 10, .., 295) and the most
# second-order MAML steps one can take (meta_train_iterations x meta_j_num)
META_EVENTS, MAX_STEPS_PER_EVENT = 59, 200
# torch's CPU threads while phase 5b's two processes run beside phases 5-7:
# two for each of them and four for the main process, on the 8 cores of the
# card's machine (more threads than cores slow every process many times)
CHILD_CPU_THREADS, MAIN_CPU_THREADS_BESIDE_CHILDREN = 2, 4
WIDE_W, PROTO_W, T_PROTO = 65536, 300, 136
K6_ITERS = 200  # Config.self_supervised_iterations, the protocol's
# K6 against its plain version: the JAX kernel's contract (5e-6 after 40
# steps, 2e-5 after resuming for 40 more) and the limit for 200 steps
K6_LIMITS = {"40 steps": 5e-6, "resumed 40 + 40": 2e-5, "200 steps": 1e-4}
K6_WORDS = tuple(range(1, 10))  # data blocks of adapt_inputs' 10 dB batch
# K6's float64 witness (tests/test_torch_cuda.py, scripts/torch_kernel_probe.py):
# after 40 + 40 steps on each (T, seed) word, the kernel's distance from a
# float64 run of the plain version's arithmetic is held within
# K6_WITNESS_MULTIPLE times the f32 plain version's distance plus
# K6_WITNESS_FLOOR (tests/test_torch_kernels.py holds the f32 plain version
# to the JAX kernel's distance on the same words on the CPU). Measured on an
# H100 80GB HBM3 at 700 W (PERF.md section 6): the kernel reads 0.29 to 3.62
# times the plain version's distance; a run with one Adam constant off
# (K6_FAULTS) in its place reads 185 times or more on every witness word
# (scripts/torch_kernel_probe.py). 16 leaves 4.4x room above the first and
# 11x below the second.
K6_WITNESS_WORDS = ((40, 0), (40, 1), (33, 2), (40, 3), (40, 4), (136, 0), (64, 5))
K6_WITNESS_MULTIPLE, K6_WITNESS_FLOOR = 16.0, 1e-6
# faulty f32 runs the witness must reject: the plain version with lr, eps or
# b2 off, which is what a kernel with that constant wrong computes
K6_FAULTS = {"lr 1.0001e-3": {"lr": 1.0001e-3}, "eps 1e-7": {"lr": 1e-3, "eps": 1e-7},
             "b2 0.998": {"lr": 1e-3, "b2": 0.998}}
CARD_CPU_BLOCKS = 25
# card against CPU over the first 25 meta-mode blocks: each block's SER
# within two of its 120 bits, the mean over the data blocks within 2e-3
CARD_CPU_BLOCK_TOL, CARD_CPU_MEAN_TOL = 2.0 / 120, 2e-3
KERNELS = ("fused_viterbinet_detect", "fused_va_detect", "fused_viterbinet_detect_chunked",
           "viterbi_decode_kernel", "online_adapt_viterbinet")
OVERLAP = 32  # Config.decode_overlap
# the anchors' bands (tests/test_parity_anchor.py:22-30, :65-84)
UNCODED_VA_TOL, COST2100_VA_TOL = 0.006, 0.005
# bf16 logits on the card against the CPU: within 0.03 of max(1, |logit|),
# about four bf16 ulps at the largest logit (cuBLAS and the CPU may round
# a bf16 product apart, and an h2 that differs by one ulp moves the logits)
BF16_LOGIT_TOL = 0.03


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def wrapper(name: str):
    return getattr(online_sgd if name == "online_adapt_viterbinet" else acs, name)


def zero_launches() -> None:
    for name in KERNELS:
        wrapper(name).launches = 0


def read_launches() -> dict:
    return {name: wrapper(name).launches for name in KERNELS}


def _event_ms(fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def call_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median time of one eager call of fn() between CUDA events: the
    device's work plus whatever host work the call puts in front of it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return float(np.median([_event_ms(fn) for _ in range(reps)]))


def graph_ms(fn, per_graph: int = 20, replays: int = 10) -> float:
    """Device time of one fn() with no host work between launches: fn is
    captured `per_graph` times back to back into one CUDA graph, and the
    median replay time between CUDA events is divided by `per_graph`."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = float(np.median([_event_ms(graph.replay) for _ in range(replays)])) / per_graph
    del graph
    torch.cuda.empty_cache()
    return ms


def device_busy(fn) -> dict:
    """Run fn() once under torch.profiler (device activity only); return the
    host-clock wall time, the union of the device's activity intervals, and
    their count (kernels, copies, fills). The profiler's own host cost
    lengthens the wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA)
    busy_ns, end = 0, -1
    for a, b in spans:
        if b > end:
            busy_ns += b - max(a, end)
            end = b
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ns / 1e6, "device_activities": len(spans),
            "idle_share": (1 - busy_ns / 1e6 / wall_ms) if spans else None}


def busy_line(what: str, b: dict) -> str:
    if b["device_activities"] == 0:
        return (f"{what} under torch.profiler: {b['wall_ms']:.3f} ms wall; device time not "
                "measured (the profiler saw no device activity)")
    return (f"{what} under torch.profiler: {b['wall_ms']:.3f} ms wall, device busy "
            f"{b['device_busy_ms']:.3f} ms over {b['device_activities']} activities, "
            f"idle share {b['idle_share']:.4f}")


class CudaSpans:
    """`spans` for the online engine: per named part, CUDA events on the
    device timeline and the host clock, summed per name after the run."""

    def __init__(self):
        self.events: dict[str, list] = {}
        self.host_s: dict[str, float] = {}

    def __call__(self, name: str):
        spans = self

        class _Span:
            def __enter__(self):
                self.pair = (torch.cuda.Event(enable_timing=True),
                             torch.cuda.Event(enable_timing=True))
                self.pair[0].record()
                self.t0 = time.perf_counter()

            def __exit__(self, *exc):
                spans.host_s[name] = spans.host_s.get(name, 0.0) + time.perf_counter() - self.t0
                self.pair[1].record()
                spans.events.setdefault(name, []).append(self.pair)

        return _Span()

    def seconds(self) -> dict:
        """name -> (count, seconds on the device timeline, seconds on the host)."""
        torch.cuda.synchronize()
        return {name: (len(pairs), sum(a.elapsed_time(b) for a, b in pairs) / 1e3,
                       self.host_s[name]) for name, pairs in self.events.items()}


# --------------------------------------------------------------- bounds

def va_bound_ms(W: int, T: int, S: int) -> tuple[float, str]:
    """Least time for fused_va_detect: y, mu in and bits out once, against
    per symbol 4 S prior ops (sub, mul, mul, sub) and 3.5 S ACS ops (S adds,
    S/2 pair mins, S/2 renorm mins, S/2 renorm subtracts, S readout
    compares), all f32."""
    t_bytes = 4.0 * (2 * W * T + W * S) / HBM_BYTES_PER_S
    t_ops = W * T * 7.5 * S / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def vnet_bound_ms(W: int, T: int, S: int, n_computed: int | None = None) -> tuple[float, str]:
    """Least time for fused_viterbinet_detect: y in and bits out once (plus
    the weights), against the two products with bf16 operands at the bf16
    tensor-core rate plus the f32 elementwise work per symbol: w1*y+b1 (200),
    sigmoid as neg, exp, add, divide (400), b2 and relu (100), b3 (S), and
    the 3.5 S ACS ops. `n_computed` symbols go through the MLP and the ACS
    (W * T unless given)."""
    n = W * T
    m = n if n_computed is None else n_computed
    weight_bytes = 4 * (3 * viterbinet.HIDDEN1 + viterbinet.HIDDEN2 * (viterbinet.HIDDEN1 + 1 + S) + S)
    t_bytes = (4.0 * 2 * n + weight_bytes) / HBM_BYTES_PER_S
    mm_flops = 2.0 * m * (viterbinet.HIDDEN1 * viterbinet.HIDDEN2 + viterbinet.HIDDEN2 * S)
    elem_ops = m * (200 + 400 + 100 + S + 3.5 * S)
    t_ops = mm_flops / BF16_TC_FLOP_PER_S + elem_ops / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def chunked_symbols(W: int, T: int, C: int) -> int:
    """Symbols K4 runs through the MLP and the ACS: each chunk but the
    stream-head one also warms up on OVERLAP symbols (the head chunk skips
    its warm-up, see csrc/viterbinet_detect_chunked.cu)."""
    return W * (T + (C - 1) * OVERLAP)


def chunked_bound_ms(W: int, T: int, C: int, S: int) -> tuple[float, str]:
    """Least time for fused_viterbinet_detect_chunked: vnet_bound_ms over
    the chunked_symbols count, y read and bits written once."""
    return vnet_bound_ms(W, T, S, chunked_symbols(W, T, C))


def sfu_floor_ms(n_symbols: int) -> float:
    """Least time for the 100 first-layer sigmoids of n symbols at one
    special-function result each (K1's and K4's tanh.approx), on every SM
    of the card at the published rate: a floor of the MLP, not measured."""
    return 1e3 * n_symbols * viterbinet.HIDDEN1 / (SFU_PER_CLOCK_PER_SM * N_SMS * SM_CLOCK_HZ)


def decode_bound_ms(W: int, T: int, S: int) -> tuple[float, str]:
    """Least time for viterbi_decode_kernel: the priors in and the bits out
    once, against the 3.5 S f32 ACS ops per symbol."""
    t_bytes = 4.0 * (W * T * S + W * T) / HBM_BYTES_PER_S
    t_ops = W * T * 3.5 * S / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def adapt_ops(T: int, S: int, n_iters: int) -> float:
    """f32 operations of n fused Adam steps of CE over states on T symbols:
    per step the forward (w1 y + b1 and the sigmoid 6 x 100, W2 h1 2 x 50 x
    100, b2 + relu 2 x 50, W3 h2 2 x S x 50, b3 S), the softmax and its
    gradient (7 S), the backward (dW3 and dh2 2 x S x 50 each, the relu mask
    50, dW2 and dh1 2 x 50 x 100 each, db2 50, dz1 3 x 100, dw1 2 x 100, db1
    100, db3 S) per symbol, and Adam's ~14 operations per parameter."""
    H1, H2 = viterbinet.HIDDEN1, viterbinet.HIDDEN2
    per_symbol = (6 * H1 + 2 * H2 * H1 + 2 * H2 + 2 * S * H2 + S + 7 * S
                  + 2 * S * H2 + S + 2 * S * H2 + H2 + 2 * 2 * H2 * H1 + H2
                  + 3 * H1 + 2 * H1 + H1)
    n_params = H1 * 2 + H2 * (H1 + 1) + S * (H2 + 1)
    return n_iters * (per_symbol * T + 14 * n_params)


def adapt_bound_ms(T: int, S: int, n_iters: int) -> tuple[float, str]:
    """Least time for online_adapt_viterbinet: y and the states in once, the
    params and both moments in and out once, against adapt_ops at the f32
    rate."""
    n_params = viterbinet.HIDDEN1 * 2 + viterbinet.HIDDEN2 * (viterbinet.HIDDEN1 + 1) + S * (viterbinet.HIDDEN2 + 1)
    t_bytes = 4.0 * (2 * T + 6 * n_params) / HBM_BYTES_PER_S
    t_ops = adapt_ops(T, S, n_iters) / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# --------------------------------------------------------------- inputs

def kernel_inputs(W: int, T: int, gen: torch.Generator, S: int = 16):
    """Received samples of random BPSK words through per-word jittered
    time-decay taps at 10 dB, and those taps' state means."""
    L = S.bit_length() - 1
    dev = "cuda"
    h = torch.exp(-0.2 * torch.arange(L, device=dev)) * (
        1 + 0.1 * torch.randn((W, L), generator=gen, device=dev))
    s = 1 - 2 * torch.randint(0, 2, (W, T + L), generator=gen, device=dev).float()
    conv = sum(h[:, L - 1 - i, None] * s[:, i:T + i] for i in range(L))
    y = (conv + 10 ** -0.5 * torch.randn((W, T), generator=gen, device=dev)).contiguous()
    return y, va.state_means(h).contiguous()


def mlp_priors(model: viterbinet.ViterbiNet, y: torch.Tensor) -> torch.Tensor:
    """The engine's K5 input: negated f32 logits of the MLP."""
    with torch.no_grad():
        return (-viterbinet.score(model, y)).contiguous()


def adapt_inputs(word: int = 1):
    """An engine-shaped K6 input, made on the CPU from seeds and moved to the
    card: block `word` of the 10 dB type-2 test channel, its own trellis
    states (the re-encoded word), and seeded params."""
    cfg = Config(val_frames=1, fading_taps_type=2)
    tx, rx = ChannelDataset(cfg, "val", "cpu").get(10.0, cfg.gamma)
    states = calculate_states(cfg.memory_length, rs_encode_bits(tx[word:word + 1], cfg.n_symbols))
    model = viterbinet.init_params(16, torch.Generator().manual_seed(SEED), device="cpu")
    params = {k: v.detach().cuda() for k, v in viterbinet.param_dict(model).items()}
    return params, rx[word].contiguous().cuda(), states.cuda()


def k6_witness_word(T: int, seed: int, device: str = "cuda"):
    """A K6 input made on the CPU from `seed`: the port's init_params from a
    torch generator, y ~ N(0, 1) and random bits' trellis states from numpy;
    moved to `device`. Returns (params, y, states)."""
    model = viterbinet.init_params(16, torch.Generator().manual_seed(seed), device="cpu")
    rng = np.random.default_rng(seed)
    y = torch.tensor(rng.normal(size=T).astype(np.float32))
    bits = torch.tensor(rng.integers(0, 2, size=(1, T)).astype(np.float32))
    params = {k: v.detach().to(device) for k, v in viterbinet.param_dict(model).items()}
    return params, y.to(device), calculate_states(4, bits).to(device)


def k6_witness(params: dict, y, states, steps=(40, 40), fault: dict | None = None) -> dict:
    """K6, its f32 plain version and a float64 run of the plain version's
    arithmetic from the same params and zero moments, called once per entry
    of `steps`; returns max |dparam| between each pair after the last call.
    With `fault` (an entry of K6_FAULTS), the f32 plain version with those
    arguments stands where K6 stood."""
    opt = Optimizer("Adam", 1e-3)
    runs = {}
    for name, dtype in (("kernel", torch.float32), ("plain", torch.float32), ("f64", torch.float64)):
        p = {k: v.detach().to(dtype=dtype, copy=True) for k, v in params.items()}
        runs[name] = (p, opt.init(p))
    for n in steps:
        if fault is None:
            online_sgd.online_adapt_viterbinet(*runs["kernel"], y, states, n, 1e-3)
        else:
            online_sgd.online_adapt_viterbinet_plain(*runs["kernel"], y, states, n, **fault)
        online_sgd.online_adapt_viterbinet_plain(*runs["plain"], y, states, n, 1e-3)
        online_sgd.online_adapt_viterbinet_plain(*runs["f64"], y.double(), states, n, 1e-3)

    def dist(a, b):
        return max(float((runs[a][0][k].double() - runs[b][0][k].double()).abs().max())
                   for k in params)

    return {"kernel_f64": dist("kernel", "f64"), "plain_f64": dist("plain", "f64"),
            "kernel_plain": dist("kernel", "plain")}


def witness_holds(d: dict) -> bool:
    return d["kernel_f64"] <= K6_WITNESS_MULTIPLE * d["plain_f64"] + K6_WITNESS_FLOOR


def _copy_state(params: dict, state):
    p = {k: v.clone() for k, v in params.items()}
    s = copy.copy(state)
    s.mu = {k: v.clone() for k, v in state.mu.items()}
    s.nu = {k: v.clone() for k, v in state.nu.items()}
    return p, s


def _max_diff(a: dict, b: dict) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in a)


# --------------------------------------------------------------- phases

def phase_build() -> None:
    seconds = acs.build_kernels()
    for name, s in seconds.items():
        print(f"build {name}: {s:.1f} s")
        for line in acs.build_reports[name].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    # K1's and K4's products run on the tensor cores: wgmma is HGMMA in SASS
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name in ("viterbinet_detect", "viterbinet_detect_chunked"):
        sass = subprocess.run([tool, "-sass", str(acs.library_path(name))], capture_output=True,
                              text=True, check=True, timeout=120).stdout
        n = sass.count("HGMMA")
        print(f"{name}: {n} HGMMA (wgmma) instructions in its SASS")
        if n == 0:
            fail(f"{name}: no tensor-core instruction in its SASS")


KERNEL_CHECK_SHAPES = ((4096, T_PROTO), (4096, 41), (1000, T_PROTO), (1000, 41), (PROTO_W, T_PROTO))
# (W, T, chunks) of K4 against its plain version, and the chunk counts at
# which it must give K1's bits on the protocol's channel words
CHUNKED_CHECK_SHAPES = ((PROTO_W, T_PROTO, 2), (PROTO_W, T_PROTO, 4), (4096, T_PROTO, 4),
                        (1000, T_PROTO, 2))
CHUNKS_EQUAL_TO_K1 = (2, 4)
DECODE_CHECK_SHAPES = ((1, T_PROTO), (PROTO_W, T_PROTO), (4096, 41))
STATES = (2, 4, 8, 16)
# one tensor-core tile of K1's priors against the plain version's (TF32
# off): bf16 operands with f32 sums in another order, and an h1 whose
# sigmoid lands near a bf16 rounding boundary may round the other way
# (tanh.approx, csrc/viterbinet_mlp.cuh), which moves a prior by about one
# bf16 ulp of h1 times weights of W2 and W3; measured up to 3.1e-4 on an
# H100 (PERF.md)
TILE_TOL = 5e-3


def check_bits(name: str, W: int, T: int, got, want, limit: float,
               against: str = "the plain version") -> dict:
    torch.cuda.synchronize()
    if got.shape != (W, T) or not bool(((got == 0) | (got == 1)).all()):
        fail(f"{name} {W}x{T}: output is not a [W, T] tensor of bits")
    err = float((got - want).abs().max())
    rate = float((got != want).float().mean())
    print(f"{name} {W}x{T}: bit mismatch {rate:.3e} vs {against} "
          f"(limit {'bit-identical' if limit == 0 else f'< {limit:g}'})")
    if rate > limit or (limit > 0 and rate >= limit):
        fail(f"{name} {W}x{T}: mismatch {rate} against {against}")
    return {"max_abs_err": err, "bit_mismatch_rate": rate}


def channel_words(W: int, gen: torch.Generator) -> torch.Tensor:
    """The protocol's words (120 info bits, RS nsym=2) through the 4-tap
    time-decay fading channel at 10 dB: W x 136 received samples."""
    return generate_words(10.0, 0.2, n_words=W, block_length=120, memory_length=4, use_ecc=True,
                          n_symbols=2, channel_coefficients="time_decay", fading=True,
                          fading_taps_type=1, device="cuda", word_generator=gen,
                          noise_generator=gen)[1].contiguous()


def trained_vnet(weights_dir: str) -> viterbinet.ViterbiNet:
    """A ViterbiNet after one training minibatch (a sweep over 300 words of
    the train channel at 10 dB). K4 gives K1's bits only where the trellis
    forgets its start within the warm-up, which needs informative priors:
    with untrained random params it may not, and one minibatch is enough
    (tests/test_torch_kernels.py, on the CPU)."""
    cfg = Config(train_minibatch_num=1, weights_dir=weights_dir)
    return Trainer(cfg, "vnet", verbose=False).train()


def phase_kernels(model: viterbinet.ViterbiNet, trained: viterbinet.ViterbiNet,
                  gen: torch.Generator) -> dict:
    """Each kernel against its plain version on the card. Returns, per
    (kernel, W, T), the largest |kernel - plain| over the outputs (and the
    bit mismatch rate of the detect kernels)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("plain versions' f32 matmuls: torch.backends.cuda.matmul.allow_tf32 = False")
    checks = {}
    for W, T in KERNEL_CHECK_SHAPES:
        y, mu = kernel_inputs(W, T, gen)
        checks[("fused_va_detect", W, T)] = check_bits(
            "fused_va_detect", W, T, acs.fused_va_detect(y, mu),
            acs.fused_va_detect_plain(y, mu), 0.0)
        checks[("fused_viterbinet_detect", W, T)] = check_bits(
            "fused_viterbinet_detect", W, T, acs.fused_viterbinet_detect(model, y),
            acs.fused_viterbinet_detect_plain(model, y), 1e-3)
    # K2 at the VA engine's one word per block
    y, mu = kernel_inputs(1, T_PROTO, gen)
    checks[("fused_va_detect", 1, T_PROTO)] = check_bits(
        "fused_va_detect", 1, T_PROTO, acs.fused_va_detect(y, mu),
        acs.fused_va_detect_plain(y, mu), 0.0)
    # K1 and K2 at every S at the protocol's shape, two launches of each
    # bit-identical (the ring's hand-off), and one tensor-core tile of K1's
    # priors against the plain version's
    for S in STATES:
        net = viterbinet.init_params(S, gen, device="cuda")
        y, mu = kernel_inputs(PROTO_W, T_PROTO, gen, S)
        for name, run, plain, limit in (
                ("fused_va_detect", lambda: acs.fused_va_detect(y, mu),
                 lambda: acs.fused_va_detect_plain(y, mu), 0.0),
                ("fused_viterbinet_detect", lambda: acs.fused_viterbinet_detect(net, y),
                 lambda: acs.fused_viterbinet_detect_plain(net, y), 1e-3)):
            got = run()
            checks[(name, "S", S)] = check_bits(f"{name} S={S}", PROTO_W, T_PROTO, got, plain(),
                                                limit)
            check_bits(f"{name} S={S}", PROTO_W, T_PROTO, run(), got, 0.0,
                       against="a second launch from the same inputs")
        y64 = 2 * torch.randn(64, generator=gen, device="cuda")
        tile = acs.viterbinet_tile_priors(net, y64)
        tile_err = float((tile - acs._bf16_priors(net, y64[None]).reshape(64, S)).abs().max())
        print(f"viterbinet_tile_priors S={S}: one tensor-core tile's priors max |diff| "
              f"{tile_err:.3e} vs the plain version (limit {TILE_TOL:g})")
        if not tile_err <= TILE_TOL:
            fail(f"viterbinet_tile_priors S={S}: {tile_err} against the plain version")
        checks[("tile", S)] = tile_err
    name = "fused_viterbinet_detect_chunked"
    for W, T, C in CHUNKED_CHECK_SHAPES:
        y = kernel_inputs(W, T, gen)[0]
        got = acs.fused_viterbinet_detect_chunked(model, y, C)
        checks[(name, W, T, C)] = check_bits(
            f"{name} C={C} overlap={OVERLAP}", W, T, got,
            acs.fused_viterbinet_detect_chunked_plain(model, y, C), 1e-3)
        check_bits(f"{name} C={C} overlap={OVERLAP}", W, T,
                   acs.fused_viterbinet_detect_chunked(model, y, C), got, 0.0,
                   against="a second launch from the same inputs")
    y = channel_words(PROTO_W, gen)
    k1_bits = acs.fused_viterbinet_detect(trained, y)
    for C in CHUNKS_EQUAL_TO_K1:
        checks[(name, "k1", C)] = check_bits(
            f"{name} C={C} overlap={OVERLAP} (trained params) on channel words", PROTO_W, T_PROTO,
            acs.fused_viterbinet_detect_chunked(trained, y, C), k1_bits, 0.0,
            against="K1 (fused_viterbinet_detect) on the card")
    for W, T in DECODE_CHECK_SHAPES:
        priors = mlp_priors(model, kernel_inputs(W, T, gen)[0])
        checks[("viterbi_decode_kernel", W, T)] = check_bits(
            "viterbi_decode_kernel", W, T, acs.viterbi_decode_kernel(priors),
            acs.viterbi_decode_kernel_plain(priors), 0.0)

    # K6: kernel and plain version from the same params and zero moments
    params, y, states = adapt_inputs(1)
    state = Optimizer("Adam", 1e-3).init(params)
    (pk, sk), (pp, sp) = _copy_state(params, state), _copy_state(params, state)
    errs = {}
    for label, n in (("40 steps", 40), ("resumed 40 + 40", 40)):
        online_sgd.online_adapt_viterbinet(pk, sk, y, states, n, 1e-3)
        online_sgd.online_adapt_viterbinet_plain(pp, sp, y, states, n, 1e-3)
        errs[label] = _max_diff(pk, pp)
    if (sk.count, sp.count) != (80, 80):
        fail(f"online_adapt_viterbinet: step counts {sk.count}, {sp.count}")
    # two launches from the same inputs give the same bits: the cluster sums
    # its partial gradients in a fixed order, with no atomics
    (pa, sa), (pb, sb) = _copy_state(params, state), _copy_state(params, state)
    for p, s in ((pa, sa), (pb, sb)):
        online_sgd.online_adapt_viterbinet(p, s, y, states, 40, 1e-3)
    same = all(torch.equal(a[k], b[k]) for a, b in ((pa, pb), (sa.mu, sb.mu), (sa.nu, sb.nu))
               for k in pa)
    print(f"online_adapt_viterbinet T={T_PROTO}: two launches from the same inputs "
          f"bit-identical {same}")
    if not same:
        fail("online_adapt_viterbinet: two launches from the same inputs differ")
    # the protocol's 200 steps on each of words 1..9: Adam on one word
    # amplifies rounding differences once its fit saturates, so how far two
    # f32 summation orders drift apart depends on the word; the median over
    # the nine is held to the limit, and every word is printed
    per_word, resumed = [], None
    for word in K6_WORDS:
        params_w, y_w, states_w = adapt_inputs(word)
        state_w = Optimizer("Adam", 1e-3).init(params_w)
        (pk, sk), (pp, sp) = _copy_state(params_w, state_w), _copy_state(params_w, state_w)
        online_sgd.online_adapt_viterbinet(pk, sk, y_w, states_w, K6_ITERS, 1e-3)
        online_sgd.online_adapt_viterbinet_plain(pp, sp, y_w, states_w, K6_ITERS, 1e-3)
        per_word.append(_max_diff(pk, pp))
        if resumed is None:  # recorded, not held to a limit: 200 more steps
            online_sgd.online_adapt_viterbinet(pk, sk, y_w, states_w, K6_ITERS, 1e-3)
            online_sgd.online_adapt_viterbinet_plain(pp, sp, y_w, states_w, K6_ITERS, 1e-3)
            resumed = _max_diff(pk, pp)
    errs["200 steps"] = float(np.median(per_word))
    for label, err in errs.items():
        print(f"online_adapt_viterbinet T={T_PROTO}, {label}: max |dparam| {err:.3e} vs the "
              f"plain version (limit {K6_LIMITS[label]:g}"
              f"{'; median over words 1..9' if label == '200 steps' else ''})")
        if not err <= K6_LIMITS[label]:
            fail(f"online_adapt_viterbinet {label}: {err} against its plain version")
    drift = {"200 steps, words 1..9": per_word, "word 1, resumed 200 + 200": resumed}
    print(f"online_adapt_viterbinet drift: {drift}")
    checks[("online_adapt_viterbinet", 1, T_PROTO)] = {"max_abs_err": errs["200 steps"],
                                                        "by_check": errs, "drift": drift}
    return checks


def phase_slice(model: viterbinet.ViterbiNet, trained: viterbinet.ViterbiNet) -> dict:
    cfg = Config(val_frames=12, val_SNR_start=7.0, val_SNR_end=12.0)
    va_trainer = Trainer(cfg, "va", verbose=False)
    vnet_cfg = cfg.replace(val_SNR_start=10.0, val_SNR_end=10.0)
    vnet_trainer = Trainer(vnet_cfg, "vnet", params=model, verbose=False)
    # the chunked point and its unchunked twin with trained params (see
    # trained_vnet), on the same batch
    chunked_cfg = vnet_cfg.replace(eval_time_chunks=4)
    chunked_trainer = Trainer(chunked_cfg, "vnet", params=trained, verbose=False)
    twin_trainer = Trainer(vnet_cfg, "vnet", params=trained, verbose=False)
    n_words = cfg.n_words("val")
    snrs = [float(s) for s in cfg.snr_range("val")]
    print(f"slice: {n_words} words x {cfg.transmission_length('val')} symbols, "
          f"RS nsym={cfg.n_symbols}, {cfg.memory_length}-tap {cfg.channel_coefficients} channel")

    # warm-up on throwaway trainers (first-call set-up: generators, lookup
    # tables, library load), so that the timed runs below are steady-state
    # and the main-path trainers' streams start fresh
    Trainer(cfg, "va", verbose=False).evaluate()
    Trainer(vnet_cfg, "vnet", params=model, verbose=False).evaluate()
    Trainer(chunked_cfg, "vnet", params=trained, verbose=False).evaluate()

    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sers = va_trainer.evaluate()  # sweep_eval_fused
    torch.cuda.synchronize()
    va_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    vnet_ser = float(vnet_trainer.evaluate()[0])
    torch.cuda.synchronize()
    vnet_s = time.perf_counter() - t0
    launches = read_launches()

    zero_launches()
    t0 = time.perf_counter()
    chunked_ser = float(chunked_trainer.evaluate()[0])
    torch.cuda.synchronize()
    chunked_s = time.perf_counter() - t0
    chunked_launches = read_launches()
    twin_ser = float(twin_trainer.evaluate()[0])

    # the per-SNR loop from the same seeds
    loop_trainer = Trainer(cfg, "va", verbose=False)
    t0 = time.perf_counter()
    loop = np.asarray([loop_trainer.single_eval_at_point(None, snr, cfg.gamma) for snr in snrs])
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0

    for snr, ser in zip(snrs, sers):
        print(f"VA coded BER at {snr:g} dB: {ser:.6f}")
    print(f"VA sweep against the per-SNR loop from the same seeds: sweep {sers.tolist()}, "
          f"loop {loop.tolist()}, bit-equal {np.array_equal(sers, loop)}")
    print(f"vnet (seeded random params) coded BER at 10 dB: {vnet_ser:.6f}")
    print(f"vnet (trained params) coded BER at 10 dB with eval_time_chunks=4 (K4): "
          f"{chunked_ser:.6f}; with eval_time_chunks=0 (K1): {twin_ser:.6f}")
    print(f"aggregated main-path launches: {launches}")
    print(f"chunked vnet point launches: {chunked_launches}")
    va_per_1k = va_s / len(snrs) / n_words * 1000
    loop_per_1k = loop_s / len(snrs) / n_words * 1000
    vnet_per_1k = vnet_s / n_words * 1000
    chunked_per_1k = chunked_s / n_words * 1000
    print(f"VA aggregated eval: {va_per_1k:.6f} s per 1000 words through the fused sweep, "
          f"{loop_per_1k:.6f} through the per-SNR loop (mean of {len(snrs)} points, datagen + "
          f"detect + RS decode + scoring)")
    print(f"vnet aggregated eval: {vnet_per_1k:.6f} s per 1000 words; chunked (K4): "
          f"{chunked_per_1k:.6f}")

    if not np.all(np.isfinite(sers)) or not np.all(np.diff(sers) < 0):
        fail(f"VA coded BER does not fall with SNR: {sers}")
    if not np.array_equal(sers, loop):
        fail(f"the VA sweep {sers} differs from the per-SNR loop {loop}")
    ber10 = sers[snrs.index(10.0)]
    if abs(ber10 - VA_BAND[0]) > VA_BAND[1]:
        fail(f"VA coded BER at 10 dB {ber10} outside {VA_BAND[0]} +- {VA_BAND[1]}")
    if not (np.isfinite(vnet_ser) and 0.0 <= vnet_ser <= 1.0):
        fail(f"vnet coded BER {vnet_ser} is not in [0, 1]")
    if chunked_ser != twin_ser:
        fail(f"chunked vnet coded BER {chunked_ser} differs from the unchunked {twin_ser}")
    if (launches["fused_va_detect"], launches["fused_viterbinet_detect"],
            launches["fused_viterbinet_detect_chunked"]) != (len(snrs), 1, 0):
        fail(f"the aggregated path did not go through the kernels: {launches}")
    if (chunked_launches["fused_viterbinet_detect_chunked"],
            chunked_launches["fused_viterbinet_detect"]) != (1, 0):
        fail(f"the chunked point did not go through K4 alone: {chunked_launches}")

    # chunks shorter than the overlap, and an overlap below the forgetting
    # depth: both take K1
    zero_launches()
    eight_ser = float(Trainer(vnet_cfg.replace(eval_time_chunks=8), "vnet", params=trained,
                              verbose=False).evaluate()[0])
    eight = read_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        shallow = Trainer(chunked_cfg.replace(decode_overlap=16), "vnet", params=trained,
                          verbose=False)
    zero_launches()
    shallow_ser = float(shallow.evaluate()[0])
    shallow_launches = read_launches()
    print(f"eval_time_chunks=8: chunks of {T_PROTO // 8} symbols, shorter than the overlap "
          f"{OVERLAP}, take K1: launches {eight}, coded BER {eight_ser:.6f}")
    print(f"eval_time_chunks=4 with decode_overlap=16: warning "
          f"{[str(w.message) for w in caught]}; launches {shallow_launches}, coded BER "
          f"{shallow_ser:.6f}")
    for what, got in (("eval_time_chunks=8", eight), ("decode_overlap=16", shallow_launches)):
        if (got["fused_viterbinet_detect"], got["fused_viterbinet_detect_chunked"]) != (1, 0):
            fail(f"{what}: expected one K1 launch and no K4, got {got}")
    if not caught or eight_ser != twin_ser or shallow_ser != twin_ser:
        fail("the unchunked routes did not warn or did not give K1's coded BER")

    # the device's share of one point (throwaway trainers, after the counts
    # were read)
    busy = {}
    for name, trainer in (("va", Trainer(vnet_cfg, "va", verbose=False)),
                          ("vnet", Trainer(vnet_cfg, "vnet", params=model, verbose=False)),
                          ("vnet_chunked", Trainer(chunked_cfg, "vnet", params=trained,
                                                   verbose=False))):
        busy[name] = device_busy(
            lambda: trainer.single_eval_at_point(trainer.params, 10.0, cfg.gamma))
        print(busy_line(f"{name} point at 10 dB", busy[name]))

    # the same 10 dB batch through the CUDA path and through the plain CPU path
    cpu_va = Trainer(cfg, "va", device="cpu", verbose=False)
    model_cpu = copy.deepcopy(model).cpu()
    cpu_vnet = Trainer(vnet_cfg, "vnet", device="cpu", params=model_cpu, verbose=False)
    cpu_chunked = Trainer(chunked_cfg, "vnet", device="cpu", params=copy.deepcopy(trained).cpu(),
                          verbose=False)
    tx, rx = va_trainer.val_dataset.get(10.0, cfg.gamma)
    h = va_trainer.decoder_csi(n_words)
    for name, gpu_t, cpu_t, tol in (("va", va_trainer, cpu_va, 1e-4),
                                    ("vnet", vnet_trainer, cpu_vnet, 2e-3),
                                    ("vnet_chunked", chunked_trainer, cpu_chunked, 2e-3)):
        on_card = float(gpu_t.eval_tail(gpu_t.params, tx, rx, h))
        on_cpu = float(cpu_t.eval_tail(cpu_t.params, tx.cpu(), rx.cpu(), h.cpu()))
        print(f"{name} eval tail on one 10 dB batch: card {on_card:.6f}, plain CPU {on_cpu:.6f}")
        if abs(on_card - on_cpu) > tol:
            fail(f"{name} eval tail: card {on_card} vs CPU {on_cpu} differ by more than {tol}")
    return {"launches": launches, "chunked_launches": chunked_launches,
            "va_s_per_1k": va_per_1k, "va_loop_s_per_1k": loop_per_1k,
            "vnet_s_per_1k": vnet_per_1k, "vnet_chunked_s_per_1k": chunked_per_1k,
            "va_ber": [float(s) for s in sers], "vnet_ber_10db": vnet_ser,
            "vnet_trained_ber_10db": {"chunked_4": chunked_ser, "unchunked": twin_ser},
            "busy": busy}


def phase_anchors() -> dict:
    """Two recorded anchors of the reference (tests/test_parity_anchor.py):
    uncoded full-CSI VA at 10 dB, and VA on the COST2100 channel at 8 dB."""
    with open(os.path.join(RESOURCES_DIR, "reference_baselines.json")) as f:
        base = json.load(f)
    cells = {**base.get("r3_parity_matrix", {}).get("cells", {}),
             **base.get("r4_parity_matrix", {}).get("cells", {})}
    out = {}
    for name, ref, tol, cfg, snr in (
            ("uncoded VA 10 dB", base["va_full_csi"]["uncoded"]["points"]["10.0"], UNCODED_VA_TOL,
             Config(use_ecc=False, val_frames=10), 10.0),
            ("COST2100 VA 8 dB", float(np.mean(cells["va_joint_cost2100"]["points"]["8.0"]["ref"])),
             COST2100_VA_TOL, Config(val_frames=12, val_SNR_start=8.0, val_SNR_end=8.0,
                                     channel_coefficients="cost2100", fading_in_channel=False),
             8.0)):
        ours = Trainer(cfg, "va", verbose=False).single_eval_at_point(None, snr, cfg.gamma)
        print(f"anchor {name}: BER {ours:.6f}, reference {ref:.6f} +- {tol}")
        if abs(ours - ref) > tol:
            fail(f"anchor {name}: {ours} outside {ref} +- {tol}")
        out[name] = {"ber": ours, "reference": ref, "band": tol}
    return out


def online_cfg(mode: str, weights_dir: str) -> Config:
    """The by-word protocol of scripts/parity_campaign.py at 10 dB: 300 blocks
    of 120 info bits + RS nsym=2 on the type-2 test channel, train-on-miss
    at the default train size."""
    modes = {"meta": dict(self_supervised=True, online_meta=True, weights_init="last_frame"),
             "online": dict(self_supervised=True, online_meta=False),
             "joint": dict(self_supervised=False, online_meta=False)}
    return Config(eval_mode="by_word", fading_taps_type=2, val_frames=12, use_ecc=True,
                  n_symbols=2, val_SNR_start=10.0, val_SNR_end=10.0, train_SNR_start=10.0,
                  train_SNR_end=10.0, weights_dir=weights_dir, **modes[mode])


def run_by_word(name: str, mode: str, weights_dir: str, band: tuple) -> dict:
    cfg = online_cfg(mode, weights_dir)
    di = cfg.data_indices("val")
    trainer = Trainer(cfg, name, verbose=False)
    trainable = trainer.spec.trainable
    # the user path is trainer.evaluate(), whose first step is this load;
    # on the miss it trains, so its time and launches are read apart (the
    # VA loads nothing)
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if trainable:
        trainer.load_weights(10.0, cfg.gamma)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = read_launches()

    spans = CudaSpans()
    trainer.spans = spans
    zero_launches()
    t0 = time.perf_counter()
    sers = trainer.evaluate()
    torch.cuda.synchronize()
    blocks_s = time.perf_counter() - t0
    launches = read_launches()
    result = trainer.online_result
    parts = spans.seconds()
    mean_ber = float(np.mean(sers[di]))
    print(f"{name} {mode} mode: train-on-miss {train_s:.3f} s (launches {train_launches}); "
          f"300 blocks {blocks_s:.3f} s; parts (count, s on the device timeline from CUDA "
          f"events, s on the host clock): "
          f"{parts}")
    print(f"{name} {mode} mode: buffer fill {result.n_buffer}, {result.n_gated} gated blocks, "
          f"by-word launches {launches}")
    print(f"{name} {mode} mode: mean coded BER over the {len(di)} data blocks at 10 dB "
          f"{mean_ber:.6f} (reference band {band[0]} +- {band[1]})")
    if sers.shape != (cfg.n_words("val"),) or not np.all(np.isfinite(sers)):
        fail(f"{name} {mode}: SER per block is not 300 finite values")
    if abs(mean_ber - band[0]) > band[1]:
        fail(f"{name} {mode}: mean data BER {mean_ber} outside {band[0]} +- {band[1]}")
    # the engine's per-block detect: K5 after the MLP and K6 per gated meta
    # block for the ViterbiNet family, the VA's K2; the LSTM family none
    want = dict.fromkeys(KERNELS, 0)
    want_train = dict.fromkeys(KERNELS, 0)
    if not trainable:
        want["fused_va_detect"] = cfg.n_words("val")
    elif trainer.spec.model is viterbinet:
        want["viterbi_decode_kernel"] = cfg.n_words("val")
        want["online_adapt_viterbinet"] = result.n_gated if mode == "meta" else 0
        want_train["fused_viterbinet_detect"] = cfg.train_minibatch_num  # one eval per minibatch
        if mode == "meta" and result.n_gated == 0:
            fail(f"{name} {mode}: no block was gated, so K6 never ran")
    if launches != want:
        fail(f"{name} {mode}: by-word launches {launches}, expected {want}")
    if train_launches != want_train:
        fail(f"{name} {mode}: train-on-miss launches {train_launches}, expected {want_train}")
    return {"cfg": cfg, "trainer": trainer, "sers": sers, "mean_data_ber": mean_ber,
            "train_s": train_s, "blocks_s": blocks_s, "parts": parts, "launches": launches,
            "train_launches": train_launches, "n_buffer": result.n_buffer,
            "n_gated": result.n_gated}


def profiled_blocks(cell: str, name: str, cfg: Config) -> dict:
    """The device's busy time and idle share over the first
    PROFILED_BLOCKS[cell] blocks of a by-word run of detector `name`, under
    torch.profiler: a fresh trainer on the run's checkpoint, so the first
    val batch of its stream, and its own draws."""
    n = PROFILED_BLOCKS[cell]
    trainer = Trainer(cfg, name, verbose=False)
    params = trainer.load_weights(10.0, cfg.gamma) if trainer.spec.trainable else None
    tx, rx = trainer.val_dataset.get(10.0, cfg.gamma)
    h = trainer.decoder_csi(tx.shape[0])
    busy = device_busy(lambda: run_online(cfg, trainer.spec, params, tx[:n], rx[:n], h[:n],
                                          trainer.draws))
    print(busy_line(f"{cell} {n} by-word blocks (a second run)", busy))
    return dict(busy, blocks=n)


def phase_online(weights_dir: str) -> dict:
    out = {}
    meta = run_by_word("meta_vnet", "meta", f"{weights_dir}/meta_vnet", META_VNET_BAND)
    joint = run_by_word("vnet", "joint", f"{weights_dir}/vnet", VNET_JOINT_BAND)
    va_joint = run_by_word("va", "joint", f"{weights_dir}/va", VA_JOINT_BAND)

    # the device's idle share: a second by-word run of each under the
    # profiler, over PROFILED_BLOCKS of its blocks
    for name, run in (("meta_vnet", meta), ("vnet", joint), ("va", va_joint)):
        run["busy"] = profiled_blocks(name, name, run["cfg"])

    # the first 25 meta-mode blocks on the card and through the CPU plain
    # path, from the same params, blocks and draws
    cfg = meta["cfg"]
    card_t = Trainer(cfg, "meta_vnet", verbose=False)
    params = card_t.load_weights(10.0, cfg.gamma)
    tx, rx = card_t.val_dataset.get(10.0, cfg.gamma)
    h = card_t.decoder_csi(tx.shape[0])
    n = CARD_CPU_BLOCKS
    sers = {}
    for device, p in (("cuda", params), ("cpu", copy.deepcopy(params).cpu())):
        draws = Draws(cfg, card_t.spec, torch.device(device),
                      torch.Generator(device=device).manual_seed(SEED),
                      torch.Generator().manual_seed(SEED))
        t0 = time.perf_counter()
        sers[device] = run_online(cfg, card_t.spec, p, tx[:n].to(device), rx[:n].to(device),
                                  h[:n].to(device), draws).ser_by_word
        print(f"meta_vnet first {n} blocks on {device}: {time.perf_counter() - t0:.2f} s")
    di = np.arange(n)[np.arange(n) % cfg.subframes_in_frame != 0]
    block_diff = float(np.abs(sers["cuda"] - sers["cpu"]).max())
    mean_diff = abs(float(sers["cuda"][di].mean()) - float(sers["cpu"][di].mean()))
    print(f"meta_vnet first {n} blocks, card against CPU: largest per-block SER difference "
          f"{block_diff:.6f} (limit {CARD_CPU_BLOCK_TOL:.6f}), mean data SER difference "
          f"{mean_diff:.6f} (limit {CARD_CPU_MEAN_TOL:g}); card {sers['cuda'].tolist()}, "
          f"CPU {sers['cpu'].tolist()}")
    if block_diff > CARD_CPU_BLOCK_TOL or mean_diff > CARD_CPU_MEAN_TOL:
        fail("meta_vnet: the card and the CPU disagree on the first blocks")
    for name, run in (("meta_vnet_meta", meta), ("vnet_joint", joint), ("va_joint", va_joint)):
        out[name] = {k: v for k, v in run.items() if k not in ("cfg", "trainer", "sers")}
    out["card_vs_cpu"] = {"blocks": n, "max_block_ser_diff": block_diff,
                          "mean_data_ser_diff": mean_diff}
    return out


def bits_outside_margin(a: torch.Tensor, b: torch.Tensor) -> int:
    """Symbols whose detected bit differs between two sets of LSTM logits
    [..., 2] although both forwards put their two class logits at least
    LSTM_MARGIN apart."""
    flip = a.argmax(-1) != b.argmax(-1)
    margin = torch.minimum((a[..., 1] - a[..., 0]).abs(), (b[..., 1] - b[..., 0]).abs())
    return int((flip & (margin >= LSTM_MARGIN)).sum())


def forwards_line(what: str, a: torch.Tensor, b: torch.Tensor) -> dict:
    """Compare two sets of LSTM logits of the same words: print and return
    their largest difference, the bits that differ and those that differ
    outside the margin."""
    a, b = a.float().cpu(), b.float().cpu()
    out = {"max_abs_diff": float((a - b).abs().max()),
           "bits_differ": int((a.argmax(-1) != b.argmax(-1)).sum()),
           "bits_differ_outside_margin": bits_outside_margin(a, b),
           "symbols": a.shape[0] * a.shape[1]}
    print(f"{what}: max |dlogit| {out['max_abs_diff']:.3e}, {out['bits_differ']} of "
          f"{out['symbols']} bits differ, {out['bits_differ_outside_margin']} of them with both "
          f"margins >= {LSTM_MARGIN:g}")
    return out


class CountingDraws(Draws):
    """The engine's draws, counting the MAML steps they make it take: one
    per distinct query draw (the engine deduplicates them)."""
    maml_steps = 0

    def j_hats(self, count, iteration, high):
        j = super().j_hats(count, iteration, high)
        self.maml_steps += len(torch.unique(j))
        return j


def no_launches(what: str, launches: dict) -> None:
    if any(launches.values()):
        fail(f"{what}: an LSTM path launched a ViterbiNet or VA kernel: {launches}")


def in_child(fn, *args) -> tuple:
    """fn(*args) in a worker process of phase 5b, on CHILD_CPU_THREADS of
    torch's CPU threads: its result, what it printed and its seconds."""
    torch.set_num_threads(CHILD_CPU_THREADS)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue(), time.perf_counter() - t0


def start_phase_lstm(pool: concurrent.futures.Executor, weights_dir: str, card: str) -> list:
    """Phase 5b, the LSTM family on the card at full width, in two worker
    processes: the aggregated point and the lstm joint and lstm online cells
    in one, meta_lstm in the other. No path of it may launch one of the five
    kernels (each process counts its own launches). Each is a host-bound
    loop of eager launches on one core that leaves the card idle most of the
    time; one after another, after phase 5, they took 811 s of a 1028 s run
    on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 5), and a host at
    half that speed would take the time limit. So they run beside phases 5-7 and the main process
    waits for them before phase 8 times the kernels."""
    return [pool.submit(in_child, lstm_cells, weights_dir, card),
            pool.submit(in_child, meta_lstm_cell, f"{weights_dir}/meta_lstm", card)]


def finish_phase_lstm(jobs: list) -> dict:
    """Wait for phase 5b's processes and print what they printed."""
    (cells, cells_text, cells_s), (meta, meta_text, meta_s) = (job.result() for job in jobs)
    print("lstm (phase 5b, two processes beside phases 5-7):")
    print(cells_text + meta_text, end="")
    print(f"lstm cells process {cells_s:.1f} s, meta_lstm process {meta_s:.1f} s")
    return dict(cells, meta_lstm=meta, process_seconds={"cells": cells_s, "meta_lstm": meta_s})


def lstm_cells(weights_dir: str, card: str) -> dict:
    """The aggregated point and the lstm joint and lstm online cells."""
    out = {}
    # the aggregated eval at 10 dB with seeded random params
    cfg = Config(val_frames=12)
    model = lstm.init_params(torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    Trainer(cfg, "lstm", params=model, verbose=False).evaluate()  # warm-up: cuDNN's set-up
    trainer = Trainer(cfg, "lstm", params=model, verbose=False)
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ber = float(trainer.evaluate()[0])
    torch.cuda.synchronize()
    point_s = time.perf_counter() - t0
    point_launches = read_launches()
    no_launches("lstm aggregated point", point_launches)
    if not (np.isfinite(ber) and 0.0 <= ber <= 1.0):
        fail(f"lstm coded BER {ber} is not in [0, 1]")
    cpu_trainer = Trainer(cfg, "lstm", device="cpu", params=copy.deepcopy(model).cpu(),
                          verbose=False)
    tx, rx = trainer.val_dataset.get(10.0, cfg.gamma)
    h = trainer.decoder_csi(tx.shape[0])
    zero_launches()
    on_card = float(trainer.eval_tail(model, tx, rx, h))
    no_launches("lstm eval tail", read_launches())
    on_cpu = float(cpu_trainer.eval_tail(cpu_trainer.params, tx.cpu(), rx.cpu(), h.cpu()))
    with torch.no_grad():
        card_cpu = forwards_line(
            f"lstm (seeded random params) logits of the {tuple(rx.shape)} val batch, card "
            f"(cuDNN) against the CPU", lstm.logits(lstm.param_dict(model), rx),
            lstm.logits(lstm.param_dict(cpu_trainer.params), rx.cpu()))
    busy = device_busy(lambda: trainer.single_eval_at_point(model, 10.0, cfg.gamma))
    per_1k = point_s / cfg.n_words("val") * 1000
    print(f"lstm (seeded random params) coded BER at 10 dB: {ber:.6f}, {per_1k:.6f} s per 1000 "
          f"words, launches {point_launches}; eval tail on one batch: card {on_card:.6f}, CPU "
          f"{on_cpu:.6f} [{card}]")
    print(busy_line("lstm point at 10 dB", busy))
    if card_cpu["bits_differ_outside_margin"] or abs(on_card - on_cpu) > 2e-3:
        fail("lstm: the card and the CPU disagree on the aggregated point")
    out["point"] = {"coded_ber_10db": ber, "s_per_1k": per_1k, "busy": busy,
                    "eval_tail": {"card": on_card, "cpu": on_cpu}, "card_vs_cpu": card_cpu}

    # lstm joint (train-on-miss by Trainer.train), then lstm online in the
    # same weights directory: it loads the checkpoint and trains nothing
    for key, mode, band in (("lstm_joint", "joint", LSTM_JOINT_BAND),
                            ("lstm_online", "online", LSTM_ONLINE_BAND)):
        run = run_by_word("lstm", mode, f"{weights_dir}/lstm", band)
        out[key] = {k: v for k, v in run.items() if k not in ("cfg", "trainer", "sers")}
        out[key]["busy"] = profiled_blocks(f"lstm {mode}", "lstm", run["cfg"])
    # the two forwards with the trained params, on the card
    trained = Trainer(online_cfg("joint", f"{weights_dir}/lstm"), "lstm", verbose=False)
    p = lstm.param_dict(trained.load_weights(10.0, cfg.gamma))
    rx2 = trained.val_dataset.get(10.0, cfg.gamma)[1]
    with torch.no_grad():
        two = forwards_line(f"lstm (trained) logits of the {tuple(rx2.shape)} val batch, cuDNN "
                            f"against the unrolled forward, on the card",
                            lstm.logits(p, rx2), lstm.logits_unrolled(p, rx2))
    if two["bits_differ_outside_margin"]:
        fail("lstm: cuDNN's and the unrolled forward detect different bits outside the margin")
    out["fused_vs_unrolled"] = two
    return out


def meta_lstm_cell(weights_dir: str, card: str) -> dict:
    """meta_lstm in `weights_dir`: meta_train on the miss, then the first
    META_LSTM_BLOCKS blocks of the by-word meta run, through its first meta
    event, on the card and on the CPU; the seconds per second-order MAML step and an
    estimate of a 300-block run. Runs in a process of its own (see
    start_phase_lstm)."""
    mcfg = online_cfg("meta", weights_dir)
    mtrainer = Trainer(mcfg, "meta_lstm", verbose=False)
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = mtrainer.load_weights(10.0, mcfg.gamma)
    torch.cuda.synchronize()
    meta_train_s = time.perf_counter() - t0
    no_launches("meta_lstm meta_train", read_launches())
    tx, rx = mtrainer.val_dataset.get(10.0, mcfg.gamma)
    h = mtrainer.decoder_csi(tx.shape[0])

    def first_blocks(device: str, m, n: int) -> dict:
        draws = CountingDraws(mcfg, mtrainer.spec, torch.device(device),
                              torch.Generator(device=device).manual_seed(SEED),
                              torch.Generator().manual_seed(SEED))
        spans = CudaSpans() if device == "cuda" else contextlib.nullcontext
        zero_launches()
        t0 = time.perf_counter()
        result = run_online(mcfg, mtrainer.spec, m, tx[:n].to(device), rx[:n].to(device),
                            h[:n].to(device), draws, spans=spans)
        if device == "cuda":
            torch.cuda.synchronize()
            no_launches("meta_lstm by-word blocks", read_launches())
        run = {"s": time.perf_counter() - t0, "sers": result.ser_by_word,
               "maml_steps": draws.maml_steps, "n_gated": result.n_gated,
               "parts": spans.seconds() if device == "cuda" else None}
        print(f"meta_lstm first {n} blocks on {device}: {run['s']:.2f} s, {draws.maml_steps} "
              f"second-order MAML steps, {result.n_gated} gated blocks, parts {run['parts']}")
        return run

    n = META_LSTM_BLOCKS
    runs = {"cuda": first_blocks("cuda", params, n)}
    if not runs["cuda"]["maml_steps"]:
        fail(f"meta_lstm: no meta event in the first {n} blocks")
    runs["cpu"] = first_blocks("cpu", copy.deepcopy(params).cpu(), n)
    block_diff = float(np.abs(runs["cuda"]["sers"] - runs["cpu"]["sers"]).max())
    print(f"meta_lstm first {n} blocks, card against CPU: largest per-block SER difference "
          f"{block_diff:.6f} (limit {CARD_CPU_BLOCK_TOL:.6f}); card "
          f"{runs['cuda']['sers'].tolist()}, CPU {runs['cpu']['sers'].tolist()}")
    if block_diff > CARD_CPU_BLOCK_TOL:
        fail("meta_lstm: the card and the CPU disagree on the first blocks")
    steps = runs["cuda"]["maml_steps"]
    meta_s = runs["cuda"]["parts"]["meta"][2]
    per_step = meta_s / steps
    estimate = META_EVENTS * MAX_STEPS_PER_EVENT * per_step
    print(f"meta_lstm second-order MAML step on the card: {per_step:.4f} s per step over {steps} "
          f"steps ({meta_s:.2f} s of meta adaptation, host clock); meta_train on the miss "
          f"{meta_train_s:.2f} s for {mcfg.train_minibatch_num} minibatches. Estimate, not a "
          f"measurement: a 300-block meta run takes about {META_EVENTS} events x at most "
          f"{MAX_STEPS_PER_EVENT} steps x {per_step:.4f} s = {estimate:.0f} s at most [{card}]")
    return {"meta_train_s": meta_train_s, "blocks": n, "max_block_ser_diff": block_diff,
            "card_s": runs["cuda"]["s"], "cpu_s": runs["cpu"]["s"], "maml_steps": steps,
            "s_per_maml_step": per_step, "full_run_estimate_s": estimate,
            "parts": runs["cuda"]["parts"]}


def run_cli(argv: list) -> dict:
    """cli.main in this process; returns its last line's JSON."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        fail(f"cli {argv}: exit code {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def phase_cli(vnet_dir: str) -> dict:
    """The port's CLI: the trained vnet checkpoint of the joint by-word run,
    evaluated aggregated through K4 with no training, in process; then the
    VA from `python -m metaviterbinet_tpu_torch` in a subprocess."""
    base = ["evaluate", "--detector", "vnet", "--snr", "10", "--weights-dir", vnet_dir,
            "--set", "fading_taps_type=2", "val_frames=12"]
    zero_launches()
    chunked = run_cli(base + ["eval_time_chunks=4"])
    chunked_launches = read_launches()
    zero_launches()
    plain = run_cli(base + ["eval_time_chunks=0"])
    plain_launches = read_launches()
    ber = chunked["mean_ser"]
    print(f"cli evaluate vnet (trained checkpoint), eval_time_chunks=4: {chunked}, launches "
          f"{chunked_launches}; eval_time_chunks=0: {plain}, launches {plain_launches}; "
          f"band {VNET_JOINT_BAND[0]} +- {VNET_JOINT_BAND[1]}")
    if (chunked_launches["fused_viterbinet_detect_chunked"],
            chunked_launches["fused_viterbinet_detect"]) != (1, 0):
        fail(f"cli chunked eval: expected one K4 launch and no training, got {chunked_launches}")
    if (plain_launches["fused_viterbinet_detect"], plain_launches["fused_viterbinet_detect_chunked"]) \
            != (1, 0):
        fail(f"cli unchunked eval: expected one K1 launch, got {plain_launches}")
    if abs(ber - VNET_JOINT_BAND[0]) > VNET_JOINT_BAND[1]:
        fail(f"cli chunked eval: coded BER {ber} outside the vnet joint band")
    if plain["mean_ser"] != ber:
        fail(f"cli: chunked {ber} and unchunked {plain['mean_ser']} differ")

    cmd = [sys.executable, "-m", "metaviterbinet_tpu_torch", "evaluate", "--detector", "va",
           "--snr", "10", "--set", "val_frames=12"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT_DIR, env=dict(os.environ, PYTHONPATH=ROOT_DIR),
                          capture_output=True, text=True, timeout=600)
    sub_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"{' '.join(cmd[1:])}: exit code {proc.returncode}\n{proc.stderr[-4000:]}")
    sub = json.loads(proc.stdout.strip().splitlines()[-1])
    cfg = Config(val_frames=12, val_SNR_start=10.0, val_SNR_end=10.0)
    in_process = float(Trainer(cfg, "va", verbose=False).evaluate().mean())
    print(f"python -m metaviterbinet_tpu_torch evaluate --detector va --snr 10 --set "
          f"val_frames=12: exit 0 in {sub_s:.1f} s, last line {sub}; in process {in_process}")
    if sub["mean_ser"] != in_process:
        fail(f"cli subprocess BER {sub['mean_ser']} differs from in process {in_process}")
    return {"vnet_chunked": chunked, "vnet_unchunked": plain, "launches": chunked_launches,
            "va_subprocess": sub, "va_in_process": in_process, "subprocess_s": sub_s}


def phase_bf16(model: viterbinet.ViterbiNet) -> dict:
    """Config.dtype='bfloat16' on the card against the CPU."""
    cfg = Config(val_frames=12, dtype="bfloat16")
    trainer = Trainer(cfg, "vnet", params=model, verbose=False)
    model_cpu = copy.deepcopy(model).cpu()
    cpu_spec = Trainer(cfg, "vnet", device="cpu", params=model_cpu, verbose=False).spec
    tx, rx = trainer.val_dataset.get(10.0, cfg.gamma)
    with torch.no_grad():
        card = trainer.spec.score(viterbinet.param_dict(model), rx).cpu()
        cpu = cpu_spec.score(viterbinet.param_dict(model_cpu), rx.cpu())
    diff = (card - cpu).abs()
    limit = BF16_LOGIT_TOL * max(1.0, float(cpu.abs().max()))
    zero_launches()
    bits = trainer.spec.engine_detect(model, rx, None)
    engine_launches = read_launches()
    cpu_bits = cpu_spec.engine_detect(model_cpu, rx.cpu(), None)
    mismatch = float((bits.cpu() != cpu_bits).float().mean())
    print(f"bf16 logits of the {tuple(rx.shape)} val batch, card against CPU: max |diff| "
          f"{float(diff.max()):.3e} (limit {limit:.3e}), {float((diff > 0).float().mean()):.3e} of "
          f"them differ; engine detect bit mismatch {mismatch:.3e} (limit < 1e-3), launches "
          f"{engine_launches}")
    if card.dtype != torch.float32 or not float(diff.max()) <= limit:
        fail("bf16 logits: the card and the CPU disagree")
    if mismatch >= 1e-3 or engine_launches["viterbi_decode_kernel"] != 1:
        fail("bf16 engine detect: the card and the CPU disagree, or K5 did not run")

    fresh = trainer.init_params()
    params = viterbinet.param_dict(fresh)
    optimizer = Optimizer(cfg.optimizer_type, cfg.lr)
    opt_state = optimizer.init(params)
    ttx, trx = trainer.train_dataset.get(10.0, cfg.gamma)
    select = [select_batch(ttx.shape[1], cfg.train_minibatch_size, trainer.generator, "cuda")
              for _ in range(ttx.shape[0])]
    t0 = time.perf_counter()
    loss = float(word_sweep(trainer.loss_fn, optimizer, params, opt_state, trx, ttx, select))
    sweep_s = time.perf_counter() - t0
    fused = {dtype: uses_fused_adaptation(cfg.replace(dtype=dtype), Trainer(
        cfg.replace(dtype=dtype), "meta_vnet", params=model, verbose=False).spec)
        for dtype in ("float32", "bfloat16")}
    print(f"bf16 word sweep over {ttx.shape[0]} words: loss {loss:.4f} ({sweep_s:.2f} s); "
          f"uses_fused_adaptation for meta_vnet: {fused}")
    if not np.isfinite(loss) or not all(bool(torch.isfinite(p).all()) for p in params.values()):
        fail(f"bf16 word sweep: loss {loss} or params not finite")
    if fused != {"float32": True, "bfloat16": False}:
        fail(f"bf16: K6 must not run the bf16 self-supervised step: {fused}")

    # the LSTM in bf16: the unrolled forward, every op rounded to bf16, on
    # the first 50 words, through its spec's score
    lstm_model = lstm.init_params(torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    lstm_cpu = copy.deepcopy(lstm_model).cpu()
    lstm_spec = Trainer(cfg, "lstm", params=lstm_model, verbose=False).spec
    lstm_cpu_spec = Trainer(cfg, "lstm", device="cpu", params=lstm_cpu, verbose=False).spec
    y = rx[:50]
    zero_launches()
    with torch.no_grad():
        lstm_card = lstm_spec.score(lstm.param_dict(lstm_model), y).cpu()
        lstm_bits = lstm_spec.detect(lstm_model, y, None).cpu()
    no_launches("lstm bf16", read_launches())
    with torch.no_grad():
        lstm_cpu_logits = lstm_cpu_spec.score(lstm.param_dict(lstm_cpu), y.cpu())
    lstm_diff = float((lstm_card - lstm_cpu_logits).abs().max())
    lstm_limit = BF16_LOGIT_TOL * max(1.0, float(lstm_cpu_logits.abs().max()))
    lstm_mismatch = int((lstm_bits != lstm_cpu_spec.detect(lstm_cpu, y.cpu(), None)).sum())
    print(f"lstm bf16 logits of {tuple(y.shape)} val words, card against CPU: max |diff| "
          f"{lstm_diff:.3e} (limit {lstm_limit:.3e}), "
          f"{float((lstm_card != lstm_cpu_logits).float().mean()):.3e} of them differ; "
          f"{lstm_mismatch} of {y.numel()} detected bits differ")
    if lstm_card.dtype != torch.float32 or not lstm_diff <= lstm_limit:
        fail("lstm bf16 logits: the card and the CPU disagree")
    return {"logit_max_diff": float(diff.max()), "logit_limit": limit,
            "engine_bit_mismatch": mismatch, "word_sweep_loss": loss, "word_sweep_s": sweep_s,
            "lstm_logit_max_diff": lstm_diff, "lstm_logit_limit": lstm_limit,
            "lstm_bits_differ": lstm_mismatch}


CHUNKED_TIMED = ((PROTO_W, 2), (PROTO_W, 4), (WIDE_W, 4))


def phase_width(model: viterbinet.ViterbiNet, gen: torch.Generator, card: str) -> dict:
    times = {}

    def record(name, W, kernel, plain, bound, wide=False, per_graph=20, plain_per_graph=2,
               C=None):
        ms = graph_ms(kernel, per_graph=per_graph, replays=10 if per_graph > 2 else 3)
        plain_ms = graph_ms(plain, per_graph=plain_per_graph, replays=5 if not wide else 3)
        kernel_call = call_ms(kernel, reps=20 if per_graph > 2 else 5)
        plain_call = call_ms(plain, reps=10 if wide else 5, warmup=1)
        shape = f"W={W}" if C is None else f"W={W} C={C}"
        beside = ""
        if C is not None:
            beside = f"; K1 at the same shape {times[('fused_viterbinet_detect', W)]['ms']:.5f} ms"
        print(f"width {name} {shape}: kernel {ms:.5f} ms on the device, {kernel_call:.5f} ms per "
              f"eager call; plain {plain_ms:.4f} ms on the device, {plain_call:.4f} ms per eager "
              f"call; bound {bound[0]:.3e} ms ({bound[1]}){beside} [{card}]")
        times[(name, W) if C is None else (name, W, C)] = {
            "ms": ms, "plain_ms": plain_ms, "call_ms": kernel_call, "plain_call_ms": plain_call,
            "bound_ms": bound[0], "bound_by": bound[1]}

    for W in (PROTO_W, WIDE_W):
        y, mu = kernel_inputs(W, T_PROTO, gen)
        wide = W == WIDE_W
        record("fused_va_detect", W, lambda: acs.fused_va_detect(y, mu),
               lambda: acs.fused_va_detect_plain(y, mu), va_bound_ms(W, T_PROTO, 16), wide)
        record("fused_viterbinet_detect", W, lambda: acs.fused_viterbinet_detect(model, y),
               lambda: acs.fused_viterbinet_detect_plain(model, y),
               vnet_bound_ms(W, T_PROTO, 16), wide)
        print(f"fused_viterbinet_detect W={W}: SFU floor {sfu_floor_ms(W * T_PROTO):.5f} ms "
              f"(100 sigmoids per symbol at {SFU_PER_CLOCK_PER_SM} per clock per SM, published)")
    y, mu = kernel_inputs(1, T_PROTO, gen)
    record("fused_va_detect", 1, lambda: acs.fused_va_detect(y, mu),
           lambda: acs.fused_va_detect_plain(y, mu), va_bound_ms(1, T_PROTO, 16))
    for W, C in CHUNKED_TIMED:
        y = kernel_inputs(W, T_PROTO, gen)[0]
        record("fused_viterbinet_detect_chunked", W,
               lambda: acs.fused_viterbinet_detect_chunked(model, y, C),
               lambda: acs.fused_viterbinet_detect_chunked_plain(model, y, C),
               chunked_bound_ms(W, T_PROTO, C, 16), W == WIDE_W, C=C)
        row = times[("fused_viterbinet_detect_chunked", W, C)]
        # the chain floor: K5 over priors of the chunked chains' shape, the
        # ACS alone (at 65536 words that many priors make K5 bound by bytes)
        row["chain_floor_ms"] = None
        ext = OVERLAP + T_PROTO // C
        if W == PROTO_W:
            priors = torch.randn((W * C, ext, 16), generator=gen, device="cuda")
            row["chain_floor_ms"] = graph_ms(lambda: acs.viterbi_decode_kernel(priors))
            del priors
        chain = "not measured" if row["chain_floor_ms"] is None else f"{row['chain_floor_ms']:.5f} ms"
        symbols = chunked_symbols(W, T_PROTO, C)
        print(f"fused_viterbinet_detect_chunked W={W} C={C}: bound over {symbols} symbols "
              f"through the MLP and the ACS, {symbols / (W * T_PROTO):.4f}x K1's; chain floor "
              f"(K5 at {W * C} x {ext} priors) {chain}; SFU floor {sfu_floor_ms(symbols):.5f} ms "
              f"(published rates) [{card}]")
    for W in (1, PROTO_W):
        priors = mlp_priors(model, kernel_inputs(W, T_PROTO, gen)[0])
        record("viterbi_decode_kernel", W, lambda: acs.viterbi_decode_kernel(priors),
               lambda: acs.viterbi_decode_kernel_plain(priors), decode_bound_ms(W, T_PROTO, 16))
    params, y, states = adapt_inputs()
    state = Optimizer("Adam", 1e-3).init(params)
    bound = adapt_bound_ms(T_PROTO, 16, K6_ITERS)
    record("online_adapt_viterbinet", 1,
           lambda: online_sgd.online_adapt_viterbinet(params, state, y, states, K6_ITERS, 1e-3,
                                                      ADAM_B1, ADAM_B2, ADAM_EPS),
           lambda: online_sgd.online_adapt_viterbinet_plain(params, state, y, states, K6_ITERS,
                                                            1e-3, ADAM_B1, ADAM_B2, ADAM_EPS),
           bound, per_graph=2, plain_per_graph=1)
    cluster = online_sgd.CLUSTER_SIZE
    k6 = times[("online_adapt_viterbinet", 1)]
    print(f"online_adapt_viterbinet: {adapt_ops(T_PROTO, 16, K6_ITERS):.4e} f32 operations for "
          f"{K6_ITERS} steps at T={T_PROTO}; bound {bound[0]:.5f} ms at the card's f32 rate, "
          f"{bound[0] * N_SMS / cluster:.4f} ms at the share of its cluster of {cluster} CTAs, "
          f"{bound[0] * N_SMS:.4f} ms at one SM's share; {1e3 * k6['ms'] / K6_ITERS:.3f} us per "
          f"step on the device [{card}]")
    return times


REPLACES = {"fused_va_detect": "metaviterbinet_tpu/kernels/acs.py:409",
            "fused_viterbinet_detect": "metaviterbinet_tpu/kernels/acs.py:262",
            "fused_viterbinet_detect_chunked": "metaviterbinet_tpu/kernels/acs.py:306",
            "viterbi_decode_kernel": "metaviterbinet_tpu/kernels/acs.py:451",
            "online_adapt_viterbinet": "metaviterbinet_tpu/kernels/online_sgd.py:156"}
SOURCES = {"fused_va_detect": "metaviterbinet_tpu_torch/kernels/csrc/va_detect.cu",
           "fused_viterbinet_detect": "metaviterbinet_tpu_torch/kernels/csrc/viterbinet_detect.cu",
           "fused_viterbinet_detect_chunked":
               "metaviterbinet_tpu_torch/kernels/csrc/viterbinet_detect_chunked.cu",
           "viterbi_decode_kernel": "metaviterbinet_tpu_torch/kernels/csrc/viterbi_decode.cu",
           "online_adapt_viterbinet": "metaviterbinet_tpu_torch/kernels/csrc/online_adapt.cu"}


def kernel_rows(checks: dict, sl: dict, online: dict, times: dict) -> list:
    rows = []
    meta_launches = online["meta_vnet_meta"]["launches"]
    for name in ("fused_viterbinet_detect", "fused_va_detect"):
        main_row, wide_row = times[(name, PROTO_W)], times[(name, WIDE_W)]
        main_check = checks[(name, PROTO_W, T_PROTO)]
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": sl["launches"][name], "max_abs_err": main_check["max_abs_err"],
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": None, "shape": [PROTO_W, T_PROTO],
            "bit_mismatch_rate": main_check["bit_mismatch_rate"],
            "call_ms": main_row["call_ms"], "plain_call_ms": main_row["plain_call_ms"],
            "ms_65536": wide_row["ms"], "plain_ms_65536": wide_row["plain_ms"],
            "call_ms_65536": wide_row["call_ms"], "plain_call_ms_65536": wide_row["plain_call_ms"],
            "bound_ms_65536": wide_row["bound_ms"], "bound_by_65536": wide_row["bound_by"],
            "checked": [{"shape": [W, T], **checks[(name, W, T)]} for W, T in KERNEL_CHECK_SHAPES],
            "checked_by_S": {S: checks[(name, "S", S)] for S in STATES},
        })
        if name == "fused_va_detect":
            one = times[(name, 1)]
            rows[-1].update({
                "launches_va_joint": online["va_joint"]["launches"][name],
                "ms_1": one["ms"], "plain_ms_1": one["plain_ms"], "call_ms_1": one["call_ms"],
                "plain_call_ms_1": one["plain_call_ms"], "bound_ms_1": one["bound_ms"],
                "bound_by_1": one["bound_by"], "checked_1": checks[(name, 1, T_PROTO)]})
        else:
            rows[-1]["tile_priors_max_abs_err"] = {S: checks[("tile", S)] for S in STATES}
    name = "fused_viterbinet_detect_chunked"
    main_row = times[(name, PROTO_W, 4)]
    rows.append({
        "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
        "launches": sl["chunked_launches"][name],
        "max_abs_err": checks[(name, PROTO_W, T_PROTO, 4)]["max_abs_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"], "library_ms": None, "shape": [PROTO_W, T_PROTO],
        "chunks": 4, "overlap": OVERLAP,
        "bound_symbols": chunked_symbols(PROTO_W, T_PROTO, 4),
        "bit_mismatch_rate": checks[(name, PROTO_W, T_PROTO, 4)]["bit_mismatch_rate"],
        "call_ms": main_row["call_ms"], "plain_call_ms": main_row["plain_call_ms"],
        "k1_ms_same_shape": times[("fused_viterbinet_detect", PROTO_W)]["ms"],
        "timed": [{"shape": [W, T_PROTO], "chunks": C, **times[(name, W, C)],
                   "bound_symbols": chunked_symbols(W, T_PROTO, C),
                   "k1_ms_same_shape": times[("fused_viterbinet_detect", W)]["ms"]}
                  for W, C in CHUNKED_TIMED],
        "checked": [{"shape": [W, T], "chunks": C, **checks[(name, W, T, C)]}
                    for W, T, C in CHUNKED_CHECK_SHAPES],
        "equal_to_k1": [{"shape": [PROTO_W, T_PROTO], "chunks": C, **checks[(name, "k1", C)]}
                        for C in CHUNKS_EQUAL_TO_K1],
    })
    name = "viterbi_decode_kernel"
    row, wide = times[(name, 1)], times[(name, PROTO_W)]
    rows.append({
        "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
        "launches": meta_launches[name], "max_abs_err": checks[(name, 1, T_PROTO)]["max_abs_err"],
        "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": None, "shape": [1, T_PROTO, 16],
        "call_ms": row["call_ms"], "plain_call_ms": row["plain_call_ms"],
        "ms_300": wide["ms"], "plain_ms_300": wide["plain_ms"], "call_ms_300": wide["call_ms"],
        "plain_call_ms_300": wide["plain_call_ms"], "bound_ms_300": wide["bound_ms"],
        "bound_by_300": wide["bound_by"],
        "launches_vnet_joint": online["vnet_joint"]["launches"][name],
        "checked": [{"shape": [W, T, 16], **checks[(name, W, T)]} for W, T in DECODE_CHECK_SHAPES],
    })
    name = "online_adapt_viterbinet"
    row = times[(name, 1)]
    rows.append({
        "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
        "launches": meta_launches[name], "max_abs_err": checks[(name, 1, T_PROTO)]["max_abs_err"],
        "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": None, "shape": [T_PROTO, K6_ITERS],
        "call_ms": row["call_ms"], "plain_call_ms": row["plain_call_ms"],
        "cluster_size": online_sgd.CLUSTER_SIZE,
        "cluster_bound_ms": row["bound_ms"] * N_SMS / online_sgd.CLUSTER_SIZE,
        "one_sm_bound_ms": row["bound_ms"] * N_SMS,
        "us_per_step": 1e3 * row["ms"] / K6_ITERS,
        "checked": checks[(name, 1, T_PROTO)]["by_check"],
        "drift": checks[(name, 1, T_PROTO)]["drift"],
    })
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(card)

    seconds = {}

    def timed(name: str, phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        seconds[name] = time.perf_counter() - t0
        print(f"{name} phase: {seconds[name]:.1f} s")
        return out

    timed("build", phase_build)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = viterbinet.init_params(16, gen, device="cuda")
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=2, mp_context=multiprocessing.get_context("spawn"))
    with tempfile.TemporaryDirectory() as weights_dir, pool:
        trained = trained_vnet(f"{weights_dir}/one_minibatch")
        checks = timed("kernels", phase_kernels, model, trained, gen)
        sl = timed("slice", phase_slice, model, trained)
        anchors = timed("anchors", phase_anchors)
        lstm_jobs = start_phase_lstm(pool, weights_dir, card)
        threads = torch.get_num_threads()
        torch.set_num_threads(MAIN_CPU_THREADS_BESIDE_CHILDREN)
        online = timed("online", phase_online, weights_dir)
        cli_out = timed("cli", phase_cli, f"{weights_dir}/vnet")
        bf16 = timed("bf16", phase_bf16, model)
        lstm_out = timed("lstm (the wait after phase 7)", finish_phase_lstm, lstm_jobs)
        torch.set_num_threads(threads)
    times = timed("width", phase_width, model, gen, card)

    print(json.dumps({"kernels": kernel_rows(checks, sl, online, times), "card": card,
                      "eval_s_per_1000_words": {
                          "va_sweep": sl["va_s_per_1k"], "va_loop": sl["va_loop_s_per_1k"],
                          "vnet": sl["vnet_s_per_1k"], "vnet_chunked": sl["vnet_chunked_s_per_1k"]},
                      "point_under_profiler_10db": sl["busy"],
                      "va_coded_ber_7_to_12db": sl["va_ber"],
                      "vnet_coded_ber_10db": {"random_params": sl["vnet_ber_10db"],
                                              "trained_params": sl["vnet_trained_ber_10db"]},
                      "anchors": anchors, "by_word_10db": online, "lstm": lstm_out,
                      "cli": cli_out, "bf16": bf16, "phase_seconds": seconds}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
