"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, each of which fails the run on error:
  1. card     print the card's name and power limit (nvidia-smi);
  2. build    compile the six CUDA kernels, the IF-node helper
              (online/graphs.py::when) and the tracer's stamp
              (utils/profiling.py::Tracer) from
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
              inputs, bit-identical; K7 (fused MAML pairs) on a meta slot's
              pairs at T = 136: one launch of 10 draws, the slot's 20, and
              the slot's 200 draws in one launch (the engine's) against its
              plain version, the slot in one launch bit-identical to its 20,
              two launches bit-identical, and its float64 witness against
              the autograd pairs it replaced;
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
              miss: meta_vnet in meta mode (meta_train, then a meta slot
              every 5 blocks, decided on the card: the query draws of
              the buffer's fill, the MAML pairs with duplicates masked
              within each iteration, a slot's pairs, all its iterations',
              one K7 launch under an IF node, K7's launches one a slot
              that fired; and K6 on every gated block), vnet
              in joint mode
              (train, then detection only), vnet in online mode (the joint
              cell's checkpoint, then 200 graphed self-supervised steps per
              gated block on a subsampled loss, so no K6) and va in joint
              mode (K2 per block, nothing trained), each against its
              recorded reference band; launch counts (kernel executions,
              inside graphs and their IF nodes too), the engine's host
              reads (1 a run, a meta run's too), the block loop under torch.cuda.set_sync_debug_mode("error")
              from the block after its last capture to the end-of-run read
              (SyncChecked), buffer fill, seconds of train-on-miss (the
              word sweep, chunk graphs), of the 300 blocks (host clock to a
              synchronise, and CUDA events) and of their parts (the
              tracer's spans, stamped on the device: its idle share and
              the block graph's parts too), the graphed calls (warm-up,
              capture, replay: the per-block detect, RS decode, score,
              gate and append, the
              steps under the gate, the word sweep) and milliseconds a
              call, and the
              device's idle share and activities a block (torch.profiler, a
              second run over PROFILED_BLOCKS blocks); then the first 25
              blocks of meta_vnet, vnet online, vnet joint and va joint
              graphed against the same calls with capture patched out
              (no_capture: per-block SERs equal, the same launches, final
              params 0 apart; meta_vnet's MAML pair count equal too),
              meta_vnet's once more on the CPU (SERs and pair count equal),
              and vnet's
              train-on-miss uncaptured (its checkpoint's params 0 from the
              graphed one's);
  5b. lstm    the LSTM family (2 x 256 LSTM, window 4), which has no kernel,
              in two processes of its own started after phase 4 and run
              beside phases 5-7 (see start_beside); no path of it may
              launch one of the six kernels. In one process: the
              aggregated point at 10 dB with seeded random params (cuDNN),
              its logits and eval tail on the card against the CPU, and
              under torch.profiler; lstm joint (Trainer.train on the miss,
              25 minibatches) and lstm online (self-supervised autograd
              steps, the same checkpoint) over 300 blocks against their
              reference bands, each also under the profiler
              (PROFILED_BLOCKS), lstm online's first 25 blocks graphed
              against uncaptured (params 0 apart), lstm's train-on-miss
              uncaptured against the graphed one (params 0 apart); cuDNN's
              forward against the unrolled one
              with the trained params (bits equal outside a margin of
              1e-4). In the other: meta_lstm's meta_train on the miss (25
              minibatches, graphed MAML steps) and the first 6 blocks of its
              meta run, through the first meta event (second-order MAML
              steps), graphed and uncaptured on the card and on the CPU.
              Their output is printed after phase 7b;
  5c. sweep   the experiment harness (plotters/experiments.py) at the
              protocol's full width, in a third process of its own beside
              phases 5-7 (see start_beside), printed after phase 7b:
              build_curve over sweep_config(8 dB, block 120, RS nsym=2,
              COST2100 test channel) for six of the seven curves (OnlineRNN
              has no band at 8 dB), each against its reference band and
              beside the JAX package's value, with its launch counts (none
              for JointRNN and LSTM), seconds and idle share, and one more
              call read from the curve cache with no launch (see
              phase_sweep for the depth cut);
  5d. alone  after the wait for phases 5b and 5c, the by-word cells
              meta_vnet, vnet joint, vnet online, va joint and lstm online
              once more alone on the card from their checkpoints (their
              mean BERs equal to phase 5's), timed, and vnet's
              train-on-miss in a fresh weights directory;
  6. cli      in the vnet weights directory of phase 5: `evaluate` of the
              trained checkpoint, aggregated through K4 (no training), in
              process, against the vnet joint band and against the same
              command unchunked; `python -m metaviterbinet_tpu_torch
              evaluate --detector va` in a subprocess, against the same eval
              in process; and the same in a subprocess with `--config` of
              the vnet directory's config.yaml (the flat reader, with
              yaml, msgpack and flax blocked in the subprocess), against
              the eval in process;
  7. bf16     Config.dtype='bfloat16': the bf16 logits and the engine detect
              on the card against the CPU, one bf16 word sweep, and no K6;
              the LSTM's bf16 logits on the card against the CPU;
  7b. parallel the parallel layer on a world-1 NCCL group (init_distributed),
              in the main process while phases 5b and 5c finish, checks
              only: the aggregated protocol with Config.mesh_shape=(1,) (VA
              over 7..12 dB, the trained ViterbiNet at 10 dB with
              eval_time_chunks 0 and 4), bit-equal to the same runs without
              a mesh, launching K2 6, K1 1 and K4 1 times;
              sequence_parallel_decode over a one-rank 'sp' axis and
              chunked_decode_reference (32 chunks, overlap 32) on VA priors
              at 10 dB, 128 x 8192, each one K5 launch with no bit apart
              from one sequential K5 launch (and the chunked decode's
              mismatch rate on N(0,1) priors at overlap 32 and 64, not
              gated); viterbi_decode_lowlat equal to K5 on integer priors
              and at least 0.999 equal on float priors; one
              make_dp_train_step SGD step within 1e-6 of the step with no
              collective;
  7c. steps   alone on the card after the wait: each graphed step of the
              by-word engine (STEP_KINDS: the vnet and lstm self-supervised
              steps, the meta_vnet and meta_lstm second-order MAML steps) at
              T = 136, eager (capture patched out) and replayed, in ms a
              step, the self-supervised steps also as the engine's chunk
              graph under the gate's IF node, and one of each under
              torch.profiler (device activities
              and busy time); from them an estimate of a 300-block meta_lstm
              run (the full run goes through the CLI, in a call of its own:
              it would take the script past its time budget);
  8. width    time the kernels and their plain versions on the device (a CUDA
              graph of back-to-back calls) and per eager call: K1 and K2 at
              300 x 136 and 65536 x 136, K2 at 1 x 136, K4 at 300 x 136 with
              2 and 4 chunks and 65536 x 136 with 4 (beside K1 at the same
              shape, K1's and K4's SFU floors and K4's chain floor: K5 over
              the chunked chains' (W C) x (overlap + T / C) priors at 300
              words), K5 at 1 x 136 and 300 x 136, K6 at
              T = 136 with 200 steps (with its cluster size, its bound at
              the cluster's share of the card and at one SM's, and its time
              per step), and K6 with its start powers read from device
              memory at the device count against its plain version (40 and
              a resumed 40 steps), two launches bit-identical and its
              float64 witness; K7 at one launch of 10 draws x T = 136
              and at a slot's 20 x 10 draws as one call (each with its
              bound from portbench/counts.py::maml_pair_ops);
              viterbi_decode_lowlat at 1 x 136 beside K5 on the
              same priors, and chunked_decode_reference (one K5 over 4096
              chains of 288 steps) beside sequential K5 at 128 x 8192;
  8b. bench   `python -m metaviterbinet_tpu_torch bench` in a process of its
              own, alone on the card: its card line and JSON line, with
              bench.py's keys and a positive value;
  9. report   a `{"kernels": [...]}` line, then the card line, then
              `{"ok": true, "device": {...}}` as the last line.

Exits non-zero, printing no result, when no CUDA device is present.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import functools
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
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

from metaviterbinet_tpu_torch import Config, bench, cli, load_config
from metaviterbinet_tpu_torch.data.dataset import ChannelDataset, generate_words
from metaviterbinet_tpu_torch.ecc.rs import rs_encode_bits
from metaviterbinet_tpu_torch.evaluation.trainer import Trainer
from metaviterbinet_tpu_torch.kernels import acs, maml_pairs, native, online_sgd
from metaviterbinet_tpu_torch.models import lstm, va, viterbinet
from metaviterbinet_tpu_torch.detectors import DETECTORS
from metaviterbinet_tpu_torch.online import graphs
from metaviterbinet_tpu_torch.online.engine import (
    Draws, make_adapt_step, meta_slots, n_bounds, run_online, uses_fused_adaptation,
    uses_fused_maml)
from metaviterbinet_tpu_torch.online.graphs import GraphedStep, chunk_steps
from metaviterbinet_tpu_torch.ops.trellis import calculate_states, viterbi_decode_lowlat
from metaviterbinet_tpu_torch.parallel import decode as parallel_decode
from metaviterbinet_tpu_torch.parallel.decode import (
    chunked_decode_reference, sequence_parallel_decode)
from metaviterbinet_tpu_torch.parallel.mesh import init_distributed, make_mesh
from metaviterbinet_tpu_torch.parallel.training import make_dp_train_step
from metaviterbinet_tpu_torch.paths import RESOURCES_DIR, ROOT_DIR
from metaviterbinet_tpu_torch.plotters import cache, experiments
from metaviterbinet_tpu_torch.train.checkpoint import ckpt_path
from metaviterbinet_tpu_torch.train.losses import make_loss_fn, select_batch
from metaviterbinet_tpu_torch.train.loop import word_sweep
from metaviterbinet_tpu_torch.train.meta import (
    each_pair, make_maml_step, maml_pair_step, masked_pairs)
from metaviterbinet_tpu_torch.train.optim import ADAM_B1, ADAM_B2, ADAM_EPS, Optimizer
from metaviterbinet_tpu_torch.utils.profiling import Tracer
from portbench import counts, trace

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
VNET_ONLINE_BAND = (0.034954, 0.012)
# va_joint: the VA trains nothing, so only the binomial noise of the 288
# data blocks' bits is in it; the VA's band of VA_BAND
VA_JOINT_BAND = (0.014149, 0.006)
# blocks of the by-word runs under torch.profiler: a whole run where it is
# short, the first blocks where the profiler's record of millions of eager
# launches would take minutes (meta_vnet, the online modes' self-supervised
# steps) or the host's memory (lstm online); the sweep's cells by curve
PROFILED_BLOCKS = {"meta_vnet": 50, "vnet": 300, "vnet online": 25, "va": 300,
                   "lstm joint": 300, "lstm online": 5,
                   "Viterbi - Full CSI": 300, "Joint ViterbiNet": 300, "ViterbiNet": 25,
                   "OnlineMetaViterbiNet": 25, "JointRNN": 300, "LSTM": 5}
# the sweep phase: sweep_config at SWEEP_SNR on the COST2100 channel, six of
# the seven curves, each held to the reference's mean at 8 dB of the parity
# matrix cell it names (resources/reference_baselines.json) with
# tests/test_parity_anchor.py's band (OnlineRNN has no cell at 8 dB:
# scripts/torch_sweep_curve.py runs it at 11 dB, in a call of its own)
SWEEP_SNR = 8.0
SWEEP_CURVES = {"Viterbi - Full CSI": ("va_joint_cost2100", 0.005),
                "Joint ViterbiNet": ("vnet_joint_cost2100", 0.012),
                "ViterbiNet": ("vnet_online_cost2100", 0.012),
                "OnlineMetaViterbiNet": ("meta_vnet_meta_cost2100", 0.012),
                "JointRNN": ("lstm_joint_cost2100", 0.012),
                "LSTM": ("lstm_online_cost2100", 0.012)}
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
# torch's CPU threads while the three processes of phases 5b and 5c run
# beside phases 5-7: two for each of the four processes, on the 8 cores of
# the card's machine (more threads than cores slow every process many times)
CHILD_CPU_THREADS, MAIN_CPU_THREADS_BESIDE_CHILDREN = 2, 2
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
# K7 (kernels/maml_pairs.py) on a meta slot's pairs: K7_ITERATIONS
# iterations of K7_DRAWS query draws (the protocol's meta_train_iterations x
# meta_j_num, duplicates masked) over a buffer of K7_WORDS words of T = 136,
# window 1, at the protocol's meta_lr and lr
K7_WORDS, K7_ITERATIONS, K7_DRAWS, K7_META_LR, K7_LR = 40, 20, 10, 0.1, 1e-3
# K7 against its plain version at f32: max |dparam| after 10 pairs (one
# launch) and after a slot's 200 (20 launches, or one); Adam amplifies the
# products' other summation order as K6's 200 steps do (K6_LIMITS)
K7_LIMITS = {"10 pairs": 1e-5, "200 pairs": 1e-4}
# K7's float64 witness (tests/test_torch_cuda.py, tests/test_torch_maml_kernel.py):
# over a slot's pairs from each seed's params, buffer and draws, the
# kernel's distance from a float64 run of its plain version's arithmetic is
# held within K7_WITNESS_MULTIPLE times the distance of the autograd pair it
# replaced (train/meta.py::maml_pair_step, f32) plus K7_WITNESS_FLOOR. A run
# with the Hessian term left out or the duplicate draws unmasked (K7_FAULTS)
# in its place must fail it.
K7_WITNESS_SEEDS = (0, 1, 2)
K7_WITNESS_MULTIPLE, K7_WITNESS_FLOOR = 2.0, 1e-6
K7_FAULTS = {"no Hessian term": {"second_order": False}, "duplicates unmasked": {"unmasked": True}}
CARD_CPU_BLOCKS = 25
# card against CPU over the first 25 meta-mode blocks: each block's SER
# within two of its 120 bits, the mean over the data blocks within 2e-3
CARD_CPU_BLOCK_TOL, CARD_CPU_MEAN_TOL = 2.0 / 120, 2e-3
KERNELS = ("fused_viterbinet_detect", "fused_va_detect", "fused_viterbinet_detect_chunked",
           "viterbi_decode_kernel", "online_adapt_viterbinet", "maml_pairs_viterbinet")
OVERLAP = 32  # Config.decode_overlap
# the anchors' bands (tests/test_parity_anchor.py:22-30, :65-84)
UNCODED_VA_TOL, COST2100_VA_TOL = 0.006, 0.005
# the long-stream decode of phases 7b and 8: W words x T steps of VA priors
# at 10 dB, cut into SP_CHUNKS chunks of T / SP_CHUNKS steps (the size of
# resources/overlap_save_chip.json, which a TPU measured)
SP_W, SP_T, SP_CHUNKS = 128, 8192, 32
# viterbi_decode_lowlat against K5 on float metrics: the share of equal bits
# at least (JAX's contract, tests/test_trellis.py)
LOWLAT_AGREEMENT = 0.999
# bf16 logits on the card against the CPU: within 0.03 of max(1, |logit|),
# about four bf16 ulps at the largest logit (cuBLAS and the CPU may round
# a bf16 product apart, and an h2 that differs by one ulp moves the logits)
BF16_LOGIT_TOL = 0.03


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def card_line() -> str:
    return bench.device_line(torch.device("cuda"))


def wrapper(name: str):
    module = {"online_adapt_viterbinet": online_sgd, "maml_pairs_viterbinet": maml_pairs}
    return getattr(module.get(name, acs), name)


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


def profiled_busy(fn) -> dict:
    """fn() once under torch.profiler (portbench/trace.py::profiled, device
    activity only): the host-clock wall time, the union of the device's
    activity intervals, and their count (kernels, copies, fills). The
    profiler's own host cost lengthens the wall time."""
    p = trace.profiled(fn, [])
    return {"wall_ms": p.wall_ms, "device_busy_ms": p.busy_ms, "device_activities": p.activities,
            "idle_share": (1 - p.busy_ms / p.wall_ms) if p.activities else None}


def busy_line(what: str, b: dict) -> str:
    if b["device_activities"] == 0:
        return (f"{what} under torch.profiler: {b['wall_ms']:.3f} ms wall; device time not "
                "measured (the profiler saw no device activity)")
    return (f"{what} under torch.profiler: {b['wall_ms']:.3f} ms wall, device busy "
            f"{b['device_busy_ms']:.3f} ms over {b['device_activities']} activities, "
            f"idle share {b['idle_share']:.4f}")


def span_seconds(tracer: Tracer) -> dict:
    """name -> (count, seconds on the device timeline from the tracer's
    stamps, seconds on the host) of the spans of a traced window."""
    return {name: (t.count, t.device_ms / 1e3, t.host_ms / 1e3)
            for name, t in tracer.summary().by_name.items()}


class SyncChecked:
    """`spans` for the online engine, around another: from the
    first block at which every graph of the run so far has had its warm-up
    calls and its capture (GraphedStep.counts) to the end of the run, the
    block loop runs under torch.cuda.set_sync_debug_mode("error"), so that
    any host synchronisation raises, except inside its "sync" span (the
    engine's one host read, at the end of the run). A context manager: the
    mode is reset on exit. `armed_at` is the block from which the check ran
    (None: never)."""

    def __init__(self, inner):
        self.inner, self.armed_at, self.block = inner, None, -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(0)

    @staticmethod
    def all_captured() -> bool:
        counts = GraphedStep.counts.values()
        return bool(counts) and all(
            c["capture"] and c["warmup"] == graphs.WARMUP_STEPS * c["capture"] for c in counts)

    @contextlib.contextmanager
    def __call__(self, name: str):
        if name == "detect":
            self.block += 1
            if self.armed_at is None and self.all_captured():
                self.armed_at = self.block
                torch.cuda.set_sync_debug_mode("error")
        paused = self.armed_at is not None and name == "sync"
        if paused:
            torch.cuda.set_sync_debug_mode(0)
        with self.inner(name):
            yield
        if paused:
            torch.cuda.set_sync_debug_mode("error")


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


def k7_slot(seed: int, device: str = "cuda"):
    """A meta slot's K7 input made on the CPU from `seed`: the port's
    init_params, a buffer of K7_WORDS words (random bits as BPSK in N(0,
    0.5^2) noise) and K7_ITERATIONS rows of K7_DRAWS query draws in [1,
    K7_WORDS), with duplicates; moved to `device`. Returns (params, rx, tx,
    draws)."""
    g = torch.Generator().manual_seed(seed)
    model = viterbinet.init_params(16, g, device="cpu")
    tx = torch.randint(0, 2, (K7_WORDS, T_PROTO), generator=g).float()
    rx = 1.0 - 2.0 * tx + 0.5 * torch.randn((K7_WORDS, T_PROTO), generator=g)
    draws = torch.randint(1, K7_WORDS, (K7_ITERATIONS, K7_DRAWS), generator=g)
    params = {k: v.detach().to(device) for k, v in viterbinet.param_dict(model).items()}
    return params, rx.to(device), tx.to(device), draws.to(device)


def k7_pairs(fn, opt: Optimizer, second_order: bool = True, unmasked: bool = False):
    """train/meta.py::masked_pairs' `pairs` through fn (K7's wrapper or its
    plain version), as the engine's fused path calls it; with `unmasked`,
    every pair taken, duplicates too."""
    def pairs(p, state, st, take, s_rx, s_tx, q_rx, q_tx):
        n = take.shape[0]

        def labels(tx):
            return calculate_states(4, tx.reshape(-1, tx.shape[-1])).reshape(n, -1)

        fn(p, state, opt.table(take.device), s_rx.reshape(n, -1), labels(s_tx),
           q_rx.reshape(n, -1), labels(q_tx), torch.ones_like(take) if unmasked else take,
           st["loss"], K7_META_LR, opt.lr, second_order)
    return pairs


def k7_slot_table(cfg: Config, generator: torch.Generator) -> torch.Tensor:
    """A meta slot's query draws [meta_train_iterations, n_bounds,
    meta_j_num] on the generator's device, as Draws.j_hat_table draws them
    (row b - 1 in [0, b)), with 0 drawn twice in the first iteration and
    again in the second at every bound: a value that one iteration takes
    once and two iterations take each."""
    table = torch.stack([torch.randint(0, b, (cfg.meta_train_iterations, cfg.meta_j_num),
                                       generator=generator, device=generator.device)
                         for b in range(1, n_bounds(cfg) + 1)], dim=1)
    table[0, :, :2] = 0
    table[1, :, 3] = 0
    return table


def k7_iterations(cfg: Config, opt: Optimizer, p: dict, state, st: dict, table) -> None:
    """A meta slot's fused MAML pairs one meta iteration at a time: for
    each of the slot's draws table [meta_train_iterations, n_bounds,
    meta_j_num] (the engine's `table[s]`), the iteration's row at the
    fill's bound max(n_valid - 2, 1) through masked_pairs, one K7 launch
    of its meta_j_num pairs (the kernel on the card, its plain version on
    the CPU), on the engine's run state `st` and its ring buffer; nothing
    where the fill is 2 or less (do_meta false). The sequence of launches
    that online/engine.py::make_meta_steps' one launch a slot must equal
    bit for bit. Reads the fill to the host."""
    cap, w, L, n = cfg.buffer_capacity, cfg.window_size, cfg.memory_length, cfg.meta_j_num
    n_valid = int(st["n_valid"])
    if n_valid <= 2:
        return

    def rows(st, j):
        logical = (j[:, None] + torch.arange(-w, 0, device=j.device)) % n_valid
        support, query = (st["start"] + logical) % cap, (st["start"] + j[:, None]) % cap
        return st["buf_rx"][support], st["buf_tx"][support], st["buf_rx"][query], \
            st["buf_tx"][query]

    def pairs(p, state, st, take, s_rx, s_tx, q_rx, q_tx):
        def labels(tx):
            return calculate_states(L, tx.reshape(-1, tx.shape[-1])).reshape(n, -1)

        maml_pairs.maml_pairs_viterbinet(p, state, opt.table(take.device), s_rx.reshape(n, -1),
                                         labels(s_tx), q_rx.reshape(n, -1), labels(q_tx), take,
                                         st["loss"], cfg.meta_lr, opt.lr, cfg.MAML)

    first = torch.zeros(1, dtype=torch.int64, device=table.device)
    for draws in table[:, max(n_valid - 2, 1) - 1]:
        masked_pairs(pairs, rows, p, state, st, draws, first, n)


def k7_slot_run(params: dict, rx, tx, draws, pairs: str, dtype=torch.float32,
                iterations: int = K7_ITERATIONS, fault: dict | None = None,
                one_launch: bool = False) -> tuple:
    """A slot's pairs (its first `iterations`) from params and zero
    moments, K7_DRAWS a call of masked_pairs, or with `one_launch` all in
    one call (the engine's), through `pairs`: "kernel" (K7's wrapper: the
    kernel on the card, its plain version on the CPU), "plain" or
    "autograd" (each_pair of maml_pair_step, the path K7 replaced); with
    `fault`, the plain version with those arguments. Returns (params, opt
    state, st)."""
    opt = Optimizer("Adam", K7_LR)
    p = {k: v.detach().to(dtype=dtype, copy=True) for k, v in params.items()}
    state = opt.init(p)
    if pairs == "autograd":
        loss_fn = make_loss_fn(viterbinet.logits, "states", 4, False)
        run = each_pair(maml_pair_step(loss_fn, opt, K7_META_LR, True))
        for t in p.values():
            t.requires_grad_(True)
    elif fault is not None:
        run = k7_pairs(maml_pairs.maml_pairs_viterbinet_plain, opt, **fault)
    else:
        run = k7_pairs(maml_pairs.maml_pairs_viterbinet if pairs == "kernel"
                       else maml_pairs.maml_pairs_viterbinet_plain, opt)
    st = {"rx": rx.to(dtype), "tx": tx, "loss": torch.zeros((), dtype=dtype, device=rx.device),
          "pairs": torch.zeros((), dtype=torch.int32, device=rx.device)}

    def rows(st, j):
        return st["rx"][j[:, None] - 1], st["tx"][j[:, None] - 1], st["rx"][j[:, None]], \
            st["tx"][j[:, None]]

    first = torch.zeros(1, dtype=torch.int64, device=rx.device)
    for d in [draws[:iterations]] if one_launch else draws[:iterations]:
        masked_pairs(run, rows, p, state, st, d, first, d.numel())
    return {k: v.detach() for k, v in p.items()}, state, st


def k7_witness(params: dict, rx, tx, draws, fault: dict | None = None,
               iterations: int = K7_ITERATIONS) -> dict:
    """K7, the autograd pairs in f32 and a float64 run of K7's plain
    version over a slot's pairs (its first `iterations`) from the same
    params and zero moments; returns max |dparam| between each pair of
    them. With `fault` (an entry of K7_FAULTS), the f32 plain version with
    those arguments stands where K7 stood."""
    runs = {"kernel": k7_slot_run(params, rx, tx, draws, "kernel", iterations=iterations,
                                  fault=fault)[0],
            "autograd": k7_slot_run(params, rx, tx, draws, "autograd", iterations=iterations)[0],
            "f64": k7_slot_run(params, rx, tx, draws, "plain", torch.float64, iterations)[0]}

    def dist(a, b):
        return max(float((runs[a][k].double() - runs[b][k].double()).abs().max()) for k in params)

    return {"kernel_f64": dist("kernel", "f64"), "autograd_f64": dist("autograd", "f64"),
            "kernel_autograd": dist("kernel", "autograd")}


def k7_witness_holds(d: dict) -> bool:
    return d["kernel_f64"] <= K7_WITNESS_MULTIPLE * d["autograd_f64"] + K7_WITNESS_FLOOR


def _copy_state(params: dict, state):
    p = {k: v.clone() for k, v in params.items()}
    s = copy.copy(state)
    s.count = state.count.clone()
    s.mu = {k: v.clone() for k, v in state.mu.items()}
    s.nu = {k: v.clone() for k, v in state.nu.items()}
    return p, s


def _max_diff(a: dict, b: dict) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in a)


# --------------------------------------------------------------- phases

def phase_build() -> None:
    seconds = native.build_kernels()
    for name, s in seconds.items():
        print(f"build {name}: {s:.1f} s")
        for line in native.build_reports[name].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    # K1's and K4's products run on the tensor cores: wgmma is HGMMA in SASS
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name in ("viterbinet_detect", "viterbinet_detect_chunked"):
        sass = subprocess.run([tool, "-sass", str(native.library_path(name))], capture_output=True,
                              text=True, check=True, timeout=120).stdout
        n = sass.count("HGMMA")
        print(f"{name}: {n} HGMMA (wgmma) instructions in its SASS")
        if n == 0:
            fail(f"{name}: no tensor-core instruction in its SASS")


# (W, T) of K1 and K2 against their plain versions; WIDE_W x T_PROTO is the
# bench's headline shape
KERNEL_CHECK_SHAPES = ((WIDE_W, T_PROTO), (4096, T_PROTO), (4096, 41), (1000, T_PROTO),
                       (1000, 41), (PROTO_W, T_PROTO))
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
        tile_err = float((tile - acs.bf16_priors(net, y64[None]).reshape(64, S)).abs().max())
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
    if (int(sk.count), int(sp.count)) != (80, 80):
        fail(f"online_adapt_viterbinet: step counts {int(sk.count)}, {int(sp.count)}")
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
    checks[("maml_pairs_viterbinet", K7_DRAWS, T_PROTO)] = k7_checks()
    return checks


def k7_checks() -> dict:
    """K7 against its plain version at f32 over one launch of a slot's
    first K7_DRAWS pairs, over the slot's K7_ITERATIONS launches and over
    the slot in one launch (the engine's; the counts, pair counts and
    summed losses equal too), the slot in one launch bit-identical to its
    K7_ITERATIONS launches, two launches from the same inputs
    bit-identical, and the float64 witness on every K7_WITNESS_SEEDS
    slot."""
    inputs = k7_slot(K7_WITNESS_SEEDS[0])
    errs, kernel_runs = {}, {}
    for label, iterations, limit, one_launch in (
            ("10 pairs", 1, "10 pairs", False), ("200 pairs", K7_ITERATIONS, "200 pairs", False),
            ("200 pairs, one launch", K7_ITERATIONS, "200 pairs", True)):
        (pk, sk, stk), (pp, sp, stp) = (k7_slot_run(*inputs, path, iterations=iterations,
                                                    one_launch=one_launch)
                                        for path in ("kernel", "plain"))
        kernel_runs[label] = (pk, sk, stk)
        errs[label] = _max_diff(pk, pp)
        counts = [int(sk.count), int(sp.count), int(stk["pairs"]), int(stp["pairs"])]
        loss_gap = abs(float(stk["loss"]) - float(stp["loss"])) / abs(float(stp["loss"]))
        print(f"maml_pairs_viterbinet T={T_PROTO}, {label}: max |dparam| {errs[label]:.3e} vs the "
              f"plain version (limit {K7_LIMITS[limit]:g}); Adam counts and pair counts "
              f"{counts}; summed query losses {float(stk['loss']):.6f} against "
              f"{float(stp['loss']):.6f} (relative gap {loss_gap:.2e})")
        if not errs[label] <= K7_LIMITS[limit] or len(set(counts)) != 1 or not loss_gap < 1e-5:
            fail(f"maml_pairs_viterbinet {label}: against its plain version {errs[label]}, "
                 f"counts {counts}, loss gap {loss_gap}")
    # the slot in one launch carries theta, the moments, the count and the
    # loss across the iterations' boundaries as the slot's 20 launches do
    (pa, sa, sta), (pb, sb, stb) = kernel_runs["200 pairs"], kernel_runs["200 pairs, one launch"]
    same = all(torch.equal(x[k], y[k]) for x, y in ((pa, pb), (sa.mu, sb.mu), (sa.nu, sb.nu))
               for k in x) and all(torch.equal(x, y) for x, y in (
                   (sa.count, sb.count), (sta["loss"], stb["loss"]), (sta["pairs"], stb["pairs"])))
    print(f"maml_pairs_viterbinet T={T_PROTO}: a slot's {K7_ITERATIONS * K7_DRAWS} draws in one "
          f"launch bit-identical to its {K7_ITERATIONS} launches {same}")
    if not same:
        fail("maml_pairs_viterbinet: a slot in one launch differs from its launch by iteration")
    # two launches from the same inputs give the same bits: the cluster sums
    # its partial gradients in a fixed order, with no atomics
    a, b = (k7_slot_run(*inputs, "kernel", iterations=1) for _ in range(2))
    same = all(torch.equal(x[k], y[k]) for x, y in ((a[0], b[0]), (a[1].mu, b[1].mu),
                                                     (a[1].nu, b[1].nu)) for k in x)
    print(f"maml_pairs_viterbinet T={T_PROTO}: two launches from the same inputs bit-identical "
          f"{same}")
    if not same:
        fail("maml_pairs_viterbinet: two launches from the same inputs differ")
    witness = {}
    for seed in K7_WITNESS_SEEDS:
        witness[seed] = d = k7_witness(*k7_slot(seed))
        print(f"maml_pairs_viterbinet float64 witness, seed {seed}, a slot's "
              f"{K7_ITERATIONS * K7_DRAWS} draws: {d} (held: kernel_f64 <= "
              f"{K7_WITNESS_MULTIPLE:g} x autograd_f64 + {K7_WITNESS_FLOOR:g})")
        if not k7_witness_holds(d):
            fail(f"maml_pairs_viterbinet: float64 witness on seed {seed}: {d}")
    return {"max_abs_err": errs["10 pairs"], "by_check": errs, "witness": witness}


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
        busy[name] = profiled_busy(
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


def reference_baselines() -> tuple[dict, dict]:
    """resources/reference_baselines.json and its parity matrix cells (r4's
    added to r3's, as tests/test_parity_anchor.py merges them)."""
    with open(os.path.join(RESOURCES_DIR, "reference_baselines.json")) as f:
        base = json.load(f)
    cells = {**base.get("r3_parity_matrix", {}).get("cells", {}),
             **base.get("r4_parity_matrix", {}).get("cells", {})}
    return base, cells


def phase_anchors() -> dict:
    """Two recorded anchors of the reference (tests/test_parity_anchor.py):
    uncoded full-CSI VA at 10 dB, and VA on the COST2100 channel at 8 dB."""
    base, cells = reference_baselines()
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
    miss = trainable and not os.path.isfile(ckpt_path(weights_dir, 10.0, cfg.gamma))
    # the user path is trainer.evaluate(), whose first step is this load;
    # on the miss it trains, so its time and launches are read apart (the
    # VA loads nothing)
    zero_launches()
    zero_steps()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if trainable:
        trainer.load_weights(10.0, cfg.gamma)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = read_launches()
    train_steps = read_steps()

    tracer = Tracer()
    zero_launches()
    zero_steps()
    events = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with tracer, SyncChecked(contextlib.nullcontext) as checked:
        trainer.spans = checked
        t0 = time.perf_counter()
        events[0].record()
        sers = trainer.evaluate()
        events[1].record()
        torch.cuda.synchronize()
        blocks_s = time.perf_counter() - t0
    blocks_event_s = events[0].elapsed_time(events[1]) / 1e3
    launches = read_launches()
    steps = read_steps()
    result = trainer.online_result
    parts = span_seconds(tracer)
    traced = tracer.summary()
    mean_ber = float(np.mean(sers[di]))
    n_words = cfg.n_words("val")
    want_reads = 1
    print(f"{name} {mode} mode: train-on-miss {train_s:.3f} s (launches {train_launches}); "
          f"300 blocks {blocks_s:.3f} s on the host clock to a synchronise, "
          f"{blocks_event_s:.3f} s between CUDA events; host reads {result.host_reads} "
          f"(expected {want_reads}); sync debug mode 'error' from block {checked.armed_at} to "
          f"the end-of-run read; parts (count, s on the device timeline from the tracer's "
          f"stamps, s on the host clock, which measures the enqueue): "
          f"{parts}")
    blocks = parts.get("block", (0, 0.0, 0.0))[1]
    print(f"{name} {mode} mode: traced window {traced.window_ms:.3f} ms, idle share "
          f"{traced.idle_share:.4f}, idle ms by host span {traced.idle_ms}; the block graph's "
          f"parts {sum(parts.get(p, (0, 0.0, 0.0))[1] for p in BLOCK_PARTS):.4f} s of its "
          f"{blocks:.4f} s on the device; {traced.dropped} stamps dropped; counts "
          f"{traced.counters}")
    if result.host_reads != want_reads:
        fail(f"{name} {mode}: {result.host_reads} host reads, expected {want_reads}")
    if checked.armed_at is None or checked.armed_at >= n_words - 1:
        fail(f"{name} {mode}: the block loop never ran under sync debug mode 'error' "
             f"(armed at {checked.armed_at})")
    print(f"{name} {mode} mode: graphed steps {steps_line(steps, parts)}")
    if miss:
        print(f"{name} {mode} mode: train-on-miss graphed steps {steps_line(train_steps, None)}")
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
        if mode == "meta":  # K7: one launch a slot that fired, all its iterations' pairs
            fired = meta_slots_fired(cfg, sers)
            want["maml_pairs_viterbinet"] = fired
            print(f"{name} {mode} mode: {fired} meta slots fired, "
                  f"{launches['maml_pairs_viterbinet']} K7 launches "
                  f"(expected {want['maml_pairs_viterbinet']}), {result.steps['maml']} MAML pairs")
        if miss:  # one eval per training minibatch
            want_train["fused_viterbinet_detect"] = cfg.train_minibatch_num
        if mode == "meta" and result.n_gated == 0:
            fail(f"{name} {mode}: no block was gated, so K6 never ran")
    if launches != want:
        fail(f"{name} {mode}: by-word launches {launches}, expected {want}")
    if train_launches != want_train:
        fail(f"{name} {mode}: train-on-miss launches {train_launches}, expected {want_train}")
    return {"cfg": cfg, "trainer": trainer, "sers": sers, "mean_data_ber": mean_ber,
            "train_s": train_s, "blocks_s": blocks_s, "blocks_event_s": blocks_event_s,
            "host_reads": result.host_reads, "sync_checked_from_block": checked.armed_at,
            "parts": parts, "launches": launches,
            "train_launches": train_launches, "n_buffer": result.n_buffer,
            "n_gated": result.n_gated, "steps": steps, "train_steps": train_steps}


def meta_slots_fired(cfg: Config, sers: np.ndarray) -> int:
    """The candidate meta slots of a run from an empty buffer at which its
    fill exceeded 2, from the run's SERs: a block is buffered where its SER
    (0 at pilots) passes the gate."""
    if not cfg.buffer_empty:
        fail("meta_slots_fired: the run started from a full buffer")
    gated = np.cumsum(np.asarray(sers) <= np.float32(cfg.ser_thresh))
    return sum(int(min(gated[c], cfg.buffer_capacity) > 2) for c in meta_slots(cfg, len(sers)))


def profiled_blocks(cell: str, name: str, cfg: Config, weights_dir: str | None = None,
                    blocks_s: float | None = None) -> dict:
    """The device's busy time and idle share over the first
    PROFILED_BLOCKS[cell] blocks of a by-word run of detector `name`, under
    torch.profiler: a fresh trainer on the run's checkpoint (in weights_dir,
    else cfg's), so the first val batch of its stream, and its own draws.
    Where that is the whole run and `blocks_s` is the seconds of the run
    without the profiler, also the idle share of that run's wall with the
    profiled busy time: the profiler's record of every replayed kernel
    lengthens the profiled run's wall several times over."""
    n = PROFILED_BLOCKS[cell]
    snr = float(cfg.snr_range("val")[0])
    trainer = Trainer(cfg, name, weights_dir=weights_dir, verbose=False)
    if cfg.self_supervised and not uses_fused_adaptation(cfg, trainer.spec):
        # under torch.profiler (CUPTI) the run faults with an illegal address
        # where a block replays its chunk graph of steps, which holds the
        # gate's IF node, several times (vnet at 25 steps a chunk, lstm at
        # 20 and 2; PERF.md section 6); the same runs without the
        # profiler pass, and K6's one replay a block passes under it
        print(f"{cell}: device busy not measured (torch.profiler faults on the chunk graphs "
              f"of steps under the gate's IF node)")
        return {"blocks": 0, "device_busy_ms": None, "idle_share": None}
    params = trainer.load_weights(snr, cfg.gamma) if trainer.spec.trainable else None
    tx, rx = trainer.val_dataset.get(snr, cfg.gamma)
    h = trainer.decoder_csi(tx.shape[0])
    busy = profiled_busy(lambda: run_online(cfg, trainer.spec, params, tx[:n], rx[:n], h[:n],
                                          trainer.draws))
    per_block = busy["device_activities"] / n
    print(busy_line(f"{cell} {n} by-word blocks (a second run)", busy)
          + f"; {per_block:.1f} device activities a block")
    out = dict(busy, blocks=n, activities_per_block=per_block)
    if blocks_s is not None and n == cfg.n_words("val") and busy["device_activities"]:
        out["idle_share_of_unprofiled_wall"] = 1 - busy["device_busy_ms"] / 1e3 / blocks_s
        print(f"{cell}: its {busy['device_busy_ms']:.3f} ms of device busy time over the "
              f"{blocks_s:.3f} s of the run without the profiler: idle share "
              f"{out['idle_share_of_unprofiled_wall']:.4f}")
    return out


# ------------------------------------------------------- the graphed steps

def no_capture():
    """The by-word engine's steps called directly on the card, as on the
    CPU, with no graph captured or replayed: the same step functions and
    inputs (online/graphs.py)."""
    return mock.patch.object(graphs, "replays_on", lambda device: False)


def zero_steps() -> None:
    GraphedStep.counts.clear()


def read_steps() -> dict:
    """name -> {kind: calls} of the graphed steps since zero_steps()."""
    return copy.deepcopy(GraphedStep.counts)


# the engine's graphed steps, each by its detector family: the
# self-supervised step of vnet online (subsampled CE over states) and lstm
# online (subsampled CE over bits, cuDNN), and the MAML pair step of
# meta_vnet and meta_lstm (the unrolled forward)
STEP_KINDS = ("vnet self-supervised", "lstm self-supervised", "meta_vnet maml", "meta_lstm maml")
# steps timed per kind: eager, and replayed
STEP_TIMED = {"vnet self-supervised": (100, 400), "lstm self-supervised": (50, 200),
              "meta_vnet maml": (20, 100), "meta_lstm maml": (3, 20)}
# how far WARMUP_STEPS + 4 steps replayed may leave the params and moments
# from the same steps called directly (step_run), 0 where not listed.
# meta_lstm's second-order step is not bit-reproducible on the card from
# one set of fresh tensors to the next, eagerly too: its unrolled double
# backward leaves results that depend on where its tensors lie (phase 7c
# prints two eager runs apart), and a graph's tensors lie in its own pool
STEP_TOL = {("meta_lstm maml", True): 1e-6}


def step_case(kind: str, gen: torch.Generator, n_steps: int, second_order: bool = True,
              chunk: int = 1):
    """One of STEP_KINDS at the protocol's shapes (T = 136, Config's
    train_minibatch_size and window_size) with seeded random params and
    inputs on the card, as the engine builds it: returns (params,
    opt_state, run), where run(i) takes step i < n_steps on its own word
    (and its own select_batch draw). A self-supervised step is the engine's
    adapt step (online/engine.py::make_adapt_step) under an open gate; with
    `chunk`, run(i) takes that many steps on word i, one graphed call."""
    cfg = Config()
    family, what = kind.split(" ", 1)
    spec = DETECTORS[family]
    params = spec.model.param_dict(spec.init(cfg, gen, "cuda"))
    opt = Optimizer("Adam", cfg.lr)
    state = opt.init(params)
    w = cfg.window_size
    rx = torch.randn((n_steps + w, T_PROTO), generator=gen, device="cuda")
    tx = torch.randint(0, 2, (n_steps + w, T_PROTO), generator=gen, device="cuda").float()
    if what == "self-supervised":
        loss_fn = make_loss_fn(spec.score, spec.label_kind, cfg.memory_length,
                               spec.subsample_loss, cfg.loss_type)
        adapt = make_adapt_step(cfg, opt, loss_fn, False, chunk)
        idx = None
        if spec.subsample_loss:
            idx = torch.stack([select_batch(T_PROTO, cfg.train_minibatch_size, gen, "cuda")
                               for _ in range(n_steps * chunk)])
        st = {"gate": torch.ones((), dtype=torch.bool, device="cuda"),
              "rx": rx.new_zeros((1, T_PROTO)), "label": rx.new_zeros((1, T_PROTO))}

        def run(i: int) -> None:
            st["rx"].copy_(rx[i:i + 1])
            st["label"].copy_(tx[i:i + 1])
            adapt(params, state, st, None if idx is None else idx[i * chunk:(i + 1) * chunk])
    else:
        loss_fn = make_loss_fn(spec.meta_score, spec.label_kind, cfg.memory_length, False,
                               cfg.loss_type)
        maml = make_maml_step(loss_fn, opt, cfg.meta_lr, second_order)

        def run(i: int) -> None:
            maml(params, state, rx[i:i + w], tx[i:i + w], rx[i + w:i + w + 1],
                 tx[i + w:i + w + 1])
    return params, state, run


def _steps_s(run, first: int, n: int) -> float:
    """Seconds per step of run(first) .. run(first + n - 1), host clock
    to a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(first, first + n):
        run(i)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n


def step_run(kind: str, captured: bool, second_order: bool = True) -> tuple[list, dict]:
    """WARMUP_STEPS + 4 steps of step_case(kind) from a fixed seed, replayed
    (captured) or called directly: the params and moments after them, and
    the calls by kind."""
    n = graphs.WARMUP_STEPS + 4
    zero_steps()
    with contextlib.nullcontext() if captured else no_capture():
        params, state, run = step_case(kind, torch.Generator(device="cuda").manual_seed(7), n,
                                       second_order)
        for i in range(n):
            run(i)
    torch.cuda.synchronize()
    (calls,) = read_steps().values()
    return [t.detach().clone() for group in (params, state.mu, state.nu)
            for t in group.values()], calls


def tensors_apart(a: list, b: list) -> float:
    return max(float((x - y).detach().abs().max()) for x, y in zip(a, b))


def phase_steps(card: str) -> dict:
    """Each of STEP_KINDS eager (capture patched out) and replayed, in one
    process: seconds per step (host clock, after the warm-up), and one step
    of each under torch.profiler, its device activities and busy time (the
    floor a graph can reach). A replayed step launches its activities with
    no host work between them."""
    out = {}
    for kind in STEP_KINDS:
        n_eager, n_graphed = STEP_TIMED[kind]
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        warm = graphs.WARMUP_STEPS + 1
        with no_capture():
            _, _, run = step_case(kind, gen, warm + n_eager + 1)
            for i in range(warm):
                run(i)
            eager_s = _steps_s(run, warm, n_eager)
            eager_busy = profiled_busy(lambda: run(warm + n_eager))
        zero_steps()
        _, _, run = step_case(kind, gen, warm + n_graphed + 1)
        t0 = time.perf_counter()
        for i in range(warm):  # the warm-up steps, the capture and its replay
            run(i)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        graphed_s = _steps_s(run, warm, n_graphed)
        graphed_busy = profiled_busy(lambda: run(warm + n_graphed))
        counts = read_steps()
        print(f"{kind} step at T = {T_PROTO}: eager {1e3 * eager_s:.3f} ms a step over "
              f"{n_eager} steps, replayed {1e3 * graphed_s:.3f} ms a step over {n_graphed} "
              f"({eager_s / graphed_s:.2f}x); the {graphs.WARMUP_STEPS} warm-up steps, the "
              f"capture and its replay {first_s:.3f} s; calls {counts} [{card}]")
        print(busy_line(f"{kind}: one eager step", eager_busy))
        print(busy_line(f"{kind}: one replay", graphed_busy))
        # replayed against called directly, and two direct runs on fresh
        # tensors against each other
        (direct, _), (again, _), (replayed, _) = (step_run(kind, captured)
                                                  for captured in (False, False, True))
        apart = {"replayed_vs_direct": tensors_apart(replayed, direct),
                 "direct_vs_direct": tensors_apart(again, direct)}
        tol = STEP_TOL.get((kind, True), 0.0)
        print(f"{kind}: after {graphs.WARMUP_STEPS + 4} steps the params and moments replayed "
              f"are {apart['replayed_vs_direct']:.3e} from the same steps called directly "
              f"(limit {tol:g}), two direct runs {apart['direct_vs_direct']:.3e} apart")
        if max(apart.values()) > tol:
            fail(f"{kind}: replayed and direct steps apart beyond {tol:g}: {apart}")
        out[kind] = {"eager_s": eager_s, "graphed_s": graphed_s, "first_s": first_s,
                     "eager_busy": eager_busy, "graphed_busy": graphed_busy, "calls": counts,
                     **apart}
        if kind.endswith("self-supervised"):
            out[kind]["chunk"] = chunk_line(kind, gen, graphed_s, card)
    return out


def chunk_line(kind: str, gen: torch.Generator, single_s: float, card: str) -> dict:
    """The engine's self-supervised loop as it runs on the card: a graph of
    chunk_steps(200, STEP_NODES) steps back to back under the gate's IF
    node, replayed 200 / chunk times a gated block; its seconds per step
    (host clock to a synchronise, after the warm-ups and the capture)
    beside the single-step replay's."""
    chunk = chunk_steps(K6_ITERS, DETECTORS[kind.split(" ")[0]].model.STEP_NODES)
    calls = max(3, 2 * K6_ITERS // chunk)
    warm = graphs.WARMUP_STEPS + 1
    zero_steps()
    _, _, run = step_case(kind, gen, warm + calls, chunk=chunk)
    t0 = time.perf_counter()
    for i in range(warm):
        run(i)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    per_step = _steps_s(run, warm, calls) / chunk
    print(f"{kind}: a chunk graph of {chunk} steps under the gate's IF node, {1e3 * per_step:.3f} "
          f"ms a step over {calls * chunk} steps, beside {1e3 * single_s:.3f} ms a step "
          f"replayed one by one ({single_s / per_step:.2f}x); the warm-ups, the capture and its "
          f"replay {first_s:.3f} s; calls {read_steps()} [{card}]")
    return {"chunk": chunk, "s_per_step": per_step, "first_s": first_s, "steps": calls * chunk}


# the block graph's parts, spans inside it (online/engine.py::make_block_step)
BLOCK_PARTS = ("detect.viterbi", "detect.rs_decode", "detect.label")


def steps_line(steps: dict, parts: dict | None) -> str:
    """The graphed steps' calls by name and kind and, where the run was
    traced, the milliseconds per step of the step's spans, on the device
    timeline (the tracer's stamps) and on the host clock (its warm-up steps
    and capture included; a replay returns before its work is done)."""
    out = []
    for name, calls in sorted(steps.items()):
        n = sum(calls.values()) - calls["capture"]
        per = ""
        if parts and name in parts and n:
            _, device_s, host_s = parts[name]
            per = (f", {1e3 * device_s / n:.3f} ms a step on the device, "
                   f"{1e3 * host_s / n:.3f} on the host")
        out.append(f"{name} {n} steps {calls}{per}")
    return "; ".join(out) or "none"


def first_blocks(name: str, cfg: Config, n: int, ways=("graphed", "uncaptured"),
                 trainer: Trainer | None = None) -> dict:
    """The first n blocks of a by-word run of detector `name` from the
    run's checkpoint, on the next val batch of `trainer` (else of a fresh
    Trainer of cfg), with the same blocks and draws (generators seeded
    SEED) for each of `ways`: "graphed" on the card, "uncaptured" on the
    card with capture patched out (no_capture), "cpu" through the CPU's
    plain path ("graphed again" and "uncaptured again" repeat a way). Per
    way: seconds, SER per block, final params, MAML steps, graphed-step
    calls, launches and (on the card) the spans' seconds."""
    snr = float(cfg.snr_range("val")[0])
    trainer = trainer or Trainer(cfg, name, verbose=False)
    trainable = trainer.spec.trainable
    params = trainer.load_weights(snr, cfg.gamma) if trainable else None
    tx, rx = trainer.val_dataset.get(snr, cfg.gamma)
    h = trainer.decoder_csi(tx.shape[0])
    runs = {}
    for way in ways:
        device = "cpu" if way == "cpu" else "cuda"
        captured = way.startswith("graphed")
        draws = Draws(cfg, trainer.spec, torch.device(device),
                      torch.Generator(device=device).manual_seed(SEED),
                      torch.Generator().manual_seed(SEED))
        tracer = Tracer() if device == "cuda" else contextlib.nullcontext()
        zero_launches()
        zero_steps()
        with tracer, contextlib.nullcontext() if captured or device == "cpu" else no_capture():
            t0 = time.perf_counter()
            result = run_online(cfg, trainer.spec,
                                copy.deepcopy(params).cpu() if device == "cpu" and trainable
                                else params,
                                tx[:n].to(device), rx[:n].to(device), h[:n].to(device), draws)
            if device == "cuda":
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        runs[way] = {"s": seconds, "sers": result.ser_by_word, "n_gated": result.n_gated,
                     "params": trainer.spec.model.param_dict(result.params) if trainable else {},
                     "maml_steps": result.steps["maml"], "steps": read_steps(),
                     "launches": read_launches(),
                     "parts": span_seconds(tracer) if device == "cuda" else None}
        print(f"{name} first {n} blocks, {way}: {seconds:.2f} s, {result.n_gated} gated, "
              f"{result.steps['maml']} MAML steps; graphed steps "
              f"{steps_line(runs[way]['steps'], runs[way]['parts'])}")
    return runs


def _params_diff(a: dict, b: dict) -> float:
    if not a["params"]:  # the VA: no params
        return 0.0
    return tensors_apart(list(a["params"].values()), list(b["params"].values()))


def held_graphed(cell: str, runs: dict, card: str, params_tol: float | None = 0.0) -> dict:
    """The graphed run against the uncaptured one of first_blocks: SER per
    block equal, the same launches and MAML pair steps (the device's count),
    and the final params at most
    `params_tol` apart (None: printed only, for meta_lstm, whose
    second-order step is not bit-reproducible on the card, STEP_TOL); prints
    the seconds of each, and where a way ran twice, its two runs' largest
    difference (whether the way is deterministic)."""
    g, u = runs["graphed"], runs["uncaptured"]
    diff = _params_diff(g, u)
    again = {way: _params_diff(runs[way], runs[f"{way} again"])
             for way in ("graphed", "uncaptured") if f"{way} again" in runs}
    if again:
        print(f"{cell}: final params max |diff| between two runs of the same way {again}")
    n = len(g["sers"])
    print(f"{cell} first {n} blocks, graphed against uncaptured: SER per block equal "
          f"{bool(np.array_equal(g['sers'], u['sers']))}, final params max |diff| {diff:.3e}, "
          f"launches {g['launches']} and {u['launches']}, MAML pair steps {g['maml_steps']} and "
          f"{u['maml_steps']}; {g['s']:.2f} s against {u['s']:.2f} s [{card}]")
    if not np.array_equal(g["sers"], u["sers"]):
        fail(f"{cell}: the graphed steps and the same steps uncaptured give other SERs: "
             f"{g['sers'].tolist()} against {u['sers'].tolist()}")
    if g["launches"] != u["launches"]:
        fail(f"{cell}: the graphed run launched {g['launches']}, uncaptured {u['launches']}")
    if g["maml_steps"] != u["maml_steps"]:
        fail(f"{cell}: the graphed run took {g['maml_steps']} MAML pair steps, uncaptured "
             f"{u['maml_steps']}")
    if params_tol is not None and diff > params_tol:
        fail(f"{cell}: the graphed run's final params are {diff} from the uncaptured run's")
    return {"blocks": n, "params_max_abs_diff": diff, "again_max_abs_diff": again,
            "graphed_s": g["s"], "uncaptured_s": u["s"],
            "steps": g["steps"], "uncaptured_steps": u["steps"], "maml_steps": g["maml_steps"],
            "parts": g["parts"], "uncaptured_parts": u["parts"]}


def meta_lstm_estimate(steps: dict, card: str) -> dict:
    """An estimate, not a measurement, of a 300-block meta_lstm run from
    phase_steps' replayed steps: at most META_EVENTS x MAX_STEPS_PER_EVENT
    MAML steps, and at most 200 self-supervised steps on each of the 300
    blocks (an lstm self-supervised step on the whole word costs about as
    much as on its subsample)."""
    maml_s = META_EVENTS * MAX_STEPS_PER_EVENT * steps["meta_lstm maml"]["graphed_s"]
    ss_s = 300 * K6_ITERS * steps["lstm self-supervised"]["graphed_s"]
    print(f"meta_lstm, estimate, not a measurement: a 300-block meta run takes at most "
          f"{META_EVENTS} events x {MAX_STEPS_PER_EVENT} MAML steps x "
          f"{steps['meta_lstm maml']['graphed_s']:.4f} s = {maml_s:.0f} s and 300 blocks x "
          f"{K6_ITERS} self-supervised steps x {steps['lstm self-supervised']['graphed_s']:.5f} "
          f"s = {ss_s:.0f} s, replayed [{card}]")
    return {"maml_s": maml_s, "self_supervised_s": ss_s}


def train_held(name: str, weights_dir: str, card: str) -> dict:
    """Train-on-miss once more with capture patched out (no_capture: the
    word sweep's steps called directly on the card), from a fresh Trainer of
    the joint cell's config in a fresh weights directory, against the
    checkpoint that run_by_word trained, graphed, in `weights_dir`: the two
    checkpoints' params 0 apart, the same launches."""
    cfg = online_cfg("joint", weights_dir)
    graphed = Trainer(cfg, name, verbose=False)
    uncaptured = Trainer(online_cfg("joint", f"{weights_dir}_uncaptured"), name, verbose=False)
    zero_launches()
    zero_steps()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with no_capture():
        uncaptured.load_weights(10.0, cfg.gamma)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, steps = read_launches(), read_steps()
    model = graphed.spec.model
    diff = tensors_apart(list(model.param_dict(graphed.load_weights(10.0, cfg.gamma)).values()),
                         list(model.param_dict(uncaptured.load_weights(10.0, cfg.gamma)).values()))
    print(f"{name} train-on-miss uncaptured: {seconds:.3f} s, launches {launches}, steps "
          f"{steps_line(steps, None)}; its checkpoint's params {diff:.3e} from the graphed "
          f"train-on-miss's [{card}]")
    if diff:
        fail(f"{name}: train-on-miss graphed and uncaptured give params {diff} apart")
    return {"uncaptured_s": seconds, "launches": launches, "steps": steps,
            "params_max_abs_diff": diff}


def phase_online(weights_dir: str, card: str) -> dict:
    out = {}
    meta = run_by_word("meta_vnet", "meta", f"{weights_dir}/meta_vnet", META_VNET_BAND)
    joint = run_by_word("vnet", "joint", f"{weights_dir}/vnet", VNET_JOINT_BAND)
    # the joint cell's checkpoint, adapted on by eager self-supervised steps
    vnet_online = run_by_word("vnet", "online", f"{weights_dir}/vnet", VNET_ONLINE_BAND)
    va_joint = run_by_word("va", "joint", f"{weights_dir}/va", VA_JOINT_BAND)

    # the device's idle share: a second by-word run of each under the
    # profiler, over PROFILED_BLOCKS of its blocks
    for cell, name, run in (("meta_vnet", "meta_vnet", meta), ("vnet", "vnet", joint),
                            ("vnet online", "vnet", vnet_online), ("va", "va", va_joint)):
        run["busy"] = profiled_blocks(cell, name, run["cfg"], blocks_s=run["blocks_s"])

    # the first 25 blocks of each cell: graphed (the per-block detect, and
    # the steps of the cells that adapt) against the same calls uncaptured,
    # and meta_vnet's also through the CPU plain path, from the same params,
    # blocks and draws
    n = CARD_CPU_BLOCKS
    first = first_blocks("meta_vnet", meta["cfg"], n, ("graphed", "uncaptured", "cpu"))
    meta["graphed_vs_uncaptured"] = held_graphed("meta_vnet", first, card)
    for cell, name, run in (("vnet online", "vnet", vnet_online), ("vnet joint", "vnet", joint),
                            ("va joint", "va", va_joint)):
        run["graphed_vs_uncaptured"] = held_graphed(cell, first_blocks(name, run["cfg"], n), card)
    # train-on-miss (the word sweep) graphed against uncaptured
    joint["train_graphed_vs_uncaptured"] = train_held("vnet", f"{weights_dir}/vnet", card)
    sers = {"cuda": first["graphed"]["sers"], "cpu": first["cpu"]["sers"]}
    cfg = meta["cfg"]
    di = np.arange(n)[np.arange(n) % cfg.subframes_in_frame != 0]
    block_diff = float(np.abs(sers["cuda"] - sers["cpu"]).max())
    mean_diff = abs(float(sers["cuda"][di].mean()) - float(sers["cpu"][di].mean()))
    maml = (first["graphed"]["maml_steps"], first["cpu"]["maml_steps"])
    print(f"meta_vnet first {n} blocks, card against CPU: SER per block equal "
          f"{bool(np.array_equal(sers['cuda'], sers['cpu']))}, largest per-block SER difference "
          f"{block_diff:.6f} (limit {CARD_CPU_BLOCK_TOL:.6f}), mean data SER difference "
          f"{mean_diff:.6f} (limit {CARD_CPU_MEAN_TOL:g}), MAML pair steps {maml[0]} and "
          f"{maml[1]}; card {sers['cuda'].tolist()}, CPU {sers['cpu'].tolist()}")
    if block_diff > CARD_CPU_BLOCK_TOL or mean_diff > CARD_CPU_MEAN_TOL:
        fail("meta_vnet: the card and the CPU disagree on the first blocks")
    # the same SERs, so the same fills at the meta slots and the same draws
    if not np.array_equal(sers["cuda"], sers["cpu"]) or maml[0] != maml[1] or not maml[0]:
        fail(f"meta_vnet: the first blocks' SERs or MAML pair steps differ on the card and "
             f"the CPU (pair steps {maml})")
    for name, run in (("meta_vnet_meta", meta), ("vnet_joint", joint),
                      ("vnet_online", vnet_online), ("va_joint", va_joint)):
        out[name] = {k: v for k, v in run.items() if k not in ("cfg", "trainer", "sers")}
    out["card_vs_cpu"] = {"blocks": n, "max_block_ser_diff": block_diff,
                          "mean_data_ser_diff": mean_diff, "maml_steps": maml}
    return out


# the by-word cells timed again alone on the card (phase 5d): (detector,
# mode, the key of its phase 5 or 5b result, its band)
ALONE_CELLS = (("meta_vnet", "meta", "meta_vnet_meta", META_VNET_BAND),
               ("vnet", "joint", "vnet_joint", VNET_JOINT_BAND),
               ("vnet", "online", "vnet_online", VNET_ONLINE_BAND),
               ("va", "joint", "va_joint", VA_JOINT_BAND),
               ("lstm", "online", "lstm_online", LSTM_ONLINE_BAND))


def phase_alone(weights_dir: str, online: dict, lstm_out: dict, card: str) -> dict:
    """The by-word cells once more, alone on the card after phases 5b and
    5c have ended (phase 5 shares the card with their processes): each from
    its checkpoint, through Trainer.evaluate, timed on the host clock to a
    synchronise and between CUDA events, with its host reads. Where phase
    5 loaded the checkpoint too, the mean BER must equal phase 5's (the
    same blocks and draws); where it trained on the miss, whose scoring
    drew val batches first, the run reads another batch and is held to its
    band. Then vnet's train-on-miss (the chunked word sweep) in a fresh
    weights directory."""
    out = {}
    for name, mode, key, band in ALONE_CELLS:
        cfg = online_cfg(mode, f"{weights_dir}/{name}")
        trainer = Trainer(cfg, name, verbose=False)
        if trainer.spec.trainable:
            trainer.load_weights(10.0, cfg.gamma)
        events = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        events[0].record()
        sers = trainer.evaluate()
        events[1].record()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        event_s = events[0].elapsed_time(events[1]) / 1e3
        result = trainer.online_result
        mean_ber = float(np.mean(sers[cfg.data_indices("val")]))
        phase5 = (lstm_out if name == "lstm" else online)[key]
        same_blocks = not phase5["train_steps"]
        print(f"alone: {name} {mode} mode, 300 blocks {seconds:.3f} s on the host clock to a "
              f"synchronise, {event_s:.3f} s between CUDA events; host reads "
              f"{result.host_reads}; {result.n_gated} gated; mean data BER {mean_ber:.6f} "
              f"({'phase 5 on the same blocks' if same_blocks else 'phase 5 on the batch after its train-on-miss'}: "
              f"{phase5['mean_data_ber']:.6f}; band {band[0]} +- {band[1]}) [{card}]")
        if (mean_ber != phase5["mean_data_ber"]) if same_blocks \
                else abs(mean_ber - band[0]) > band[1]:
            fail(f"{name} {mode}: alone {mean_ber}, in phase 5 {phase5['mean_data_ber']}")
        out[key] = {"s": seconds, "event_s": event_s, "host_reads": result.host_reads,
                    "n_gated": result.n_gated, "mean_data_ber": mean_ber}
    trainer = Trainer(online_cfg("joint", f"{weights_dir}/vnet_alone"), "vnet", verbose=False)
    zero_steps()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.load_weights(10.0, trainer.cfg.gamma)
    torch.cuda.synchronize()
    out["vnet_train_on_miss_s"] = time.perf_counter() - t0
    print(f"alone: vnet train-on-miss {out['vnet_train_on_miss_s']:.3f} s, graphed steps "
          f"{steps_line(read_steps(), None)} [{card}]")
    return out


@contextlib.contextmanager
def harness_dirs(root: str):
    """The experiment harness's weights and curve-cache directories under
    `root` (plotters/experiments.py's WEIGHTS_DIR, plotters/cache.py's
    PLOTS_DIR) for the duration, and the list of the Trainers that
    build_curve makes there (their weights_dir and online_result)."""
    made = []

    class RecordedTrainer(Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    saved = experiments.WEIGHTS_DIR, cache.PLOTS_DIR, experiments.Trainer
    experiments.WEIGHTS_DIR, cache.PLOTS_DIR = f"{root}/weights", f"{root}/plots"
    experiments.Trainer = RecordedTrainer
    try:
        yield made
    finally:
        experiments.WEIGHTS_DIR, cache.PLOTS_DIR, experiments.Trainer = saved


def phase_sweep(root: str, card: str) -> dict:
    """The experiment harness on the card: experiments.build_curve, the
    per-curve path of run_sweep with its curve cache, over
    sweep_config(SWEEP_SNR, 120, 2, "cost2100") (300 blocks of 120 info bits
    + RS nsym=2 on the COST2100 test channel, type-2 fading, train-on-miss
    on the time-decay train channel, weights_init=last_frame), in temporary
    weights and cache directories. Each curve's mean coded BER over the 288
    data blocks is held to its band (SWEEP_CURVES), beside the JAX package's
    value of the curve at that SNR (resources/sweep_cost2100.json: the mean
    over all 300 blocks). Then one curve again without run_over: the array
    of its pickle, with no kernel launched.

    Depth cut: one SNR of the six and six curves of the seven. OnlineRNN
    (meta_lstm) is not run here: it has no reference band at 8 dB (the JAX
    package's own curve collapsed there, to 0.268111), and its 300 blocks
    take ~10 min on the card; scripts/torch_sweep_curve.py runs it at 11 dB,
    where its band is, in a call of its own. No figure is rendered (the
    card's machine has no matplotlib); tests/test_torch_plotters.py renders
    the curves on the CPU."""
    _, cells = reference_baselines()
    with open(os.path.join(RESOURCES_DIR, "sweep_cost2100.json")) as f:
        jax_sweep = json.load(f)
    jax_at = jax_sweep["snrs_db"].index(SWEEP_SNR)
    cfg = experiments.sweep_config(SWEEP_SNR, 120, 2, "cost2100")
    di = cfg.data_indices("val")
    specs = {c.method_name: c for c in experiments.CURVES}
    out = {}
    with harness_dirs(root) as trainers:
        for name, (cell, tol) in SWEEP_CURVES.items():
            spec = specs[name]
            ref = float(np.mean(cells[cell]["points"][str(SWEEP_SNR)]["ref"]))
            zero_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ser = experiments.build_curve(spec, cfg, run_over=True, verbose=False)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = read_launches()
            trainer = trainers[-1]
            n_gated = trainer.online_result.n_gated
            mean_ber = float(np.mean(ser[di]))
            jax_ber = jax_sweep["mean_coded_ber"][name][jax_at]
            print(f"sweep {name} ({spec.detector}) at {SWEEP_SNR:g} dB on COST2100: mean coded BER "
                  f"over the {len(di)} data blocks {mean_ber:.6f} (reference {ref:.6f} +- {tol}, "
                  f"{cell}); over all {len(ser)} blocks {float(np.mean(ser)):.6f} (the JAX "
                  f"package's curve: {jax_ber}); {seconds:.3f} s; {n_gated} gated blocks; "
                  f"launches {launches} [{card}]")
            if ser.shape != (cfg.n_words("val"),) or not np.all((ser >= 0) & (ser <= 1)):
                fail(f"sweep {name}: the curve is not {cfg.n_words('val')} SERs in [0, 1]")
            if abs(mean_ber - ref) > tol:
                fail(f"sweep {name}: mean data BER {mean_ber} outside {ref} +- {tol}")
            # K1 once per train-on-miss minibatch (the two ViterbiNet
            # curves share one checkpoint), K5 or K2 per block, K6 per gated
            # meta block, K7 once per meta slot that fired; none for the
            # LSTM family
            want = dict.fromkeys(KERNELS, 0)
            if spec.detector == "va":
                want["fused_va_detect"] = cfg.n_words("val")
            elif spec.detector != "lstm":
                want["viterbi_decode_kernel"] = cfg.n_words("val")
                if name != "ViterbiNet":
                    want["fused_viterbinet_detect"] = cfg.train_minibatch_num
                if spec.online_meta:
                    want["online_adapt_viterbinet"] = n_gated
                    want["maml_pairs_viterbinet"] = meta_slots_fired(trainer.cfg, ser)
                    if n_gated == 0:
                        fail(f"sweep {name}: no block was gated, so K6 never ran")
            if launches != want:
                fail(f"sweep {name}: launches {launches}, expected {want}")
            busy = profiled_blocks(name, spec.detector, trainer.cfg, trainer.weights_dir)
            out[name] = {"ser": ser, "mean_data_ber": mean_ber, "reference": ref, "band": tol,
                         "mean_ber_300": float(np.mean(ser)), "jax_package_ber_300": jax_ber,
                         "s": seconds, "n_gated": n_gated, "launches": launches, "busy": busy}

        name = "Joint ViterbiNet"
        zero_launches()
        t0 = time.perf_counter()
        again = experiments.build_curve(specs[name], cfg, verbose=False)
        cached_s = time.perf_counter() - t0
        cached_launches = read_launches()
        n_pickles = len(os.listdir(cache.PLOTS_DIR))
    same = np.array_equal(again, out[name]["ser"])
    print(f"sweep {name} again without run_over: from the cache ({n_pickles} pickles) in "
          f"{cached_s:.3f} s, equal to the computed curve {same}, launches {cached_launches}")
    if not same or any(cached_launches.values()) or n_pickles != len(SWEEP_CURVES):
        fail(f"sweep {name}: the cached call differs or launched a kernel: {cached_launches}")
    for run in out.values():
        del run["ser"]
    out["cached"] = {"curve": name, "s": cached_s, "launches": cached_launches}
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


def no_launches(what: str, launches: dict) -> None:
    if any(launches.values()):
        fail(f"{what}: an LSTM path launched a ViterbiNet or VA kernel: {launches}")


def in_child(fn, *args) -> tuple:
    """fn(*args) in a worker process of phase 5b or 5c, on CHILD_CPU_THREADS of
    torch's CPU threads: its result, what it printed and its seconds."""
    torch.set_num_threads(CHILD_CPU_THREADS)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue(), time.perf_counter() - t0


def start_beside(pool: concurrent.futures.Executor, weights_dir: str, card: str) -> list:
    """Phases 5b and 5c in three worker processes: the LSTM family on the
    card at full width (the aggregated point and the lstm joint and lstm
    online cells in one, meta_lstm in another; no path of it may launch one
    of the six kernels) and the sweep (phase_sweep) in the third. Each
    process counts its own launches. Each is a host-bound loop of eager
    launches on one core that leaves the card idle most of the time; one
    after another, after phase 5, the LSTM's took 811 s of a 1028 s run on
    an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 5), and the sweep in
    the main process took the script to 917 s. So they run beside phases
    5-7 and the main process waits for them before phase 8 times the
    kernels."""
    return [pool.submit(in_child, lstm_cells, weights_dir, card),
            pool.submit(in_child, meta_lstm_cell, f"{weights_dir}/meta_lstm", card),
            pool.submit(in_child, phase_sweep, f"{weights_dir}/sweep", card)]


def finish_beside(jobs: list) -> tuple[dict, dict]:
    """Wait for the processes of phases 5b and 5c and print what they
    printed; returns the LSTM family's results and the sweep's."""
    ((cells, cells_text, cells_s), (meta, meta_text, meta_s),
     (sweep, sweep_text, sweep_s)) = (job.result() for job in jobs)
    print("lstm (phase 5b, two processes beside phases 5-7):")
    print(cells_text + meta_text, end="")
    print(f"lstm cells process {cells_s:.1f} s, meta_lstm process {meta_s:.1f} s")
    print("sweep (phase 5c, a process beside phases 5-7):")
    print(sweep_text, end="")
    print(f"sweep process {sweep_s:.1f} s")
    lstm_out = dict(cells, meta_lstm=meta, process_seconds={"cells": cells_s, "meta_lstm": meta_s})
    return lstm_out, dict(sweep, process_seconds=sweep_s)


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
    busy = profiled_busy(lambda: trainer.single_eval_at_point(model, 10.0, cfg.gamma))
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
        out[key]["busy"] = profiled_blocks(f"lstm {mode}", "lstm", run["cfg"],
                                           blocks_s=run["blocks_s"])
    out["lstm_online"]["graphed_vs_uncaptured"] = held_graphed(
        "lstm online", first_blocks("lstm", online_cfg("online", f"{weights_dir}/lstm"),
                                    CARD_CPU_BLOCKS), card)
    out["lstm_joint"]["train_graphed_vs_uncaptured"] = train_held("lstm", f"{weights_dir}/lstm",
                                                                  card)
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
    event, graphed and uncaptured on the card and on the CPU. Runs in a
    process of its own (see start_beside)."""
    mcfg = online_cfg("meta", weights_dir)
    mtrainer = Trainer(mcfg, "meta_lstm", verbose=False)
    zero_launches()
    zero_steps()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mtrainer.load_weights(10.0, mcfg.gamma)
    torch.cuda.synchronize()
    meta_train_s = time.perf_counter() - t0
    meta_train_steps = read_steps()
    no_launches("meta_lstm meta_train", read_launches())
    print(f"meta_lstm meta_train on the miss: {meta_train_s:.2f} s for "
          f"{mcfg.train_minibatch_num} minibatches; graphed steps "
          f"{steps_line(meta_train_steps, None)} [{card}]")

    # the val batch after meta_train's (its minibatch scores drew val
    # batches), whose first meta event is at block 5
    n = META_LSTM_BLOCKS
    runs = first_blocks("meta_lstm", mcfg, n, ("graphed", "graphed again", "uncaptured",
                                               "uncaptured again", "cpu"), mtrainer)
    for way in ("graphed", "uncaptured"):
        no_launches(f"meta_lstm by-word blocks, {way}", runs[way]["launches"])
    if not runs["graphed"]["maml_steps"]:
        fail(f"meta_lstm: no meta event in the first {n} blocks")
    pair_steps = {way: run["maml_steps"] for way, run in runs.items()}
    if len(set(pair_steps.values())) != 1:
        fail(f"meta_lstm: the ways took other MAML pair steps: {pair_steps}")
    held = held_graphed("meta_lstm", runs, card, params_tol=None)
    block_diff = float(np.abs(runs["graphed"]["sers"] - runs["cpu"]["sers"]).max())
    print(f"meta_lstm first {n} blocks, card against CPU: largest per-block SER difference "
          f"{block_diff:.6f} (limit {CARD_CPU_BLOCK_TOL:.6f}); card "
          f"{runs['graphed']['sers'].tolist()}, CPU {runs['cpu']['sers'].tolist()}")
    if block_diff > CARD_CPU_BLOCK_TOL:
        fail("meta_lstm: the card and the CPU disagree on the first blocks")
    return {"meta_train_s": meta_train_s, "meta_train_steps": meta_train_steps, "blocks": n,
            "max_block_ser_diff": block_diff, "card_s": runs["graphed"]["s"],
            "cpu_s": runs["cpu"]["s"], "maml_steps": runs["graphed"]["maml_steps"],
            "graphed_vs_uncaptured": held}


# `python -m metaviterbinet_tpu_torch` with the libraries that the port's
# readers stand in for blocked
CLI_WITHOUT_READERS = ("import runpy, sys\n"
                       "for name in ('yaml', 'msgpack', 'flax'): sys.modules[name] = None\n"
                       "runpy.run_module('metaviterbinet_tpu_torch', run_name='__main__')")


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
    VA from `python -m metaviterbinet_tpu_torch` in a subprocess, once from
    --set and once from --config of the vnet directory's config.yaml."""
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

    # the VA from the CLI in a subprocess, from --set and from --config (the
    # vnet cells' provenance: the by-word protocol at 10 dB), each against
    # the same eval in process; the subprocess runs `python -m` with yaml,
    # msgpack and flax blocked, so --config goes through the port's own
    # reader whether or not the machine has them
    provenance = os.path.join(vnet_dir, "config.yaml")
    out = {"vnet_chunked": chunked, "vnet_unchunked": plain, "launches": chunked_launches}
    for key, args, cfg in (
            ("va", ["--snr", "10", "--set", "val_frames=12"],
             Config(val_frames=12, val_SNR_start=10.0, val_SNR_end=10.0)),
            ("va_config", ["--config", provenance], load_config(provenance))):
        argv = ["evaluate", "--detector", "va", *args]
        shown = "python -m metaviterbinet_tpu_torch (yaml, msgpack, flax blocked) " + " ".join(argv)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", CLI_WITHOUT_READERS, *argv], cwd=ROOT_DIR,
                              env=dict(os.environ, PYTHONPATH=ROOT_DIR), capture_output=True,
                              text=True, timeout=600)
        sub_s = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"{shown}: exit code {proc.returncode}\n{proc.stderr[-4000:]}")
        sub = json.loads(proc.stdout.strip().splitlines()[-1])
        in_process = float(Trainer(cfg, "va", verbose=False).evaluate().mean())
        print(f"{shown}: exit 0 in {sub_s:.1f} s, last line {sub}; in process {in_process}")
        if sub["mean_ser"] != in_process or sub["eval_mode"] != cfg.eval_mode:
            fail(f"cli subprocess {sub} differs from in process {in_process} ({cfg.eval_mode})")
        out.update({f"{key}_subprocess": sub, f"{key}_in_process": in_process,
                    f"{key}_subprocess_s": sub_s})
    return out


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
    specs = {dtype: Trainer(cfg.replace(dtype=dtype), "meta_vnet", params=model,
                            verbose=False).spec for dtype in ("float32", "bfloat16")}
    fused = {dtype: uses_fused_adaptation(cfg.replace(dtype=dtype), spec)
             for dtype, spec in specs.items()}
    fused_maml = {dtype: uses_fused_maml(cfg.replace(dtype=dtype), spec)
                  for dtype, spec in specs.items()}
    print(f"bf16 word sweep over {ttx.shape[0]} words: loss {loss:.4f} ({sweep_s:.2f} s); "
          f"uses_fused_adaptation for meta_vnet: {fused}; uses_fused_maml: {fused_maml}")
    if not np.isfinite(loss) or not all(bool(torch.isfinite(p).all()) for p in params.values()):
        fail(f"bf16 word sweep: loss {loss} or params not finite")
    if fused != {"float32": True, "bfloat16": False}:
        fail(f"bf16: K6 must not run the bf16 self-supervised step: {fused}")
    if fused_maml != {"float32": True, "bfloat16": False}:
        fail(f"bf16: K7 must not run the bf16 MAML pairs: {fused_maml}")

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


def va_long_priors(W: int, T: int, gen: torch.Generator) -> torch.Tensor:
    """The full-CSI VA's branch metrics of kernel_inputs' words at 10 dB."""
    y, mu = kernel_inputs(W, T, gen)
    return va.branch_priors_from_mu(y, mu).contiguous()


# the launches of the mesh_shape=(1,) runs of phase 7b; every other kernel's is 0
MESH_LAUNCHES = {"fused_va_detect": 6, "fused_viterbinet_detect": 1,
                 "fused_viterbinet_detect_chunked": 1}


def k5_plain_in_decode():
    """parallel/decode.py's decodes through K5's plain version on the card."""
    return mock.patch.object(parallel_decode, "viterbi_decode_kernel",
                             acs.viterbi_decode_kernel_plain)


def phase_parallel(trained: viterbinet.ViterbiNet, gen: torch.Generator) -> dict:
    """The parallel layer on one card: a world-1 NCCL group, so the
    collectives are real but have one rank. Checks only; its times would
    share the card with phases 5b and 5c."""
    init_distributed()
    backend, world = dist.get_backend(), dist.get_world_size()
    print(f"parallel: process group backend {backend}, world size {world}")
    if (backend, world) != ("nccl", 1):
        fail(f"init_distributed on the card formed a {backend} group of {world}")

    # the aggregated protocol words-sharded over a 'dp' mesh of one rank
    # (Config.mesh_shape), each run beside its mesh-less twin from the same
    # seeds
    cfg = Config(val_frames=12, val_SNR_start=7.0, val_SNR_end=12.0)
    vnet_cfg = cfg.replace(val_SNR_start=10.0, val_SNR_end=10.0)
    runs = {"va 7..12 dB": (cfg, "va", None),
            "vnet (trained) 10 dB, eval_time_chunks=0": (vnet_cfg, "vnet", trained),
            "vnet (trained) 10 dB, eval_time_chunks=4":
                (vnet_cfg.replace(eval_time_chunks=4), "vnet", trained)}
    zero_launches()
    mesh_bers = {name: Trainer(c.replace(mesh_shape=(1,)), det, params=p, verbose=False).evaluate()
                 for name, (c, det, p) in runs.items()}
    mesh_launches = read_launches()
    for name, (c, det, p) in runs.items():
        plain = Trainer(c, det, params=p, verbose=False).evaluate()
        print(f"mesh_shape=(1,) {name}: coded BER {mesh_bers[name].tolist()}, without a mesh "
              f"{plain.tolist()}, bit-equal {np.array_equal(mesh_bers[name], plain)}")
        if not np.array_equal(mesh_bers[name], plain):
            fail(f"mesh_shape=(1,) {name}: {mesh_bers[name]} differs from {plain}")
    print(f"mesh_shape=(1,) launches: {mesh_launches}")
    if mesh_launches != dict.fromkeys(KERNELS, 0) | MESH_LAUNCHES:
        fail(f"the sharded protocol did not go through K2 6, K1 1, K4 1 and no other "
             f"kernel: {mesh_launches}")

    # the sequence-parallel decode over a one-rank 'sp' axis and the chunked
    # decode, each one K5 launch (at 128 x 8224 and 4096 x 288), against the
    # same decode through K5's plain version, and against the sequential K5
    # and its plain version at 128 x 8192
    priors = va_long_priors(SP_W, SP_T, gen)
    seq = acs.viterbi_decode_kernel(priors)
    seq_plain = acs.viterbi_decode_kernel_plain(priors)
    check_bits("viterbi_decode_kernel (sequential)", SP_W, SP_T, seq, seq_plain, 0.0)
    decode_runs = {
        "sequence_parallel_decode": lambda p, ov: sequence_parallel_decode(
            make_mesh((1, 1)), ov)(p),
        f"chunked_decode_reference C={SP_CHUNKS}": lambda p, ov: chunked_decode_reference(
            p, SP_CHUNKS, ov)}
    decodes = {}
    for name, run in decode_runs.items():
        zero_launches()
        bits = run(priors, OVERLAP)
        launches = read_launches()
        with k5_plain_in_decode():
            bits_plain = run(priors, OVERLAP)
        check_bits(f"{name} overlap={OVERLAP}", SP_W, SP_T, bits, bits_plain, 0.0,
                   against="the same decode through K5's plain version")
        check_bits(f"{name} overlap={OVERLAP}", SP_W, SP_T, bits, seq_plain, 0.0,
                   against="the plain sequential decode")
        mismatches = int((bits != seq).sum())
        print(f"{name} overlap={OVERLAP} on VA priors at 10 dB, {SP_W} x {SP_T}: {mismatches} "
              f"bits apart from sequential K5; launches {launches}")
        if mismatches or launches["viterbi_decode_kernel"] != 1 or \
                sum(launches.values()) != 1:
            fail(f"{name}: {mismatches} bits apart, launches {launches}")
        decodes[name] = {"mismatches": mismatches, "launches": launches}
    noise = torch.randn((SP_W, SP_T, 16), generator=gen, device="cuda")
    seq_noise = acs.viterbi_decode_kernel(noise)
    noise_rates = {}
    for overlap in (OVERLAP, 2 * OVERLAP):
        bits = chunked_decode_reference(noise, SP_CHUNKS, overlap)
        noise_rates[overlap] = float((bits != seq_noise).float().mean())
    print(f"chunked_decode_reference C={SP_CHUNKS} on N(0,1) priors: mismatch rate by overlap "
          f"{noise_rates} (not gated: such priors hardly tell the states apart)")
    del priors, seq, noise, seq_noise

    # viterbi_decode_lowlat against K5
    rng = np.random.default_rng(0)
    lowlat = {}
    for shape in ((8, 37, 16), (1, T_PROTO, 16)):
        p = torch.as_tensor(rng.integers(0, 12, size=shape).astype(np.float32), device="cuda")
        equal = torch.equal(viterbi_decode_lowlat(p), acs.viterbi_decode_kernel(p))
        print(f"viterbi_decode_lowlat {shape} integer priors: equal to K5 {equal}")
        if not equal:
            fail(f"viterbi_decode_lowlat {shape}: differs from K5 on integer priors")
        lowlat[f"integer {shape}"] = equal
    p = torch.as_tensor(np.random.default_rng(1).normal(size=(16, T_PROTO, 16))
                        .astype(np.float32) ** 2, device="cuda")
    agree = float((viterbi_decode_lowlat(p) == acs.viterbi_decode_kernel(p)).float().mean())
    print(f"viterbi_decode_lowlat (16, {T_PROTO}, 16) float priors: {agree:.6f} of the bits equal "
          f"to K5 (at least {LOWLAT_AGREEMENT})")
    if agree < LOWLAT_AGREEMENT:
        fail(f"viterbi_decode_lowlat: {agree} agreement with K5 on float priors")
    lowlat["float agreement"] = agree

    # one data-parallel SGD step over a one-rank 'dp' axis against the same
    # step with no collective
    model = viterbinet.init_params(16, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    twin = copy.deepcopy(model)
    params, twin_params = viterbinet.param_dict(model), viterbinet.param_dict(twin)
    loss_fn = make_loss_fn(viterbinet.logits, "states", 4, False)
    opt = Optimizer("SGD", 0.1)
    rx = torch.randn((16, 40), generator=gen, device="cuda")
    tx = torch.randint(0, 2, (16, 40), generator=gen, device="cuda").float()
    _, _, loss_dp = make_dp_train_step(make_mesh((1,), ("dp",)), loss_fn, opt)(
        params, opt.init(params), rx, tx)
    loss = loss_fn(twin_params, rx, tx)
    grads = torch.autograd.grad(loss, list(twin_params.values()))
    opt.step(twin_params, dict(zip(twin_params, grads)), opt.init(twin_params))
    dp_diff = max([abs(float(loss_dp) - loss.item())] +
                  [float((params[k] - twin_params[k]).abs().max()) for k in params])
    print(f"make_dp_train_step (SGD 0.1, 16 x 40) at world size 1: max |diff| {dp_diff:.3e} "
          "against the step with no collective (limit 1e-6)")
    if not dp_diff <= 1e-6:
        fail(f"make_dp_train_step: {dp_diff} from the step with no collective")
    dist.destroy_process_group()
    return {"backend": backend, "world_size": world,
            "mesh_coded_ber": {k: v.tolist() for k, v in mesh_bers.items()},
            "mesh_launches": mesh_launches, "decodes": decodes,
            "noise_mismatch_by_overlap": noise_rates, "lowlat": lowlat, "dp_step_diff": dp_diff}


BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "best", "worst", "spread_pct",
              "methodology", "e2e_eval")


def phase_bench() -> dict:
    """`python -m metaviterbinet_tpu_torch bench` in a process of its own,
    alone on the card: its last line has bench.py's keys and a positive
    value."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "metaviterbinet_tpu_torch", "bench"],
                          cwd=ROOT_DIR, env=dict(os.environ, PYTHONPATH=ROOT_DIR),
                          capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"bench: exit code {proc.returncode}\n{proc.stderr[-4000:]}")
    lines = proc.stdout.strip().splitlines()
    line = json.loads(lines[-1])
    print(f"bench ({seconds:.1f} s): {lines[-2]}")
    print(f"bench: {lines[-1]}")
    missing = [k for k in BENCH_KEYS if k not in line]
    if missing or not line["value"] > 0:
        fail(f"bench: keys missing {missing} or value {line.get('value')} not positive")
    return dict(line, seconds=seconds, card_line=lines[-2])


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
    # phase 7b's decodes: the (min,+) prefix decode at one word beside K5 on
    # the same priors, and the chunked decode beside one sequential K5 at
    # the long-stream size
    p = torch.as_tensor(np.random.default_rng(1).normal(size=(1, T_PROTO, 16))
                        .astype(np.float32) ** 2, device="cuda")
    lowlat = {"ms": graph_ms(lambda: viterbi_decode_lowlat(p)),
              "call_ms": call_ms(lambda: viterbi_decode_lowlat(p)),
              "k5_ms": graph_ms(lambda: acs.viterbi_decode_kernel(p)),
              "k5_call_ms": call_ms(lambda: acs.viterbi_decode_kernel(p))}
    print(f"width viterbi_decode_lowlat 1 x {T_PROTO}: {lowlat['ms']:.5f} ms on the device, "
          f"{lowlat['call_ms']:.5f} ms per eager call; K5 on the same priors "
          f"{lowlat['k5_ms']:.5f} ms on the device, {lowlat['k5_call_ms']:.5f} ms per eager call "
          f"[{card}]")
    priors = va_long_priors(SP_W, SP_T, gen)
    chunked = {"ms": graph_ms(lambda: chunked_decode_reference(priors, SP_CHUNKS, OVERLAP),
                              per_graph=5, replays=5),
               "sequential_k5_ms": graph_ms(lambda: acs.viterbi_decode_kernel(priors),
                                            per_graph=5, replays=5),
               "bound_ms": decode_bound_ms(SP_W, SP_T, 16)[0]}
    ext = OVERLAP + SP_T // SP_CHUNKS
    print(f"width chunked_decode_reference {SP_W} x {SP_T}, C={SP_CHUNKS}, overlap={OVERLAP} (one "
          f"K5 over {SP_W * SP_CHUNKS} chains of {ext} steps, with the warm-up copies): "
          f"{chunked['ms']:.5f} ms on the device; sequential K5 over {SP_W} chains of {SP_T} steps "
          f"{chunked['sequential_k5_ms']:.5f} ms; K5's bound at {SP_W} x {SP_T} "
          f"{chunked['bound_ms']:.5f} ms [{card}]")
    del priors
    times["lowlat"], times["chunked_decode"] = lowlat, chunked
    params, y, states = adapt_inputs()
    state = Optimizer("Adam", 1e-3).init(params)
    # the plain version reads the count to the host: timed with a count on
    # the host, so that a graph can hold it (the kernel's count stays on the
    # card, gathered and advanced there)
    plain_state = copy.copy(state)
    plain_state.count = torch.zeros((), dtype=torch.int32)
    bound = adapt_bound_ms(T_PROTO, 16, K6_ITERS)
    record("online_adapt_viterbinet", 1,
           lambda: online_sgd.online_adapt_viterbinet(params, state, y, states, K6_ITERS, 1e-3,
                                                      ADAM_B1, ADAM_B2, ADAM_EPS),
           lambda: online_sgd.online_adapt_viterbinet_plain(params, plain_state, y, states,
                                                            K6_ITERS, 1e-3, ADAM_B1, ADAM_B2,
                                                            ADAM_EPS),
           bound, per_graph=2, plain_per_graph=1)
    times[("online_adapt_viterbinet", 1)]["checked"] = k6_new_abi(card)
    # K7 at one launch of a slot's 10 draws (its duplicates masked), T = 136
    k7_params, k7_rx, k7_tx, k7_draws = k7_slot(K7_WITNESS_SEEDS[0])
    # and a slot's K7_ITERATIONS x K7_DRAWS draws as one call (the
    # engine's): each iteration's sorted and masked within itself, one launch
    k7 = {}
    for path, fn, draws in (("kernel", maml_pairs.maml_pairs_viterbinet, k7_draws[0]),
                            ("plain", maml_pairs.maml_pairs_viterbinet_plain, k7_draws[0]),
                            ("slot", maml_pairs.maml_pairs_viterbinet, k7_draws)):
        p = {k: v.clone() for k, v in k7_params.items()}
        opt = Optimizer("Adam", K7_LR)
        state = opt.init(p)
        st = {"rx": k7_rx, "tx": k7_tx, "loss": torch.zeros((), device="cuda"),
              "pairs": torch.zeros((), dtype=torch.int32, device="cuda")}
        first = torch.zeros(1, dtype=torch.int64, device="cuda")
        run = k7_pairs(fn, opt)
        k7[path] = functools.partial(
            masked_pairs, run, lambda st, j: (st["rx"][j[:, None] - 1], st["tx"][j[:, None] - 1],
                                              st["rx"][j[:, None]], st["tx"][j[:, None]]),
            p, state, st, draws, first, draws.numel())
    # the plain version reads the mask to the host, so no graph holds it:
    # timed eagerly only
    k7_pairs_taken = len(set(k7_draws[0].tolist()))
    k7_bound = 1e3 * k7_pairs_taken * counts.maml_pair_ops(T_PROTO, 16, 1) / F32_FLOP_PER_S
    row = times[("maml_pairs_viterbinet", K7_DRAWS)] = {
        "ms": graph_ms(k7["kernel"], per_graph=2), "call_ms": call_ms(k7["kernel"]),
        "plain_ms": None, "plain_call_ms": call_ms(k7["plain"], reps=5, warmup=1),
        "bound_ms": k7_bound, "bound_by": "operations", "pairs_taken": k7_pairs_taken}
    print(f"width maml_pairs_viterbinet {K7_DRAWS} draws x T={T_PROTO}: kernel {row['ms']:.5f} "
          f"ms on the device, {row['call_ms']:.5f} ms per eager call (with the sort, mask, "
          f"gather and labels); plain {row['plain_call_ms']:.4f} ms per eager call; "
          f"{k7_pairs_taken} draws taken, {counts.maml_pair_ops(T_PROTO, 16, 1):.4e} f32 "
          f"operations a pair: bound {k7_bound:.5f} ms at the card's f32 rate, "
          f"{k7_bound * N_SMS / maml_pairs.CLUSTER_SIZE:.4f} ms at its cluster's share; "
          f"{1e3 * row['ms'] / k7_pairs_taken:.3f} us a pair on the device [{card}]")
    slot_taken = sum(len(set(d.tolist())) for d in k7_draws)
    slot_bound = 1e3 * slot_taken * counts.maml_pair_ops(T_PROTO, 16, 1) / F32_FLOP_PER_S
    slot_draws = K7_ITERATIONS * K7_DRAWS
    slot = times[("maml_pairs_viterbinet", slot_draws)] = {
        "ms": graph_ms(k7["slot"], per_graph=1, replays=5), "call_ms": call_ms(k7["slot"], reps=5),
        "bound_ms": slot_bound, "bound_by": "operations", "pairs_taken": slot_taken}
    print(f"width maml_pairs_viterbinet {K7_ITERATIONS} x {K7_DRAWS} draws (a slot, one call) x "
          f"T={T_PROTO}: kernel {slot['ms']:.5f} ms on the device, {slot['call_ms']:.5f} ms per "
          f"eager call (with the sort, mask, gather and labels); {slot_taken} draws taken: "
          f"bound {slot_bound:.5f} ms at the card's f32 rate, "
          f"{slot_bound * N_SMS / maml_pairs.CLUSTER_SIZE:.4f} ms at its cluster's share; "
          f"{1e3 * slot['ms'] / slot_taken:.3f} us a pair on the device [{card}]")
    cluster = online_sgd.CLUSTER_SIZE
    k6 = times[("online_adapt_viterbinet", 1)]
    print(f"online_adapt_viterbinet: {adapt_ops(T_PROTO, 16, K6_ITERS):.4e} f32 operations for "
          f"{K6_ITERS} steps at T={T_PROTO}; bound {bound[0]:.5f} ms at the card's f32 rate, "
          f"{bound[0] * N_SMS / cluster:.4f} ms at the share of its cluster of {cluster} CTAs, "
          f"{bound[0] * N_SMS:.4f} ms at one SM's share; {1e3 * k6['ms'] / K6_ITERS:.3f} us per "
          f"step on the device [{card}]")
    return times


def k6_new_abi(card: str) -> dict:
    """K6 with its start powers gathered from device memory at the device
    count, at the engine's T = 136: 40 steps and a resumed 40 (from a
    device count of 40) against its plain version, two launches from the
    same inputs bit-identical, and the float64 witness (40 + 40 steps) on
    the first witness word."""
    params, y, states = adapt_inputs(1)
    state = Optimizer("Adam", 1e-3).init(params)
    (pk, sk), (pp, sp), (pb, sb) = (_copy_state(params, state) for _ in range(3))
    out = {}
    for label in ("40 steps", "resumed 40 + 40"):
        for p, s in ((pk, sk), (pb, sb)):
            online_sgd.online_adapt_viterbinet(p, s, y, states, 40, 1e-3)
        online_sgd.online_adapt_viterbinet_plain(pp, sp, y, states, 40, 1e-3)
        out[label] = _max_diff(pk, pp)
    same = all(torch.equal(a[k], b[k]) for a, b in ((pk, pb), (sk.mu, sb.mu), (sk.nu, sb.nu))
               for k in pk)
    counts = (int(sk.count), int(sp.count))
    witness = k6_witness(*k6_witness_word(*K6_WITNESS_WORDS[0]))
    print(f"online_adapt_viterbinet (start powers from device memory) T={T_PROTO}: max |dparam| "
          f"vs the plain version {out} (limits {K6_LIMITS['40 steps']:g}, "
          f"{K6_LIMITS['resumed 40 + 40']:g}), counts {counts}, two launches bit-identical "
          f"{same}; float64 witness on word {K6_WITNESS_WORDS[0]} {witness}, holds "
          f"{witness_holds(witness)} [{card}]")
    if (not same or counts != (80, 80) or not witness_holds(witness)
            or any(err > K6_LIMITS[label] for label, err in out.items())):
        fail(f"online_adapt_viterbinet with device powers: {out}, {counts}, {same}, {witness}")
    return dict(out, two_launches_equal=same, counts=counts, witness=witness)


REPLACES = {"maml_pairs_viterbinet": "none (the JAX package's pair is jax.grad under lax.cond)",
            "fused_va_detect": "metaviterbinet_tpu/kernels/acs.py:409",
            "fused_viterbinet_detect": "metaviterbinet_tpu/kernels/acs.py:262",
            "fused_viterbinet_detect_chunked": "metaviterbinet_tpu/kernels/acs.py:306",
            "viterbi_decode_kernel": "metaviterbinet_tpu/kernels/acs.py:451",
            "online_adapt_viterbinet": "metaviterbinet_tpu/kernels/online_sgd.py:156"}
SOURCES = {"fused_va_detect": "metaviterbinet_tpu_torch/kernels/csrc/va_detect.cu",
           "fused_viterbinet_detect": "metaviterbinet_tpu_torch/kernels/csrc/viterbinet_detect.cu",
           "fused_viterbinet_detect_chunked":
               "metaviterbinet_tpu_torch/kernels/csrc/viterbinet_detect_chunked.cu",
           "viterbi_decode_kernel": "metaviterbinet_tpu_torch/kernels/csrc/viterbi_decode.cu",
           "online_adapt_viterbinet": "metaviterbinet_tpu_torch/kernels/csrc/online_adapt.cu",
           "maml_pairs_viterbinet": "metaviterbinet_tpu_torch/kernels/csrc/maml_pairs.cu"}


def kernel_rows(checks: dict, sl: dict, online: dict, sweep: dict, times: dict,
                parallel: dict, bench_line: dict) -> list:
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
        "beside_lowlat_1x136": times["lowlat"],
        "chunked_decode_reference": {"shape": [SP_W, SP_T, 16], "chunks": SP_CHUNKS,
                                     "overlap": OVERLAP, **times["chunked_decode"]},
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
        "checked_device_powers": row["checked"],
        "drift": checks[(name, 1, T_PROTO)]["drift"],
    })
    name = "maml_pairs_viterbinet"
    row = times[(name, K7_DRAWS)]
    rows.append({
        "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
        "launches": meta_launches[name],
        "max_abs_err": checks[(name, K7_DRAWS, T_PROTO)]["max_abs_err"],
        "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": None, "shape": [K7_DRAWS, T_PROTO],
        "pairs_taken": row["pairs_taken"], "call_ms": row["call_ms"],
        "plain_call_ms": row["plain_call_ms"], "cluster_size": maml_pairs.CLUSTER_SIZE,
        "checked": checks[(name, K7_DRAWS, T_PROTO)]["by_check"],
        "witness": checks[(name, K7_DRAWS, T_PROTO)]["witness"],
        "slot": {"shape": [K7_ITERATIONS, K7_DRAWS, T_PROTO],
                 **times[(name, K7_ITERATIONS * K7_DRAWS)]},
    })
    for row in rows:
        row["launches_sweep"] = {curve: sweep[curve]["launches"][row["name"]]
                                 for curve in SWEEP_CURVES}
        row["launches_parallel"] = {
            "mesh_shape=(1,) protocol": parallel["mesh_launches"][row["name"]],
            **{path: d["launches"][row["name"]] for path, d in parallel["decodes"].items()}}
        row["launches_bench"] = bench_line["launches"].get(row["name"], 0)
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
        max_workers=3, mp_context=multiprocessing.get_context("spawn"))
    with tempfile.TemporaryDirectory() as weights_dir, pool:
        trained = trained_vnet(f"{weights_dir}/one_minibatch")
        checks = timed("kernels", phase_kernels, model, trained, gen)
        sl = timed("slice", phase_slice, model, trained)
        anchors = timed("anchors", phase_anchors)
        jobs = start_beside(pool, weights_dir, card)
        threads = torch.get_num_threads()
        torch.set_num_threads(MAIN_CPU_THREADS_BESIDE_CHILDREN)
        online = timed("online", phase_online, weights_dir, card)
        cli_out = timed("cli", phase_cli, f"{weights_dir}/vnet")
        bf16 = timed("bf16", phase_bf16, model)
        parallel = timed("parallel", phase_parallel, trained, gen)
        lstm_out, sweep = timed("lstm and sweep (the wait after phase 7b)", finish_beside, jobs)
        torch.set_num_threads(threads)
        online["alone"] = timed("alone", phase_alone, weights_dir, online, lstm_out, card)
    steps = timed("steps", phase_steps, card)
    lstm_out["meta_lstm"]["full_run_estimate"] = meta_lstm_estimate(steps, card)
    times = timed("width", phase_width, model, gen, card)
    bench_line = timed("bench", phase_bench)

    print(json.dumps({"kernels": kernel_rows(checks, sl, online, sweep, times, parallel, bench_line),
                      "card": card,
                      "eval_s_per_1000_words": {
                          "va_sweep": sl["va_s_per_1k"], "va_loop": sl["va_loop_s_per_1k"],
                          "vnet": sl["vnet_s_per_1k"], "vnet_chunked": sl["vnet_chunked_s_per_1k"]},
                      "point_under_profiler_10db": sl["busy"],
                      "va_coded_ber_7_to_12db": sl["va_ber"],
                      "vnet_coded_ber_10db": {"random_params": sl["vnet_ber_10db"],
                                              "trained_params": sl["vnet_trained_ber_10db"]},
                      "anchors": anchors, "by_word_10db": online, "lstm": lstm_out,
                      "sweep_8db_cost2100": sweep,
                      "cli": cli_out, "bf16": bf16, "parallel": parallel, "bench": bench_line,
                      "graphed_steps": steps,
                      "phase_seconds": seconds}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
