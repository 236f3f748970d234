"""Trainer: binds a detector spec to data, training, checkpoints and the two
evaluation protocols (the JAX package's evaluation/trainer.py; reference
python_code/trainers/trainer.py).

Protocol parity:
  - `evaluate()` dispatches on eval_mode 'aggregated' | 'by_word'
    (trainer.py:368-381); by_word requires ECC (trainer.py:375-376).
  - A trainable detector evaluates the params its caller passed, or else the
    checkpoint of each point: aggregated eval loads one per SNR, by_word only
    snr_range['val'][0] (trainer.py:249-251 vs :377).
  - Checkpoints are keyed snr_{snr}_gamma_{gamma}, with lazy train-on-miss on
    the time_decay train channel at the CONFIGURED fading type (the JAX
    package's Trainer.load_weights says why the reference's flip to type 1
    there changes nothing).
  - SER is computed on non-pilot words only (trainer.py:99-102).
  - The detector spec is specialised as the JAX Trainer does it
    (trainer.py:57, :84-93): Config.dtype by `with_compute_dtype`, then
    Config.eval_time_chunks by `with_time_chunks`.
  - An aggregated eval runs as one sweep over its SNRs (`sweep_eval_fused`,
    trainer.py:203-226), on every device: every point's params are loaded
    (or trained on a miss) first, then the points are detected and decoded.

Randomness: `generator` (on the trainer's device) draws the params'
initialisation, the decoder-CSI noise and the select_batch indices;
`host_generator` (CPU) the meta query indices.
"""
from __future__ import annotations

import contextlib
import math
import os
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from metaviterbinet_tpu_torch.config import Config
from metaviterbinet_tpu_torch.data.dataset import ChannelDataset
from metaviterbinet_tpu_torch.detectors import (
    DETECTORS, DetectorSpec, with_compute_dtype, with_time_chunks)
from metaviterbinet_tpu_torch.device import resolve_device, use_f32_matmuls
from metaviterbinet_tpu_torch.ecc.rs import rs_decode_bits, rs_encode_bits
from metaviterbinet_tpu_torch.online.engine import Draws, OnlineResult, run_online
from metaviterbinet_tpu_torch.ops.channel import estimate_channel_batch
from metaviterbinet_tpu_torch.ops.metrics import error_rates
from metaviterbinet_tpu_torch.paths import WEIGHTS_DIR
from metaviterbinet_tpu_torch.train.checkpoint import (
    load_checkpoint, save_config_provenance, save_params)
from metaviterbinet_tpu_torch.train.losses import make_loss_fn, select_batch
from metaviterbinet_tpu_torch.train.loop import word_sweep
from metaviterbinet_tpu_torch.train.meta import make_maml_step, sorted_unique
from metaviterbinet_tpu_torch.train.optim import Optimizer, OptState


class Trainer:
    def __init__(self, cfg: Config, detector: str | DetectorSpec,
                 device: str | torch.device = "cuda", params: Any = None,
                 weights_dir: Optional[str] = None, verbose: bool = True, metrics=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            use_f32_matmuls()
        if isinstance(detector, str):
            if detector not in DETECTORS:
                raise ValueError(f"unknown detector {detector!r}; expected one of "
                                 f"{sorted(DETECTORS)}")
            detector = DETECTORS[detector]
        self.spec = with_time_chunks(with_compute_dtype(detector, cfg.dtype),
                                     cfg.eval_time_chunks, cfg.decode_overlap,
                                     cfg.memory_length)
        self.verbose = verbose
        self.metrics = metrics  # optional utils.logging.MetricsLogger
        self.weights_dir = weights_dir or cfg.weights_dir or os.path.join(
            WEIGHTS_DIR, f"{self.spec.name}_{cfg.run_name}")
        self.train_dataset = ChannelDataset(cfg, "train", self.device)
        self.val_dataset = ChannelDataset(cfg, "val", self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.noise_seed + 1)
        self.host_generator = torch.Generator().manual_seed(cfg.noise_seed + 2)
        self.draws = Draws(cfg, self.spec, self.device, self.generator, self.host_generator)
        # params from the caller are evaluated as given; otherwise checkpoints
        self.params = params
        self._fixed_params = params is not None
        self.loss_fn = self.meta_loss_fn = None
        if self.spec.trainable:
            self.loss_fn, self.meta_loss_fn = (
                make_loss_fn(score, self.spec.label_kind, cfg.memory_length,
                             self.spec.subsample_loss, cfg.loss_type)
                for score in (self.spec.score, self.spec.meta_score))
        self._data_indices = torch.as_tensor(cfg.data_indices("val"), device=self.device)
        # entered around each online block's parts (online/engine.py::run_online)
        self.spans: Callable[[str], Any] = contextlib.nullcontext
        self.online_result: Optional[OnlineResult] = None

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(msg)

    def _metric(self, event: str, **kw) -> None:
        if self.metrics is not None:
            self.metrics.log(event, detector=self.spec.name, **kw)

    def init_params(self):
        return self.spec.init(self.cfg, self.generator, self.device)

    def decoder_csi(self, n_words: int, noise: torch.Tensor | None = None) -> torch.Tensor:
        """Decoder-side channel taps for the full-CSI VA (va_detector.py:52-60):
        tracks, or mis-tracks via fading_in_decoder / noisy_est_var, the true
        channel trajectory. The estimation noise is drawn from the trainer's
        generator unless given."""
        cfg = self.cfg
        return estimate_channel_batch(
            cfg.memory_length, cfg.gamma, torch.arange(n_words, device=self.device),
            channel_coefficients=cfg.channel_coefficients,
            noisy_est_var=cfg.noisy_est_var,
            fading=cfg.fading_in_decoder,
            fading_taps_type=cfg.fading_taps_type,
            generator=self.generator,
            noise=noise,
        )

    # ------------------------------------------------------------- evaluation
    def eval_tail(self, params, tx: torch.Tensor, rx: torch.Tensor,
                  h: torch.Tensor) -> torch.Tensor:
        """Detect -> RS decode -> coded BER over the non-pilot words, all on
        the batch's device; returns the BER as a 0-d tensor."""
        detected = self.spec.detect(params, rx, h)
        if self.cfg.use_ecc:
            decoded, _ = rs_decode_bits(detected, self.cfg.n_symbols)
        else:
            decoded = detected
        di = self._data_indices.to(decoded.device)
        ber, _, _ = error_rates(decoded[di], tx[di])
        return ber

    def single_eval_at_point(self, params, snr: float, gamma: float) -> float:
        """Aggregated SER at one (snr, gamma) (trainer.py:222-241)."""
        tx, rx = self.val_dataset.get(snr, gamma)
        h = self.decoder_csi(tx.shape[0])
        return float(self.eval_tail(params, tx, rx, h))

    def _params_at(self, snr: float):
        if self.spec.trainable and not self._fixed_params:
            self.params = self.load_weights(snr, self.cfg.gamma)
        return self.params

    def evaluate(self) -> np.ndarray:
        """eval_mode dispatch (trainer.py:368-381). Returns the SER vector:
        per SNR for 'aggregated', per block for 'by_word'."""
        cfg = self.cfg
        if cfg.eval_mode == "by_word":
            if not cfg.use_ecc:
                raise ValueError("Must run with ECC in by_word eval mode")
            snr = float(cfg.snr_range("val")[0])
            self._params_at(snr)
            return self.eval_by_word(snr, cfg.gamma)
        if cfg.eval_mode != "aggregated":
            raise ValueError(f"No such eval mode: {cfg.eval_mode}")
        snrs = [float(s) for s in cfg.snr_range("val")]
        # every point's params first (checkpoint IO, and training on a miss),
        # then the sweep (trainer.py:211-217)
        params_per_snr = [self._params_at(snr) for snr in snrs]
        t0 = time.perf_counter()
        sers = self.sweep_eval_fused(snrs, params_per_snr)
        dt = time.perf_counter() - t0
        for snr, ser in zip(snrs, sers):
            self._log(f"SNR {snr}: ser {ser:.6f}")
            self._metric("eval_point", snr=snr, ser=float(ser), elapsed_s=dt / len(snrs))
        self._log(f"{len(snrs)}-SNR sweep: {dt:.3f}s")
        return sers

    def sweep_eval_fused(self, snrs: list, params_per_snr) -> np.ndarray:
        """Aggregated eval of a whole SNR sweep (trainer.py:239-283): per
        point, in stream order, generate the val batch, compute the decoder
        CSI and detect; then one RS decode over every point's words, and each
        point scored on its non-pilot words. The val generators and the
        decoder-CSI draws advance as in the per-SNR loop, and the codec
        decodes each word alone, so the BERs equal the loop's bit for bit
        when nothing trains in between."""
        cfg = self.cfg
        detected, txs = [], []
        for snr, params in zip(snrs, params_per_snr):
            tx, rx = self.val_dataset.get(snr, cfg.gamma)
            h = self.decoder_csi(tx.shape[0])
            detected.append(self.spec.detect(params, rx, h))
            txs.append(tx)
        det_all = torch.cat(detected)
        dec_all = rs_decode_bits(det_all, cfg.n_symbols)[0] if cfg.use_ecc else det_all
        di = self._data_indices.to(dec_all.device)
        n = txs[0].shape[0]
        bers = [error_rates(dec_all[i * n:(i + 1) * n][di], tx[di])[0] for i, tx in enumerate(txs)]
        return torch.stack(bers).cpu().numpy().astype(np.float64)

    def eval_by_word(self, snr: float, gamma: float) -> np.ndarray:
        """The online adaptation loop over the val blocks (trainer.py:267-354)
        from `self.params`, which it replaces by the adapted params."""
        cfg = self.cfg
        tx, rx = self.val_dataset.get(snr, gamma)
        h = self.decoder_csi(tx.shape[0])
        meta_init = None
        if self.spec.trainable and cfg.weights_init == "meta_training":
            meta_init = self.load_weights(float(cfg.snr_range("val")[0]), gamma)
        init_rx = init_tx = None
        if not cfg.buffer_empty:
            # pre-filled with train-channel words, labelled with the
            # re-encoded true words (trainer.py:281-287)
            btx, init_rx = self.train_dataset.get(snr, gamma)
            init_tx = rs_encode_bits(btx, cfg.n_symbols) if cfg.use_ecc else btx
        t0 = time.perf_counter()
        result = run_online(cfg, self.spec, self.params, tx, rx, h, self.draws,
                            meta_init_params=meta_init, init_buffer_rx=init_rx,
                            init_buffer_tx=init_tx, spans=self.spans)
        self.online_result = result
        if self.spec.trainable:
            self.params = result.params
        sers = result.ser_by_word
        elapsed = time.perf_counter() - t0
        self._log(f"by-word eval: mean ser {sers.mean():.6f} over {len(sers)} blocks "
                  f"({elapsed:.1f}s, buffer fill {result.n_buffer}, {result.n_gated} gated)")
        self._metric("by_word_eval", snr=snr, mean_ser=float(sers.mean()), n_blocks=len(sers),
                     buffer_fill=int(result.n_buffer), elapsed_s=elapsed)
        return sers

    # --------------------------------------------------------------- training
    def train(self):
        """Offline training over the train SNR range, keeping the best-SER
        checkpoint per SNR (trainer.py:455-490); MAML meta-training for a
        meta detector. Returns the params of the last train SNR."""
        if not self.spec.trainable:
            raise NotImplementedError("no training implemented for this detector")
        if self.spec.meta:
            return self.meta_train()
        cfg = self.cfg
        optimizer = Optimizer(cfg.optimizer_type, cfg.lr, cfg.clip_grad_norm)
        for snr in (float(s) for s in cfg.snr_range("train")):
            self._log(f"SNR - {snr}, Gamma - {cfg.gamma}")
            model = self.init_params()
            params = self.spec.model.param_dict(model)
            opt_state = optimizer.init(params)
            best_ser = math.inf
            for minibatch in range(1, cfg.train_minibatch_num + 1):
                tx, rx = self.train_dataset.get(snr, cfg.gamma)
                select = None
                if self.spec.subsample_loss:
                    select = [select_batch(tx.shape[1], cfg.train_minibatch_size, self.generator,
                                           self.device) for _ in range(tx.shape[0])]
                loss = float(word_sweep(self.loss_fn, optimizer, params, opt_state, rx, tx, select))
                ser = self.single_eval_at_point(model, snr, cfg.gamma)
                self._log(f"Minibatch {minibatch}, ser - {ser}, loss {loss:.3f}")
                self._metric("train_minibatch", snr=snr, minibatch=minibatch, ser=ser, loss=loss)
                if ser < best_ser:
                    self.save_weights(params, loss, snr, cfg.gamma, opt_state)
                    best_ser = ser
            self._log(f"best ser - {best_ser}")
        self.params = self.load_weights(float(cfg.snr_range("train")[-1]), cfg.gamma)
        return self.params

    def meta_train(self):
        """Offline MAML meta-training (trainer.py:383-423): per minibatch,
        query indices j ~ unique(randint(window_size, n_words)), each adapted
        on (support = the window before j, query = j) of RS-coded words; the
        weights are saved after every minibatch, so the last one seeds
        evaluation (trainer.py:420-423)."""
        cfg = self.cfg
        optimizer = Optimizer(cfg.optimizer_type, cfg.lr, cfg.clip_grad_norm)
        maml_step = make_maml_step(self.meta_loss_fn, optimizer, cfg.meta_lr, cfg.MAML)
        w = cfg.window_size
        n_words = cfg.n_words("train")
        for snr in (float(s) for s in cfg.snr_range("train")):
            self._log(f"SNR - {snr}, Gamma - {cfg.gamma} (meta)")
            model = self.init_params()
            params = self.spec.model.param_dict(model)
            opt_state = optimizer.init(params)
            for minibatch in range(1, cfg.train_minibatch_num + 1):
                tx, rx = self.train_dataset.get(snr, cfg.gamma)
                tx_coded = rs_encode_bits(tx, cfg.n_symbols) if cfg.use_ecc else tx
                j_hats = sorted_unique(torch.randint(w, n_words, (cfg.meta_j_num,),
                                                     generator=self.host_generator))
                total = rx.new_zeros(())
                for j in j_hats.tolist():
                    total = total + maml_step(params, opt_state, rx[j - w:j], tx_coded[j - w:j],
                                              rx[j:j + 1], tx_coded[j:j + 1])
                loss = float(total) / max(len(j_hats), 1)
                ser = self.single_eval_at_point(model, snr, cfg.gamma)
                self._log(f"Minibatch {minibatch}, ser - {ser}, loss {loss:.4f}")
                self._metric("meta_train_minibatch", snr=snr, minibatch=minibatch, ser=ser,
                             loss=loss)
                self.save_weights(params, loss, snr, cfg.gamma, opt_state)
        self.params = self.load_weights(float(cfg.snr_range("train")[-1]), cfg.gamma)
        return self.params

    # ------------------------------------------------------------ checkpoints
    def save_weights(self, params: dict, loss: float, snr: float, gamma: float,
                     opt_state: Optional[OptState] = None) -> None:
        save_config_provenance(self.weights_dir, self.cfg)
        save_params(self.weights_dir, snr, gamma, params, loss, opt_state)

    def load_weights(self, snr: float, gamma: float):
        """The (snr, gamma) checkpoint's params as a model; on a miss, train
        first (trainer.py:513-532), on the configured fading type."""
        ckpt = load_checkpoint(self.weights_dir, snr, gamma, self.device)
        if ckpt is None:
            self._log(f"No checkpoint for snr {snr} gamma {gamma}: training on miss")
            self.train()
            ckpt = load_checkpoint(self.weights_dir, snr, gamma, self.device)
            if ckpt is None:
                raise FileNotFoundError(
                    f"training did not produce a checkpoint for snr {snr} gamma {gamma}")
        return self.spec.model.from_params(ckpt["params"], self.device)
