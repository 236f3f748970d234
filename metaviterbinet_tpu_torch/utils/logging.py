"""Structured metrics logging (the JAX package's utils/logging.py).

An append-only JSONL metrics log any external tool can tail: one record per
event with a monotonic step and wall time. The Trainer logs `eval_point`,
`by_word_eval`, `train_minibatch` and `meta_train_minibatch` through it.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, echo: bool = False):
        self.path = path
        self.echo = echo
        self._step = 0
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(self, event: str, **metrics: Any) -> Dict[str, Any]:
        record = {"step": self._step, "time": time.time(), "event": event}
        record.update({k: (float(v) if hasattr(v, "__float__") else v)
                       for k, v in metrics.items()})
        self._step += 1
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(record) + "\n")
        if self.echo:
            print(json.dumps(record))
        return record
