"""Points in time on the device's timeline: CUDA events on the card; on
the CPU, where the port runs its plain versions and only the tests drive
the harness, the host's clock."""
from __future__ import annotations

import time

import torch


class Marks:
    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    def ms(self, a, b) -> float:
        """Milliseconds from mark a to mark b (both recorded)."""
        if self.cuda:
            return a.elapsed_time(b)
        return 1e3 * (b - a)

    def synchronize(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
