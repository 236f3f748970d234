"""Cells cut to a size the CPU runs in seconds, for the tests: a
by-word run of 50 blocks with 20 self-supervised steps and 2 MAML rounds a
slot, a sweep of 25-word minibatches."""
from pathlib import Path
from typing import Optional

from portbench import harness


def cell(name: str, root: Optional[Path] = None) -> harness.Cell:
    c = harness.cell(name, root)
    if c.traffic["driver"] == "by_word":
        c.config.update(val_frames=2, self_supervised_iterations=20, meta_train_iterations=2)
        c.traffic.update(pool=2, start_words=[4, 2], profile_blocks=50)
        # a few dozen blocks compared: every error apart counts
        c.limits["start_errors_apart"] = c.limits["window_errors_apart"] = {"limit": 0}
    else:
        c.config.update(train_frames=1)
        c.traffic.update(pool=2, restart_every=2)
    return c
