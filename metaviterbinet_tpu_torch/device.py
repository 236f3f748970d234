"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: a request
for CUDA on a machine without it raises instead of falling back.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def use_f32_matmuls() -> None:
    """Keep float32 products in full float32 on the card, with no TF32: the
    JAX package detects and trains ViterbiNet in float32 (HIGHEST precision
    in its kernels), and the port holds its results to that. This sets the
    process-wide PyTorch flags; False is also their default."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
