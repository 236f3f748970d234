"""The build, load and launch count of the port's hand-written CUDA code.

Each source csrc/{name}.cu (the kernels of kernels/acs.py, kernels/
online_sgd.py and kernels/maml_pairs.py, online/graphs.py's IF node and
utils/profiling.py's stamp) is compiled by nvcc for sm_90a into a shared
library with a plain C interface, at its first CUDA call (or all together
by `build_kernels`), into kernels/_build/, named by a hash of its source,
every csrc/*.cuh and the flags, and loaded with ctypes. `load(name,
argtypes)` returns the library's C function, whose argument types the
module that calls it declares.

A kernel wrapper launches its kernel on the current stream for CUDA tensors
(`route`) and runs the kernel's plain PyTorch version for CPU tensors, which
the tests and chip_smoke.py also hold the kernel against. A wrapper made
with `counted` counts its launches in its `launches` attribute: it calls
`launched(wrapper, rc)` after each real launch, which checks CUDA's return
code and adds one. LAUNCH_COUNTED is the registry of those wrappers, which
online/graphs.py reads to keep the counts kernel executions under CUDA
graphs. Imports nothing of the port.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

import torch

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

PTR, INT, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# library name -> nvcc's report (registers, spills) of its last build here
build_reports: dict[str, str] = {}
_libraries: dict[str, ctypes.CDLL] = {}
_functions: dict[tuple[str, str], Callable] = {}
# the wrappers that count their launches, in the order their modules made them
LAUNCH_COUNTED: list[Callable] = []


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")
    return nvcc


def library_path(name: str) -> Path:
    """The built library of csrc/{name}.cu, named by a hash of its sources and flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / f"{name}.cu"]:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_kernels(names: Optional[Sequence[str]] = None) -> dict[str, float]:
    """Compile the named sources (every csrc/*.cu by default) that are not
    built yet, one nvcc process per source, all started together. Returns
    the seconds each build took."""
    if names is None:
        names = sorted(src.stem for src in CSRC_DIR.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    started = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, target, time.perf_counter())
    seconds = {}
    failed = []
    for name, (proc, tmp, target, t0) in started.items():
        report, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        build_reports[name] = report
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{report}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str, argtypes: tuple, symbol: Optional[str] = None) -> Callable:
    """The C function `symbol` (by default `name`) of csrc/{name}.cu's
    library, built and loaded at the first call, with the argument types
    `argtypes` and an int return (CUDA's error code)."""
    key = (name, symbol or name)
    if key not in _functions:
        if name not in _libraries:
            if not torch.cuda.is_available():
                raise RuntimeError(f"{name}: CUDA is not available")
            build_kernels((name,))
            _libraries[name] = ctypes.CDLL(str(library_path(name)))
        fn = getattr(_libraries[name], key[1])
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _functions[key] = fn
    return _functions[key]


def check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t {rc}")


def counted(wrapper: Callable) -> Callable:
    """Register a kernel wrapper in LAUNCH_COUNTED, its `launches` at 0."""
    wrapper.launches = 0
    LAUNCH_COUNTED.append(wrapper)
    return wrapper


def launched(wrapper: Callable, rc: int) -> None:
    """After a counted wrapper's launch: check CUDA's return code and count it."""
    check_launch(wrapper.__name__, rc)
    wrapper.launches += 1


def check_f32(name: str, t: torch.Tensor, ndim: int, device: torch.device) -> None:
    if t.dtype != torch.float32 or t.dim() != ndim:
        raise ValueError(f"{name}: expected a {ndim}-d float32 tensor, got {t.dim()}-d {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: tensor on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def route(name: str, y: torch.Tensor) -> bool:
    """True to launch the kernel (CUDA tensor), False for the plain version
    (CPU tensor); raises for any other device."""
    if y.device.type == "cuda":
        return True
    if y.device.type == "cpu":
        return False
    raise ValueError(f"{name}: expected a CUDA or CPU tensor, got {y.device}")
