"""A short first call for the port's kernels on a card: build them all and
print nvcc's register report; hold one tensor-core tile of K1's priors
against the plain version's; compare K1 and K2 with their plain versions at
every S and a few shapes, and two launches of each with each other; K4
against its plain version; K5 at every S and a few shapes; K6 after 40
steps against its plain version and, after 40 + 40, against a float64 run
of the plain version's arithmetic (its distance within a multiple of the f32
plain version's, chip_smoke.py's K6_WITNESS_*), on a few (T, S) words and
the witness words, where runs with one Adam constant off (K6_FAULTS) must
fail it; two K6 launches with each other; then count the SASS
instructions of the S = 16 detect kernels (K1, K2, K4), and time one
tensor-core tile of K1 (a block's fixed cost: its weights into shared
memory and one tile), K1, K2 and K4 at the protocol's 300 x 136, K1, K2
and K4 at 65536 x 136, K2 and K5 at the engine's 1 x 136, and K6 on the
device (a CUDA graph of back-to-back calls); with a package whose K4 takes
its launch geometry (kernels/acs.py::chunked_geometry), also K4 at other
geometries: one set per block, other chains per set and steps per slot.

    env PYTHONPATH=. python3 scripts/torch_kernel_probe.py
    env PYTHONPATH=<other checkout> python3 scripts/torch_kernel_probe.py --time

chip_smoke.py holds the same kernels to their limits on the main paths;
this script is the quick check to run first after changing a kernel. It
exits non-zero if a check fails. With --time it skips the checks and only
times, so that it can time another checkout's package (an earlier commit,
unpacked with `git archive`) in the same call: run the two in turns.
"""
import importlib.util
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

from metaviterbinet_tpu_torch.kernels import acs, online_sgd
from metaviterbinet_tpu_torch.models import viterbinet
from metaviterbinet_tpu_torch.ops.trellis import calculate_states
from metaviterbinet_tpu_torch.train.optim import Optimizer

# this checkout's chip_smoke.py, whichever package PYTHONPATH points at
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

STATES = (2, 4, 8, 16)
DETECT_SHAPES = ((1, 136), (300, 136), (4096, 41), (33, 7))
K5_SHAPES = ((1, 136), (300, 136), (4096, 41), (33, 7), (1, 1000))
K6_CASES = ((16, 136), (16, 41), (16, 5), (16, 1000), (2, 136))  # (S, T)
K6_LIMIT = 5e-6  # after 40 steps, against the f32 plain version: the JAX kernel's contract


def k6_inputs(S, T, g):
    model = viterbinet.init_params(S, g, device="cuda")
    p = viterbinet.param_dict(model)
    y = torch.randn(T, generator=g, device="cuda")
    L = S.bit_length() - 1
    states = calculate_states(L, torch.randint(0, 2, (1, T), generator=g, device="cuda").float())
    return p, y, states


def copies(p, n, dtype=torch.float32):
    opt = Optimizer("Adam", 1e-3)
    out = []
    for _ in range(n):
        q = {k: v.detach().to(dtype=dtype, copy=True) for k, v in p.items()}
        out.append((q, opt.init(q)))
    return out


def max_diff(a, b):
    return max(float((a[k].double() - b[k].double()).abs().max()) for k in a)


def check_witness(label, p, y, states, fault=None) -> bool:
    """True if K6 holds the float64 witness, or if the faulty run named by
    `fault` (a key of K6_FAULTS), standing for K6, fails it."""
    d = smoke.k6_witness(p, y, states, fault=smoke.K6_FAULTS.get(fault))
    held = smoke.witness_holds(d)
    run = f"faulty run ({fault})" if fault else "kernel"
    print(f"K6 {label} resumed 40 + 40: vs float64 {run} {d['kernel_f64']:.3e}, f32 plain "
          f"{d['plain_f64']:.3e} (ratio {d['kernel_f64'] / d['plain_f64']:.2f}); {run} vs f32 "
          f"plain {d['kernel_plain']:.3e}; {'within' if held else 'EXCEEDS'} "
          f"{smoke.K6_WITNESS_MULTIPLE:g} x plain + {smoke.K6_WITNESS_FLOOR:g}", flush=True)
    return held != (fault is not None)


def check_k6(S, T, g) -> bool:
    """K6 and its f32 plain version from the same params and zero moments,
    40 steps; the float64 witness of 40 + 40; two K6 launches."""
    p, y, states = k6_inputs(S, T, g)
    (pk, sk), (pp, sp), (pr, sr) = copies(p, 3)
    online_sgd.online_adapt_viterbinet(pk, sk, y, states, 40, 1e-3)
    online_sgd.online_adapt_viterbinet_plain(pp, sp, y, states, 40, 1e-3)
    torch.cuda.synchronize()
    err = max_diff(pk, pp)
    ok = err <= K6_LIMIT
    print(f"K6 S={S} T={T} 40 steps: max |dparam| {err:.3e} vs the f32 plain version, "
          f"{'within' if ok else 'EXCEEDS'} {K6_LIMIT:g}", flush=True)
    ok &= check_witness(f"S={S} T={T}", p, y, states)
    online_sgd.online_adapt_viterbinet(pk, sk, y, states, 40, 1e-3)
    online_sgd.online_adapt_viterbinet(pr, sr, y, states, 40, 1e-3)
    online_sgd.online_adapt_viterbinet(pr, sr, y, states, 40, 1e-3)
    same = all(torch.equal(a[k], b[k]) for a, b in ((pk, pr), (sk.mu, sr.mu), (sk.nu, sr.nu))
               for k in pk)
    print(f"K6 S={S} T={T}: run to run bit-identical {same}", flush=True)
    return ok and same


# K4 against its plain version: (W, T, C, overlap), the card tests' shapes
K4_SHAPES = ((300, 136, 2, 32), (300, 136, 4, 32), (1, 136, 4, 32), (4096, 136, 4, 32),
             (33, 135, 3, 32), (7, 70, 2, 32), (13, 64, 2, 32), (1001, 136, 4, 32),
             (5, 80, 40, 2))


def sass_counts(name: str) -> dict:
    """Instructions of each S = 16 kernel in the SASS of library `name`."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(acs.library_path(name))], capture_output=True,
                          text=True, check=True).stdout
    counts = {}
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        head, body = block.split("\n", 1)
        if "ILi16E" in head:
            counts[head.strip()] = len(re.findall(r"^\s+/\*[0-9a-f]{4,}\*/\s+\S", body, re.M))
    return counts


def k4_variant(model, y, C, chains, warm, steps, blocks, overlap=32):
    """One K4 launch at the given geometry (kernels/acs.py::ChunkedGeometry),
    through its C function (counts no launch); returns the bits."""
    params = acs._mlp_params(model)
    out = torch.empty_like(y)
    W, T = y.shape
    rc = acs._library("viterbinet_detect_chunked").viterbinet_detect_chunked(
        y.data_ptr(), *(p.data_ptr() for p in params), out.data_ptr(), W, T, 16, C, overlap,
        chains, warm, steps, blocks, torch.cuda.current_stream().cuda_stream)
    acs._check_launch("k4_variant", rc)
    return out


def check_detect(g) -> bool:
    ok = True
    torch.backends.cuda.matmul.allow_tf32 = False
    for S in STATES:
        model = viterbinet.init_params(S, g, device="cuda")
        y = 2 * torch.randn(64, generator=g, device="cuda")
        got = acs.viterbinet_tile_priors(model, y)
        want = acs._bf16_priors(model, y[None]).reshape(64, S)
        err = float((got - want).abs().max())
        print(f"K1 tile S={S}: priors max |diff| {err:.3e} vs the plain version "
              f"(limit {smoke.TILE_TOL:g}), {float((got != want).float().mean()):.3f} of them differ",
              flush=True)
        ok &= err <= smoke.TILE_TOL
        for W, T in DETECT_SHAPES:
            y, mu = smoke.kernel_inputs(W, T, g, S)
            for name, kernel, plain in (
                    ("K2", lambda: acs.fused_va_detect(y, mu),
                     lambda: acs.fused_va_detect_plain(y, mu)),
                    ("K1", lambda: acs.fused_viterbinet_detect(model, y),
                     lambda: acs.fused_viterbinet_detect_plain(model, y))):
                got, again = kernel(), kernel()
                rate = float((got != plain()).float().mean())
                same = torch.equal(got, again)
                limit_ok = rate == 0 if name == "K2" else rate < 1e-3
                print(f"{name} S={S} {W}x{T}: mismatch {rate:.3e}, two launches bit-identical "
                      f"{same}", flush=True)
                ok &= limit_ok and same
    model = viterbinet.init_params(16, g, device="cuda")
    for W, T, C, overlap in K4_SHAPES:
        y = smoke.kernel_inputs(W, T, g)[0]
        got = acs.fused_viterbinet_detect_chunked(model, y, C, overlap)
        same = torch.equal(got, acs.fused_viterbinet_detect_chunked(model, y, C, overlap))
        rate = float((got != acs.fused_viterbinet_detect_chunked_plain(model, y, C, overlap))
                     .float().mean())
        print(f"K4 C={C} overlap={overlap} {W}x{T}: mismatch {rate:.3e}, two launches "
              f"bit-identical {same}", flush=True)
        ok &= rate < 1e-3 and same
    return ok


def main() -> int:
    print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0), flush=True)
    card = smoke.card_line()
    print(card)
    t0 = time.time()
    print("build", acs.build_kernels(), time.time() - t0, flush=True)
    for n, r in acs.build_reports.items():
        for line in r.splitlines():
            if any(w in line for w in ("registers", "spill", "error", "warning")):
                print(n, line.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    check = "--time" not in sys.argv[1:]
    print("package", acs.__file__, "checks" if check else "times only", flush=True)
    if check:
        for S in STATES:
            for W, T in K5_SHAPES:
                pri = torch.randn((W, T, S), generator=g, device="cuda")
                got = acs.viterbi_decode_kernel(pri)
                bad = int((got != acs.viterbi_decode_kernel_plain(pri)).sum())
                print("K5", S, W, T, "mismatch", bad, flush=True)
                ok &= bad == 0
        for S, T in K6_CASES:  # the first is the seed-0 word at T = 136
            ok &= check_k6(S, T, g)
        for T, seed in smoke.K6_WITNESS_WORDS:
            inputs = smoke.k6_witness_word(T, seed)
            for fault in (None, *smoke.K6_FAULTS):
                ok &= check_witness(f"witness word T={T} seed={seed}", *inputs, fault=fault)
        ok &= check_detect(torch.Generator(device="cuda").manual_seed(1))

    for name in ("viterbinet_detect", "va_detect", "viterbinet_detect_chunked"):
        for kernel, n in sass_counts(name).items():
            print(f"SASS {name}: {n} instructions in {kernel}", flush=True)
    model = viterbinet.init_params(16, g, device="cuda")
    y64 = 2 * torch.randn(64, generator=g, device="cuda")
    ms = smoke.graph_ms(lambda: acs.viterbinet_tile_priors(model, y64))
    print(f"K1 tile (one block of 128 threads: the weights into shared memory, one tile): "
          f"{ms:.5f} ms on the device [{card}]", flush=True)
    for W in (300, 65536):
        y, mu = smoke.kernel_inputs(W, 136, g)
        for name, fn in (("K2", lambda: acs.fused_va_detect(y, mu)),
                         ("K1", lambda: acs.fused_viterbinet_detect(model, y))):
            print(f"{name} {W}x136: {smoke.graph_ms(fn):.5f} ms on the device [{card}]", flush=True)
        for C in ((2, 4) if W == 300 else (4,)):
            ms = smoke.graph_ms(lambda: acs.fused_viterbinet_detect_chunked(model, y, C))
            print(f"K4 C={C} {W}x136: {ms:.5f} ms on the device [{card}]", flush=True)
        if hasattr(acs, "chunked_geometry"):
            # K4 at other geometries: (C, chains per set, warm-up steps per slot, stored
            # steps per slot, blocks); blocks = sets is one set per block
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            variants = ((4, 32, 8, 6, 8192), (4, 32, 6, 6, sms),
                        (4, 32, 8, 4, sms)) if W == 65536 else \
                ((4, 12, 16, 16, 100), (4, 12, 21, 10, 100), (4, 8, 32, 24, 150),
                 (2, 6, 32, 20, 100))
            for C, chains, warm, steps, blocks in variants:
                want = acs.fused_viterbinet_detect_chunked(model, y, C)
                same = torch.equal(k4_variant(model, y, C, chains, warm, steps, blocks), want)
                ms = smoke.graph_ms(lambda: k4_variant(model, y, C, chains, warm, steps, blocks))
                print(f"K4 variant C={C} {W}x136 chains {chains} warm-up steps {warm} stored "
                      f"steps {steps} blocks {blocks}: {ms:.5f} ms on the "
                      f"device, bits equal to the wrapper's {same}; wrapper's geometry "
                      f"{tuple(acs.chunked_geometry(W, C, 136, 32, sms))} [{card}]", flush=True)
                ok &= same
    y, mu = smoke.kernel_inputs(1, 136, g)
    print(f"K2 1x136: {smoke.graph_ms(lambda: acs.fused_va_detect(y, mu)):.5f} ms on the device "
          f"[{card}]", flush=True)
    for W, T in ((1, 136), (300, 136), (1, 1000)):
        pri = torch.randn((W, T, 16), generator=g, device="cuda")
        ms = smoke.graph_ms(lambda: acs.viterbi_decode_kernel(pri))
        print(f"K5 {W}x{T}x16: {ms:.5f} ms on the device [{card}]", flush=True)
    p, y, states = k6_inputs(16, 136, g)
    ((pk, sk),) = copies(p, 1)
    ms = smoke.graph_ms(lambda: online_sgd.online_adapt_viterbinet(pk, sk, y, states, 200, 1e-3),
                  per_graph=2, replays=10)
    print(f"K6 T=136 200 steps: {ms:.5f} ms on the device, {1e3 * ms / 200:.3f} us per step; "
          f"bound {smoke.adapt_bound_ms(136, 16, 200)[0]:.5f} ms (card) [{card}]", flush=True)
    print("probe", "passed" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
