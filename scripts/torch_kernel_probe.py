"""A short first call for the port's decode and adaptation kernels (K5, K6)
on a card: build all kernels and print nvcc's register report, compare K5
with its plain version at every S and a few shapes, compare K6 with its
plain version after 40 and 200 steps (and a resumed call) on random words,
and time K6 and K5 per eager call.

    env PYTHONPATH=. python3 scripts/torch_kernel_probe.py

chip_smoke.py holds the same kernels to their limits on the main paths;
this script is the quick check to run first after changing a kernel.
"""
import subprocess
import time

import torch

from metaviterbinet_tpu_torch.kernels import acs, online_sgd
from metaviterbinet_tpu_torch.models import viterbinet
from metaviterbinet_tpu_torch.train.optim import Optimizer
from metaviterbinet_tpu_torch.ops.trellis import calculate_states


def main() -> None:
    print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True).stdout)
    t0 = time.time(); secs = acs.build_kernels(); print("build", secs, time.time() - t0, flush=True)
    for n, r in acs.build_reports.items():
        for line in r.splitlines():
            if "registers" in line or "spill" in line or "error" in line or "warning" in line: print(n, line.strip())
    g = torch.Generator(device="cuda").manual_seed(0)
    for S in (2, 4, 8, 16):
        for W, T in ((1, 136), (300, 136), (4096, 41), (33, 7)):
            pri = torch.randn((W, T, S), generator=g, device="cuda")
            got = acs.viterbi_decode_kernel(pri); want = acs.viterbi_decode_kernel_plain(pri); torch.cuda.synchronize()
            print("K5", S, W, T, "mismatch", int((got != want).sum()), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    for T, N in ((136, 40), (41, 40), (136, 200)):
        model = viterbinet.init_params(16, g, device="cuda")
        p = viterbinet.param_dict(model)
        opt = Optimizer("Adam", 1e-3); st = opt.init(p)
        y = torch.randn(T, generator=g, device="cuda")
        bits = torch.randint(0, 2, (1, T), generator=g, device="cuda").float()
        states = calculate_states(4, bits)
        pk = {k: v.detach().clone() for k, v in p.items()}; sk = opt.init(pk)
        pp = {k: v.detach().clone() for k, v in p.items()}; sp = opt.init(pp)
        online_sgd.online_adapt_viterbinet(pk, sk, y, states, N, 1e-3)
        torch.cuda.synchronize()
        online_sgd.online_adapt_viterbinet_plain(pp, sp, y, states, N, 1e-3)
        err = max(float((pk[k] - pp[k]).abs().max()) for k in pk)
        merr = max(float((sk.mu[k] - sp.mu[k]).abs().max()) for k in pk)
        print("K6", T, N, "max|dparam|", err, "max|dmu|", merr, sk.count, sp.count, flush=True)
        # resume
        online_sgd.online_adapt_viterbinet(pk, sk, y, states, N, 1e-3)
        online_sgd.online_adapt_viterbinet_plain(pp, sp, y, states, N, 1e-3)
        torch.cuda.synchronize()
        print("K6 resumed", max(float((pk[k] - pp[k]).abs().max()) for k in pk), flush=True)
        s = torch.cuda.Event(enable_timing=True); e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(5): online_sgd.online_adapt_viterbinet(pk, sk, y, states, N, 1e-3)
        e.record(); e.synchronize(); print("K6 ms per call", T, N, s.elapsed_time(e) / 5, flush=True)
    pri = torch.randn((1, 136, 16), generator=g, device="cuda")
    s.record()
    for _ in range(100): acs.viterbi_decode_kernel(pri)
    e.record(); e.synchronize(); print("K5 1x136 ms per eager call", s.elapsed_time(e) / 100)


if __name__ == "__main__":
    main()
