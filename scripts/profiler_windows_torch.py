#!/usr/bin/env python3
"""How complete a torch.profiler window's records are, the longer a
process runs (the reason chip_smoke.py counts launches from the host-side
launch records).

    python3 scripts/profiler_windows_torch.py [windows] [--flush]

In one process on one CUDA device: every 25 s of busy work (basis_dots at
(26, 166,050) and a small elementwise op, back to back), two profiler
windows (CPU and CUDA activities) in a row, each of a ~10 ms spin kernel,
20 basis_dots calls and a short spin kernel. For each window it prints
one JSON line: the process age, the device kernel records of the spins
(2 when whole) and of basis_dots (20 when whole), and the host-side
launch records (the CUDA runtime's and driver's launch calls: 22). With
``--flush`` each window also calls CUPTI's cuptiActivityFlushAll with the
forced flag before it closes. Needs a CUDA device; imports nothing of
JAX.
"""

import ctypes
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from pd_mg_pin_corrosion_tpu_torch import kernels  # noqa: E402

BUSY_S, CALLS = 25.0, 20
ACTS = [torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]


def libcupti():
    """The CUPTI library the profiler loaded (from /proc/self/maps)."""
    with open("/proc/self/maps") as f:
        paths = sorted({ln.split()[-1] for ln in f if "libcupti" in ln})
    if not paths:
        raise SystemExit("no libcupti in this process")
    return ctypes.CDLL(paths[0])


def window(call, cupti=None):
    call()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=ACTS) as prof:
        torch.cuda._sleep(20_000_000)
        for _ in range(CALLS):
            call()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        if cupti is not None:
            cupti.cuptiActivityFlushAll(ctypes.c_uint32(1))   # FORCED
    ev = prof.events()
    dev = [e for e in ev if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"spin": sum("spin" in e.name for e in dev),
            "dots": sum("dots" in e.name for e in dev),
            "launch_records": sum("LaunchKernel" in e.name for e in ev)}


def main(argv):
    if not torch.cuda.is_available():
        print("profiler_windows_torch: needs a CUDA device", file=sys.stderr)
        return 1
    t0 = time.monotonic()
    windows = int(argv[0]) if argv and argv[0].isdigit() else 11
    n = 166_050
    V = kernels.basis.pitched_basis(26, n, torch.float32, "cuda")
    V.normal_()
    w = torch.randn(n, device="cuda")

    def call():
        kernels.basis_dots(V, w)

    window(call)
    cupti = libcupti() if "--flush" in argv else None
    print(f"[profiler] {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}; flush {cupti is not None}", flush=True)
    x = torch.randn(1 << 16, device="cuda")
    for i in range(windows):
        t = time.monotonic()
        while time.monotonic() - t < BUSY_S:
            for _ in range(200):
                x = x * 1.0000001 + 1e-9
                call()
            torch.cuda.synchronize()
        print(json.dumps({"i": i, "age_s": round(time.monotonic() - t0, 1),
                          "first": window(call, cupti),
                          "second": window(call, cupti)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
