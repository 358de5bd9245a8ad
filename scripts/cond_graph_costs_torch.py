#!/usr/bin/env python3
"""What a conditional node costs on the card, for the port's gated graphs
(``kernels.device_loop.CondGraph``).

    python3 scripts/cond_graph_costs_torch.py [n_kernels]

Times, by CUDA events over 20 launches after one, on one card:

* a plain PyTorch graph of ``n_kernels`` tiny kernels (an in-place add on
  1,024 floats), replayed;
* the same kernels copied into a CondGraph (node by node), alone and
  followed by one IF node whose flag is false (a graph with a conditional
  node runs on the device's own launcher);
* the kernels inside an IF whose flag is false and true;
* 50 IF nodes in a row with false flags (each a handle-setting kernel and
  a conditional node that is skipped), and 50 nested ones with true flags
  around 4 kernels each;
* a WHILE whose body runs 5 times.

Prints one line a case (device us a launch, host us a launch) and the
card's name and power limit. Needs a card; builds the port's kernel
library at first use.
"""

import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pd_mg_pin_corrosion_tpu_torch.kernels import build  # noqa: E402
from pd_mg_pin_corrosion_tpu_torch.kernels.device_loop import CondGraph  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("cond_graph_costs_torch.py needs a CUDA card")
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1600
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    build.load()
    dev = torch.device("cuda", 0)
    x = torch.zeros(1024, device=dev)
    flags = torch.zeros(4, dtype=torch.bool, device=dev)
    side = torch.cuda.Stream()
    pool = torch.cuda.graph_pool_handle()
    keep = []

    def piece(k, extra=None):
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.stream(side):
            g.capture_begin(pool=pool)
            for _ in range(k):
                x.add_(1.0)
            if extra is not None:
                extra()
            g.capture_end()
        keep.append(g)
        return g

    def timed(tag, launch, reps=20):
        launch()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        for _ in range(reps):
            launch()
        t1 = time.perf_counter()
        b.record()
        b.synchronize()
        print(f"{tag}: device {1e3 * a.elapsed_time(b) / reps:.1f} us, host "
              f"{1e6 * (t1 - t0) / reps:.1f} us a launch")

    plain = piece(n)
    plain.instantiate()
    timed(f"plain graph of {n} kernels", plain.replay)
    copied = CondGraph(dev)
    copied.add(piece(n).raw_cuda_graph())
    copied.instantiate()
    timed(f"{n} kernels copied into a CondGraph", copied.launch)
    with_if = CondGraph(dev)
    with_if.add(piece(n).raw_cuda_graph())
    with_if.begin_if(flags[1])
    with_if.add(piece(1).raw_cuda_graph())
    with_if.end_if()
    with_if.instantiate()
    timed(f"{n} kernels, then one IF (false)", with_if.launch)
    gated = CondGraph(dev)
    gated.begin_if(flags[0])
    gated.add(piece(n).raw_cuda_graph())
    gated.end_if()
    gated.instantiate()
    timed(f"IF (false) around {n} kernels", gated.launch)
    flags[0] = True
    timed(f"IF (true) around {n} kernels", gated.launch)
    flags.zero_()
    row = CondGraph(dev)
    for _ in range(50):
        row.begin_if(flags[1])
        row.add(piece(32).raw_cuda_graph())
        row.end_if()
    row.instantiate()
    timed("50 IF (false) in a row", row.launch)
    nested = CondGraph(dev)
    for _ in range(50):
        nested.begin_if(flags[0])
        nested.add(piece(4).raw_cuda_graph())
    for _ in range(50):
        nested.end_if()
    nested.instantiate()
    flags[0] = True
    timed("50 nested IF (true) around 4 kernels each", nested.launch)
    cnt = torch.zeros((), device=dev)
    loop = CondGraph(dev)
    loop.begin_while(flags[3])
    loop.add(piece(n // 5, lambda: (cnt.add_(1.0),
                                    flags[3].copy_(cnt % 5 != 0))
                   ).raw_cuda_graph())
    loop.end_while()
    loop.instantiate()

    def five():
        flags[3].fill_(True)
        loop.launch()
    timed(f"WHILE running 5 times over {n // 5} kernels (and its flag's "
          f"fill)", five)


if __name__ == "__main__":
    main()
