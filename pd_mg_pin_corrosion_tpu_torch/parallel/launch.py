"""Spawning the ranks of a mesh on one host.

``spawn(fn, world_size, backend, device, *args)`` starts ``world_size``
processes (``torch.multiprocessing.spawn``), joins them in one process
group through a ``FileStore`` in a temporary directory, builds each one's
``Mesh`` (``sharding.make_mesh``) and calls ``fn(mesh, *args)``; it
returns every rank's result, in rank order. It is the counterpart of the
JAX package's virtual CPU mesh: ``gloo`` with ``device="cpu"`` runs a mesh
on the CPU, ``gloo`` with ``device="cuda"`` puts every rank on one card,
and ``nccl`` gives each rank a card of its own. On a machine with N cards,
``torchrun --nproc-per-node N`` starts the same ranks; there
``make_mesh`` reads the launcher's environment.

The children re-import the module that defines ``fn``, so ``fn`` lives in
an importable module (``parallel.checks``), never in a script's
``__main__``.
"""

from __future__ import annotations

import os
import pickle
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def spawn(fn, world_size: int, backend: str, device, *args) -> list:
    """fn(mesh, *args) on ``world_size`` ranks; returns their results.
    CPU ranks run one intra-op thread each (their host is shared); the
    ranks other than 0 print nothing (rank 0 prints the run's lines)."""
    with tempfile.TemporaryDirectory(prefix="pd_mesh_") as tmp:
        device = None if device is None else str(device)
        mp.spawn(_rank_main, args=(world_size, backend, device, tmp,
                                   fn, args),
                 nprocs=world_size, join=True)
        out = []
        for rank in range(world_size):
            with open(os.path.join(tmp, f"result_{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _rank_main(rank, world_size, backend, device, tmp, fn, args):
    from .sharding import make_mesh

    if device == "cpu":
        torch.set_num_threads(1)
    # the ranks share this host: gloo's pairs connect over the loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if rank > 0:
        sys.stdout = open(os.devnull, "w")
    store = dist.FileStore(os.path.join(tmp, "store"), world_size)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size)
    try:
        result = fn(make_mesh(world_size, backend, device), *args)
        with open(os.path.join(tmp, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()
