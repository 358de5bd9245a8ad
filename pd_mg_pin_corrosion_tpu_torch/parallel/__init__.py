"""Multi-GPU scale-out: axial-slab domain decomposition over
``torch.distributed`` (``sharding``: the mesh, the slabs of the State and
the Kit, the reductions; ``shard_kernels``: the halo exchange and the ops
on a slab; ``launch``: spawning the ranks of one host)."""
