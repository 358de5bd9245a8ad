"""Checkpoint / resume.

Port of ``pd_mg_pin_corrosion_tpu/checkpoint.py``, file-compatible with it:
the same ``.npz`` keys (every State field, ``t_corr``, ``meta``,
``fingerprint``, ``fp_grid``, ``cfg_json``), the same IO/cadence keys left
out of the fingerprint, and the same hashes, so a checkpoint written by
either package resumes in the other. The State crosses to the host as
numpy arrays of the same dtypes the JAX package stores; loading puts each
field back on the template's device and dtype. The file is written to a
temporary name and renamed, so a killed run keeps the previous checkpoint.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np
import torch

from .fields import State

# config keys that may differ between the writing and the resuming run
# (IO/cadence settings and the stop time: none affects whether the stored
# state is compatible with the resuming run's physics)
_IO_KEYS = frozenset({
    "output_dir", "resume_from", "checkpoint_every", "implicit_output_every",
    "diagnostic_every", "output_every_flow", "output_every_corr", "T_final",
    "flow_max_iters", "flow_max_iters_resolve", "flow_output_stride",
    "flow_warm_start",
    "corrosion_steps_per_check", "dissolution_batch",
    "implicit_fused_chunk", "coupled_fused_cycles",
    "coupled_launch_steps", "coupled_launch_flow_iters",
    "vtk_binary",
})


def cfg_items_json(cfg) -> str:
    """The physics-relevant config keys as a canonical JSON string (IO and
    cadence keys left out), stored beside the fingerprint so a mismatch
    can be explained key by key."""
    cfg_items = {f.name: getattr(cfg, f.name)
                 for f in dataclasses.fields(cfg) if f.name not in _IO_KEYS}
    return json.dumps(cfg_items, sort_keys=True, default=str)


def _hash_grid(h, grid) -> None:
    h.update(np.int64(grid.node_type.size).tobytes())
    h.update(np.asarray(grid.node_type.shape, np.int64).tobytes())
    h.update(np.ascontiguousarray(grid.node_type).tobytes())


def grid_fingerprint(grid) -> str:
    """Hash of the grid identity alone (shape + node_type bytes)."""
    h = hashlib.sha256()
    _hash_grid(h, grid)
    return h.hexdigest()


def fingerprint(cfg, grid) -> str:
    """Hash of the physics config + grid identity, verified on resume."""
    h = hashlib.sha256()
    h.update(cfg_items_json(cfg).encode())
    _hash_grid(h, grid)
    return h.hexdigest()


def _diff_cfg_json(stored_json: str, current_json: str) -> str:
    """Human-readable key diff between two cfg_items_json strings."""
    try:
        a, b = json.loads(stored_json), json.loads(current_json)
    except ValueError:
        return "(cfg diff unavailable)"
    lines = [f"    {k}: checkpoint={a.get(k, '<absent>')!r}  "
             f"current={b.get(k, '<absent>')!r}"
             for k in sorted(set(a) | set(b))
             if a.get(k, "<absent>") != b.get(k, "<absent>")]
    return "\n".join(lines) if lines else "(no differing keys)"


def save_checkpoint(path: str, state: State, t_corr: float, meta: dict,
                    fp: str = "", fp_grid: str = "",
                    cfg_json: str = "") -> None:
    arrays = {f.name: getattr(state, f.name).cpu().numpy()
              for f in dataclasses.fields(State)}
    tmp = path + ".tmp"
    # uncompressed, as the JAX package writes it (np.load reads both)
    np.savez(tmp, t_corr=t_corr, meta=json.dumps(meta),
             fingerprint=fp, fp_grid=fp_grid, cfg_json=cfg_json, **arrays)
    # numpy appends .npz to names without it
    os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", path)
    print(f"  Checkpoint written: {path} (t={t_corr:.1f} s)")


def load_checkpoint(path: str, template: State, fp: str = "",
                    force: bool = False, fp_grid: str = "",
                    cfg_json: str = ""):
    """Returns (state, t_corr, meta); ``template`` supplies dtypes and the
    device.

    If both the checkpoint and the caller give a fingerprint, they must
    match. ``force`` turns a config mismatch into a warning with a key
    diff; a grid mismatch (when both sides record one) is always fatal.
    """
    with np.load(path, allow_pickle=False) as z:
        stored_fp = str(z["fingerprint"]) if "fingerprint" in z else ""
        stored_fpg = str(z["fp_grid"]) if "fp_grid" in z else ""
        stored_cj = str(z["cfg_json"]) if "cfg_json" in z else ""
        if fp and stored_fp and fp != stored_fp:
            diff = (_diff_cfg_json(stored_cj, cfg_json)
                    if stored_cj and cfg_json else "(cfg diff unavailable)")
            if fp_grid and stored_fpg and fp_grid != stored_fpg:
                raise ValueError(
                    f"checkpoint {path} was written for a DIFFERENT GRID "
                    f"(grid fingerprint {stored_fpg[:12]}… != "
                    f"{fp_grid[:12]}…); refusing to resume even under force")
            if not force:
                raise ValueError(
                    f"checkpoint {path} was written for a different "
                    f"config/grid (fingerprint {stored_fp[:12]}… != expected "
                    f"{fp[:12]}…); refusing to resume.\n"
                    f"  Differing config keys:\n{diff}")
            print(f"WARNING: resuming {path} despite config fingerprint "
                  f"mismatch (PD_TPU_RESUME_FORCE). Differing keys:\n{diff}")
        kwargs = {}
        for f in dataclasses.fields(State):
            ref = getattr(template, f.name)
            kwargs[f.name] = torch.as_tensor(z[f.name]).to(
                device=ref.device, dtype=ref.dtype)
        t_corr = float(z["t_corr"])
        meta = json.loads(str(z["meta"]))
    return State(**kwargs), t_corr, meta
