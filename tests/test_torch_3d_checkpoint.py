"""Checkpoint / resume of the port and the 3D VTI writer, against the JAX
package: the same fingerprints; a checkpoint written by either package
resumes in the other (and in the port itself) and the resumed run's rows
equal the uninterrupted run's; a 3D state's VTI is byte-identical to the
JAX writer's. The run is test_torch_3d_slice.py's small 3D config in f64,
interrupted after its second coupling cycle (t = 12 s of 21 s)."""

import dataclasses
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pd_mg_pin_corrosion_tpu import Config as JConfig
from pd_mg_pin_corrosion_tpu import build_grid as j_build_grid
from pd_mg_pin_corrosion_tpu import build_kit as j_build_kit
from pd_mg_pin_corrosion_tpu import checkpoint as j_ckpt
from pd_mg_pin_corrosion_tpu import grains as j_grains
from pd_mg_pin_corrosion_tpu import initialize_state as j_initialize_state
from pd_mg_pin_corrosion_tpu.io_vtk import VTKWriter as JWriter
from pd_mg_pin_corrosion_tpu_torch import Config as TConfig
from pd_mg_pin_corrosion_tpu_torch import build_grid as t_build_grid
from pd_mg_pin_corrosion_tpu_torch import checkpoint as t_ckpt
from pd_mg_pin_corrosion_tpu_torch import initialize_state as t_initialize_state
from pd_mg_pin_corrosion_tpu_torch import state_from_numpy
from pd_mg_pin_corrosion_tpu_torch.io_vtk import VTKWriter as TWriter
from test_torch_3d_slice import CFG_3D, SMALL, assert_rows_match, run_jax, run_port

torch.set_num_threads(2)

F64 = ["precision=f64", "checkpoint_every=1"]


def _interrupted(runner, out):
    """Run to t = 12 s: the end of cycle 2, checkpointed."""
    runner(out, [*F64, "T_final=12"])
    return f"{out}/checkpoint.npz"


def _resumed(runner, out, ckpt):
    return runner(out, [*F64, f"resume_from={ckpt}"])


def test_fingerprints_equal():
    j, t = JConfig.load(CFG_3D), TConfig.load(CFG_3D)
    for c in (j, t):
        c.apply_overrides([*SMALL, *F64])
    jg, tg = j_build_grid(j), t_build_grid(t)
    assert t_ckpt.cfg_items_json(t) == j_ckpt.cfg_items_json(j)
    assert t_ckpt.grid_fingerprint(tg) == j_ckpt.grid_fingerprint(jg)
    assert t_ckpt.fingerprint(t, tg) == j_ckpt.fingerprint(j, jg)
    # an IO key changes nothing, a physics key changes the fingerprint
    t.T_final, t.output_dir = 1.0, "elsewhere"
    assert t_ckpt.fingerprint(t, tg) == j_ckpt.fingerprint(j, jg)
    t.D_gb = 1e-9
    assert t_ckpt.fingerprint(t, tg) != j_ckpt.fingerprint(j, jg)


def test_resume_across_packages(tmp_path):
    _, full = run_port(tmp_path / "full", F64)
    assert len(full) == 7 and full["time_s"][3] == 12.0

    # one interrupted port run, copied three times: resumed by the port, by
    # JAX, and by the port from the JAX package's writer (the same state
    # read back and written by it)
    ckpt = _interrupted(run_port, tmp_path / "pp")
    for name in ("pj", "jp"):
        shutil.copytree(tmp_path / "pp", tmp_path / name)
    j = JConfig.load(CFG_3D)
    j.apply_overrides([*SMALL, *F64])
    jg = j_build_grid(j)
    fp, fp_grid, cfg_json = (j_ckpt.fingerprint(j, jg),
                             j_ckpt.grid_fingerprint(jg),
                             j_ckpt.cfg_items_json(j))
    state, t_corr, meta = j_ckpt.load_checkpoint(
        ckpt, j_initialize_state(jg, j, dtype=jnp.float64), fp,
        fp_grid=fp_grid, cfg_json=cfg_json)
    assert t_corr == 12.0 and meta["cycle"] == 2
    j_ckpt.save_checkpoint(str(tmp_path / "jp" / "jax.npz"), state, t_corr,
                           meta, fp, fp_grid=fp_grid, cfg_json=cfg_json)

    # the port resumes its own checkpoint: the same rows, bit for bit, and
    # the snapshot collection continued, not restarted
    with open(tmp_path / "pp" / "simulation.pvd") as f:
        before = [ln for ln in f if "<DataSet" in ln]
    solver, rows = _resumed(run_port, tmp_path / "pp", ckpt)
    assert solver.cycles == 5 and solver.total_dissolved == 96
    np.testing.assert_array_equal(rows, full)
    with open(tmp_path / "pp" / "simulation.pvd") as f:
        after = [ln for ln in f if "<DataSet" in ln]
    assert after[:len(before)] == before and len(after) > len(before)

    # the port resumes the JAX-written file: the same rows again
    _, rows = _resumed(run_port, tmp_path / "jp", tmp_path / "jp" / "jax.npz")
    np.testing.assert_array_equal(rows, full)

    # JAX resumes the port's file
    rows = _resumed(run_jax, tmp_path / "pj", tmp_path / "pj" / "checkpoint.npz")
    assert_rows_match(rows, full, f64=True)


def test_resume_refuses_another_grid(tmp_path):
    t = TConfig.load(CFG_3D)
    t.apply_overrides([*SMALL, *F64])
    grid = t_build_grid(t)
    ckpt = str(tmp_path / "ckpt.npz")
    t_ckpt.save_checkpoint(ckpt, t_initialize_state(
                               grid, t, dtype=torch.float64, device="cpu"),
                           0.0, {"cycle": 0}, t_ckpt.fingerprint(t, grid),
                           fp_grid=t_ckpt.grid_fingerprint(grid),
                           cfg_json=t_ckpt.cfg_items_json(t))
    with pytest.raises(ValueError, match="DIFFERENT GRID"):
        run_port(tmp_path / "b", [*F64, "L_wire=56e-6", f"resume_from={ckpt}"])
    with pytest.raises(ValueError, match="D_gb"):
        run_port(tmp_path / "c", [*F64, "D_gb=1e-9", f"resume_from={ckpt}"])


@pytest.mark.parametrize("binary", [0, 1])
@pytest.mark.parametrize("precision", ["f32", "f64"])
def test_vti_3d_bytes_match_jax_writer(precision, binary, tmp_path):
    cfg = JConfig.load(CFG_3D)
    cfg.apply_overrides([*SMALL, f"precision={precision}",
                         f"vtk_binary={binary}"])
    grid = j_build_grid(cfg)
    kit = j_build_kit(grid, cfg)
    js = j_initialize_state(grid, cfg, grains=j_grains.generate(grid, cfg),
                            dtype=kit.jdtype)
    rng = np.random.default_rng(8)
    js = dataclasses.replace(
        js, C=jnp.asarray(rng.random(kit.shape), kit.jdtype),
        vel=jnp.asarray(rng.normal(size=kit.shape + (3,)), kit.jdtype))
    ts = state_from_numpy({f.name: np.asarray(getattr(js, f.name))
                           for f in dataclasses.fields(js)},
                          dtype=torch.float32 if precision == "f32" else torch.float64,
                          device="cpu")
    tcfg = TConfig.load(CFG_3D)
    tcfg.apply_overrides([*SMALL, f"precision={precision}"])
    a, b = str(tmp_path / "jax.vti"), str(tmp_path / "port.vti")
    jw, tw = JWriter(), TWriter()
    jw.write(a, grid, js, cfg)
    tw.write(b, t_build_grid(tcfg), ts, cfg)
    jw.flush()
    tw.flush()
    with open(a, "rb") as fa, open(b, "rb") as fb:
        data = fa.read()
        assert data == fb.read()
    assert b'WholeExtent="0 18 0 18 0 22"' in data
    assert os.path.getsize(b) > 8303 * 8
