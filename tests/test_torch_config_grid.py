"""PyTorch port vs the JAX package: config parsing, grid, grains, kit and
initial state, on the same inputs. All of these are exact (bit-for-bit)."""

import dataclasses
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pd_mg_pin_corrosion_tpu import Config as JConfig
from pd_mg_pin_corrosion_tpu import build_grid as j_build_grid
from pd_mg_pin_corrosion_tpu import build_kit as j_build_kit
from pd_mg_pin_corrosion_tpu import grains as j_grains
from pd_mg_pin_corrosion_tpu import initialize_state as j_initialize_state
from pd_mg_pin_corrosion_tpu_torch import Config as TConfig
from pd_mg_pin_corrosion_tpu_torch import build_grid as t_build_grid
from pd_mg_pin_corrosion_tpu_torch import build_kit as t_build_kit
from pd_mg_pin_corrosion_tpu_torch import grains as t_grains
from pd_mg_pin_corrosion_tpu_torch import initialize_state as t_initialize_state
from pd_mg_pin_corrosion_tpu_torch import state_from_numpy

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARITY = os.path.join(ROOT, "tests", "golden", "parity.cfg")
FINE = os.path.join(ROOT, "config", "params_fine_calibration.cfg")
CFGS = sorted(glob.glob(os.path.join(ROOT, "config", "*.cfg"))) + [PARITY]

# the two 2D grids of this file: parity.cfg and the fine-calibration
# workload at a reduced dx (its shipped 2.5 um grid has 196,749 nodes)
GRIDS = {"parity": (PARITY, []), "fine_dx10um": (FINE, ["dx=1e-5"])}


def _load_both(path, overrides=()):
    j, t = JConfig.load(path), TConfig.load(path)
    if overrides:
        j.apply_overrides(list(overrides))
        t.apply_overrides(list(overrides))
    return j, t


@pytest.mark.parametrize("path", CFGS, ids=os.path.basename)
def test_config_fields_equal(path):
    j, t = _load_both(path)
    jf = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
    tf = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
    assert jf == tf


def test_config_overrides_and_frozen_copy():
    j, t = _load_both(PARITY, ["precision=f64", "flow_max_iters=123",
                               "R_wire=2.5e-5"])
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    kit = t_build_kit(t_build_grid(t), t, device="cpu")
    t.flow_max_iters = 7          # the kit keeps its own snapshot
    assert kit.cfg.flow_max_iters == 123
    with pytest.raises(dataclasses.FrozenInstanceError):
        kit.cfg.flow_max_iters = 1


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_grid_and_grains_equal(name):
    j, t = _load_both(*GRIDS[name])
    jg, tg = j_build_grid(j), t_build_grid(t)
    assert (jg.Nx, jg.Ny, jg.Nz, jg.origin) == (tg.Nx, tg.Ny, tg.Nz, tg.origin)
    for a in ("node_type", "pos", "mirror_idx"):
        np.testing.assert_array_equal(getattr(jg, a), getattr(tg, a))
    for a in ("offsets", "dist", "evec", "vol"):
        np.testing.assert_array_equal(getattr(jg.stencil, a),
                                      getattr(tg.stencil, a))
    jgr, tgr = j_grains.generate(jg, j), t_grains.generate(tg, t)
    assert jgr.n_grains == tgr.n_grains
    for a in ("grain_id", "is_grain_boundary", "is_precipitate"):
        np.testing.assert_array_equal(getattr(jgr, a), getattr(tgr, a))


@pytest.mark.parametrize("precision", ["f32", "f64"])
@pytest.mark.parametrize("name", sorted(GRIDS))
def test_kit_arrays_equal(name, precision):
    j, t = _load_both(GRIDS[name][0],
                      GRIDS[name][1] + [f"precision={precision}"])
    jg, tg = j_build_grid(j), t_build_grid(t)
    jk, tk = j_build_kit(jg, j), t_build_kit(tg, t, device="cpu")
    assert str(tk.dtype).split(".")[-1] == jk.dtype
    for a in ("inlet_mask", "outlet_mask", "wall_mask", "near_inlet_mask",
              "near_outlet_mask", "v_pois", "initial_solid_mask",
              "mirror_none_mask"):
        np.testing.assert_array_equal(np.asarray(getattr(jk, a)),
                                      getattr(tk, a).numpy(), err_msg=a)
    for a in ("dim", "shape", "mext", "offsets", "dist", "evec", "vol",
              "inlet_rows", "outlet_rows", "S", "alpha", "V_H", "beta_lap"):
        assert getattr(jk, a) == getattr(tk, a), a
    assert list(jk.bond_iter()) == list(tk.bond_iter())

    # the port's flat mirror gather moves exactly the JAX roll groups' values
    masks = np.asarray(jk.mirror_group_masks)
    mirror = tk.mirror_mask.numpy()
    src = tk.mirror_src.numpy()
    np.testing.assert_array_equal(mirror, masks.any(axis=0))
    jj, ii = np.indices(jk.shape)
    for g, (dj, di) in enumerate(jk.mirror_group_offsets):
        sel = masks[g]
        np.testing.assert_array_equal(src[sel],
                                      (jj[sel] + dj) * jk.shape[1] + ii[sel] + di)

    # shift / neighbors agree with the JAX kit's padded static slices
    rng = np.random.default_rng(1)
    a = rng.random(jk.shape)
    jp, tp = jk.pad(jnp.asarray(a), 0.0), tk.pad(torch.as_tensor(a), 0.0)
    nb = tk.neighbors(tp).numpy()
    for s in range(jk.S):
        np.testing.assert_array_equal(np.asarray(jk.shift(jp, s)),
                                      tk.shift(tp, s).numpy())
        np.testing.assert_array_equal(np.asarray(jk.shift(jp, s)), nb[s])


@pytest.mark.parametrize("precision", ["f32", "f64"])
@pytest.mark.parametrize("name", sorted(GRIDS))
def test_initial_state_equal(name, precision):
    j, t = _load_both(GRIDS[name][0],
                      GRIDS[name][1] + [f"precision={precision}"])
    jg, tg = j_build_grid(j), t_build_grid(t)
    jk, tk = j_build_kit(jg, j), t_build_kit(tg, t, device="cpu")
    js = j_initialize_state(jg, j, grains=j_grains.generate(jg, j),
                            dtype=jk.jdtype)
    ts = t_initialize_state(tg, t, grains=t_grains.generate(tg, t),
                            dtype=tk.dtype, device="cpu")
    carried = state_from_numpy(
        {f.name: np.asarray(getattr(js, f.name))
         for f in dataclasses.fields(js)}, dtype=tk.dtype, device="cpu")
    for f in dataclasses.fields(ts):
        a, b, c = (np.asarray(getattr(js, f.name)),
                   getattr(ts, f.name).numpy(),
                   getattr(carried, f.name).numpy())
        assert a.dtype == b.dtype == c.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
        np.testing.assert_array_equal(a, c, err_msg=f.name)
