"""VTK output: ASCII or binary VTI (ImageData), ASCII VTU of block-AMR
grids, and crash-safe PVD.

Port of ``pd_mg_pin_corrosion_tpu/io_vtk.py`` (reference
src/vtk_writer.cpp): the same 10 point-data arrays in the same
order and names, WALL/OUTSIDE velocity zeroed for visualization, NaN audit,
subnormal flush, and the PVD collection rewritten after every snapshot.
The ASCII file is byte-identical to the JAX package's for the same state.
The state crosses to the host as one packed float array and one packed
uint8 array.
"""

from __future__ import annotations

import io
import os
import re
import sys

import numpy as np
import torch

from . import native


def _safe(a: np.ndarray) -> np.ndarray:
    """NaN/inf -> 0 and subnormal flush (vtk_writer.cpp:8-14)."""
    a = np.where(np.isfinite(a), a, 0.0)
    return np.where((a != 0.0) & (np.abs(a) < 1e-300), 0.0, a)


def vti_arrays(grid, state, filename=None):
    """(name, type-tag, host data) in the reference's array order. With
    ``filename`` the NaN audit runs and warns on stderr."""
    dim = grid.dim
    n = state.rho.numel()
    fpack = torch.cat(
        [state.vel.reshape(n, dim)]
        + [a.reshape(n, 1) for a in
           (state.pressure, state.rho, state.C, state.D_map)],
        dim=1).cpu().numpy().astype(np.float64)
    upack = torch.stack(
        [a.reshape(n).to(torch.uint8) for a in
         (state.phase, state.node_type, state.is_gb, state.is_precip)],
        dim=1).cpu().numpy()
    gid = state.grain_id.reshape(n).cpu().numpy().astype(np.int32)

    if filename is not None:
        n_nan = int(np.isnan(fpack[:, :dim]).any(axis=1).sum())
        n_nan += int(np.isnan(fpack[:, dim:dim + 3]).any(axis=1).sum())
        if n_nan > 0:
            print(f"WARNING: {n_nan} NaN values detected when writing "
                  f"{filename}", file=sys.stderr)

    nt = upack[:, 1]
    fictitious = (nt == 2) | (nt == 5)  # WALL | OUTSIDE zeroed for viz
    vel3 = np.zeros((n, 3))
    vel3[:, :dim] = _safe(fpack[:, :dim])
    vel3[fictitious] = 0.0
    return [
        ("velocity", "Float64", vel3),
        ("pressure", "Float64", _safe(fpack[:, dim])),
        ("density", "Float64", _safe(fpack[:, dim + 1])),
        ("concentration", "Float64", _safe(fpack[:, dim + 2])),
        ("phase", "UInt8", upack[:, 0]),
        ("node_type", "UInt8", nt),
        ("grain_id", "Int32", gid),
        ("D_map", "Float64", _safe(fpack[:, dim + 3])),
        ("is_grain_boundary", "UInt8", upack[:, 2]),
        ("is_precipitate", "UInt8", upack[:, 3]),
    ]


def _image_header(out, grid, extra=""):
    nx, ny = grid.Nx, grid.Ny
    nz = grid.Nz if grid.dim == 3 else 1
    oz = grid.origin[2] if grid.dim == 3 else 0.0
    out.write('<?xml version="1.0"?>\n')
    out.write('<VTKFile type="ImageData" version="1.0" '
              f'byte_order="LittleEndian"{extra}>\n')
    out.write(
        f'  <ImageData WholeExtent="0 {nx - 1} 0 {ny - 1} 0 {nz - 1}"'
        f' Origin="{grid.origin[0]:g} {grid.origin[1]:g} {oz:g}"'
        f' Spacing="{grid.dx:g} {grid.dx:g} {grid.dx:g}">\n')
    out.write(f'    <Piece Extent="0 {nx - 1} 0 {ny - 1} 0 {nz - 1}">\n')
    out.write('      <PointData Scalars="phase" Vectors="velocity">\n')


class VTKWriter:
    def __init__(self):
        self._pvd_path = ""
        self._entries: list[tuple[float, str]] = []
        self._pending = None   # at most one in-flight background write
        self._bg_err = None

    # ------------------------------------------------------------------
    def flush(self) -> None:
        """Join the in-flight background (binary) VTI write."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._bg_err is not None:
            err, self._bg_err = self._bg_err, None
            raise err

    def write(self, filename: str, grid, state, cfg) -> None:
        """VTI ImageData: ASCII (byte-compatible with the reference's
        vtk_writer.cpp:16-146) or, with cfg.vtk_binary, VTK XML
        appended-raw binary written on a background thread."""
        arrays = vti_arrays(grid, state, filename)
        if getattr(cfg, "vtk_binary", 0):
            self._write_binary(filename, grid, arrays)
        else:
            self._write_ascii(filename, grid, arrays)

    def _write_ascii(self, filename, grid, arrays) -> None:
        out = io.StringIO()
        _image_header(out, grid)
        for name, tag, data in arrays:
            comp = ' NumberOfComponents="3"' if data.ndim > 1 else ""
            out.write(f'        <DataArray type="{tag}" Name="{name}"{comp} '
                      'format="ascii">\n')
            if data.ndim > 1:
                out.write(native.fmt_vec3_block(data))
            elif tag == "Float64":
                out.write(native.fmt_scalar_block(data))
            else:
                out.write(native.fmt_int_block(data.astype(np.int64)))
            out.write("        </DataArray>\n")
        out.write("      </PointData>\n    </Piece>\n  </ImageData>\n")
        out.write("</VTKFile>\n")
        with open(filename, "w") as f:
            f.write(out.getvalue())

    def _write_binary(self, filename, grid, arrays) -> None:
        import threading

        self.flush()

        def bg():
            try:
                self._serialize_binary(filename, grid, arrays)
            except BaseException as e:  # surfaced by the next flush()
                self._bg_err = e

        th = threading.Thread(target=bg, daemon=True)
        th.start()
        self._pending = th

    @staticmethod
    def _serialize_binary(filename, grid, arrays) -> None:
        head = io.StringIO()
        _image_header(head, grid, ' header_type="UInt64"')
        offset = 0
        payload = []
        for name, tag, data in arrays:
            ncomp = data.shape[1] if data.ndim > 1 else 1
            comp = f' NumberOfComponents="{ncomp}"' if ncomp > 1 else ""
            head.write(f'        <DataArray type="{tag}" Name="{name}"{comp} '
                       f'format="appended" offset="{offset}"/>\n')
            raw = np.ascontiguousarray(data).tobytes()
            payload.append(np.uint64(len(raw)).tobytes())
            payload.append(raw)
            offset += 8 + len(raw)
        head.write("      </PointData>\n    </Piece>\n  </ImageData>\n")
        head.write('  <AppendedData encoding="raw">\n_')
        with open(filename, "wb") as f:
            f.write(head.getvalue().encode())
            for chunk in payload:
                f.write(chunk)
            f.write(b"\n  </AppendedData>\n</VTKFile>\n")

    def write_vtu(self, filename: str, grid, state) -> None:
        """ASCII VTU of a block-AMR grid (vtk_writer.cpp:199-346): one
        VTK_VERTEX cell per node, OUTSIDE nodes left out, WALL velocity
        zeroed, each node's grid_level and dx_local beside the state;
        byte-identical to the JAX package's ``write_vtu``."""
        arrays = {name: data for name, _, data in
                  vti_arrays(grid, state, filename)}
        idx = np.flatnonzero(arrays["node_type"] != 5)  # not OUTSIDE
        n_out = idx.size
        pos3 = np.zeros((n_out, 3))
        pos3[:, :grid.dim] = grid.pos.reshape(-1, grid.dim)[idx]

        out = io.StringIO()
        out.write('<?xml version="1.0"?>\n')
        out.write('<VTKFile type="UnstructuredGrid" version="1.0" '
                  'byte_order="LittleEndian">\n')
        out.write("  <UnstructuredGrid>\n")
        out.write(f'    <Piece NumberOfPoints="{n_out}" '
                  f'NumberOfCells="{n_out}">\n')
        out.write("      <Points>\n")
        out.write('        <DataArray type="Float64" NumberOfComponents="3" '
                  'format="ascii">\n')
        out.write(native.fmt_vec3_block(pos3))
        out.write("        </DataArray>\n      </Points>\n")
        out.write("      <Cells>\n")
        for name, tag, data in (
                ("connectivity", "Int32", np.arange(n_out)),
                ("offsets", "Int32", np.arange(1, n_out + 1)),
                ("types", "UInt8", np.ones(n_out))):
            out.write(f'        <DataArray type="{tag}" Name="{name}" '
                      'format="ascii">\n')
            out.write(native.fmt_int_block(data.astype(np.int64)))
            out.write("        </DataArray>\n")
        out.write("      </Cells>\n")
        out.write('      <PointData Scalars="phase" Vectors="velocity">\n')
        out.write('        <DataArray type="Float64" Name="velocity" '
                  'NumberOfComponents="3" format="ascii">\n')
        out.write(native.fmt_vec3_block(arrays["velocity"][idx]))
        out.write("        </DataArray>\n")
        arrays["grid_level"] = grid.grid_level
        arrays["dx_local"] = grid.dx_local
        for name, tag in (("pressure", "Float64"),
                          ("concentration", "Float64"), ("phase", "UInt8"),
                          ("node_type", "UInt8"), ("grid_level", "Int32"),
                          ("dx_local", "Float64"), ("grain_id", "Int32"),
                          ("D_map", "Float64"), ("is_grain_boundary", "UInt8"),
                          ("is_precipitate", "UInt8")):
            data = arrays[name][idx]
            out.write(f'        <DataArray type="{tag}" Name="{name}" '
                      'format="ascii">\n')
            out.write(native.fmt_scalar_block(data.astype(np.float64))
                      if tag == "Float64"
                      else native.fmt_int_block(data.astype(np.int64)))
            out.write("        </DataArray>\n")
        out.write("      </PointData>\n    </Piece>\n  </UnstructuredGrid>\n"
                  "</VTKFile>\n")
        with open(filename, "w") as f:
            f.write(out.getvalue())

    # ------------------------------------------------------------------
    def set_pvd_path(self, path: str) -> None:
        self._pvd_path = path

    def load_pvd(self, filename: str, t_max: float | None = None) -> int:
        """Reload the collection of an existing PVD (resume): entries after
        ``t_max`` (written past the checkpoint being resumed) and entries
        whose file is missing are dropped. Returns the number kept."""
        if not os.path.exists(filename):
            return 0
        pvd_dir = filename[: filename.rfind("/") + 1] if "/" in filename else ""
        pat = re.compile(r'<DataSet timestep="([^"]+)" file="([^"]+)"/>')
        entries = []
        with open(filename) as f:
            for line in f:
                m = pat.search(line)
                if m and (t_max is None or float(m.group(1)) <= t_max + 1e-9):
                    entries.append((float(m.group(1)), pvd_dir + m.group(2)))
        # a crash between the PVD rewrite and the (asynchronous) VTI write
        # can leave a trailing entry without its file
        kept = [(t, f) for t, f in entries if os.path.exists(f)]
        if len(kept) != len(entries):
            n = len(entries) - len(kept)
            print(f"WARNING: {n} PVD entr{'y' if n == 1 else 'ies'} in "
                  f"{filename} reference missing files; dropped",
                  file=sys.stderr)
        self._entries = kept
        return len(kept)

    def add_timestep(self, time: float, vti_file: str) -> None:
        self._entries.append((time, vti_file))
        if self._pvd_path:
            self.write_pvd(self._pvd_path)

    def write_pvd(self, filename: str) -> None:
        """Rewrite the full collection (crash-safe, vtk_writer.cpp:160-193)."""
        pvd_dir = filename[: filename.rfind("/") + 1] if "/" in filename else ""
        with open(filename, "w") as out:
            out.write('<?xml version="1.0"?>\n')
            out.write('<VTKFile type="Collection" version="1.0" byte_order="LittleEndian">\n')
            out.write("  <Collection>\n")
            for t, f in self._entries:
                rel = f[len(pvd_dir):] if pvd_dir and f.startswith(pvd_dir) else f
                out.write(f'    <DataSet timestep="{t:.6e}" file="{rel}"/>\n')
            out.write("  </Collection>\n")
            out.write("</VTKFile>\n")
