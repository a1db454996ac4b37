"""Host marching cubes: ctypes binding to the native C++ kernel.

Port of ``moco_flow_tpu/ops/mcubes.py`` (which replaces the reference's
PyMCubes) over the port's own copy of its source, ``native/mcubes.cpp``.
The host C++ compiler builds it at first use into
``build/mcubes/<hash>/libmcubes.so`` at the repository root (``<hash>``
covers the source and the flags), never beside the source; a failed build
raises with the compiler's output. Mesh extraction is offline, so the host
CPU is the right place for it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import os.path as osp
import shutil
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "native" / "mcubes.cpp"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "mcubes"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16] / "libmcubes.so"


def build() -> Path:
    """Compile the library unless it is built; raises if the compiler
    fails or is missing."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no host C++ compiler (g++ / c++ / $CXX): "
                           "ops/native/mcubes.cpp cannot be built")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, str(_SRC), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {_SRC.name} failed (rc="
                           f"{proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def _get_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.mc_marching_cubes.restype = ctypes.c_int
    lib.mc_marching_cubes.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.mc_free.argtypes = [ctypes.c_void_p]
    return lib


def marching_cubes(grid: np.ndarray, isovalue: float):
    """The isosurface of a (nx, ny, nz) scalar field: (verts (V, 3) float32
    in grid coordinates, tris (T, 3) int32), shared vertices deduplicated,
    as ``mcubes.marching_cubes``."""
    lib = _get_lib()
    grid = np.ascontiguousarray(grid, np.float32)
    nx, ny, nz = grid.shape
    verts_p = ctypes.POINTER(ctypes.c_float)()
    tris_p = ctypes.POINTER(ctypes.c_int32)()
    nv = ctypes.c_int()
    nt = ctypes.c_int()
    lib.mc_marching_cubes(
        grid.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), nx, ny, nz,
        ctypes.c_float(isovalue), ctypes.byref(verts_p), ctypes.byref(nv),
        ctypes.byref(tris_p), ctypes.byref(nt))
    try:
        verts = np.ctypeslib.as_array(verts_p, (nv.value, 3)).copy() \
            if nv.value else np.zeros((0, 3), np.float32)
        tris = np.ctypeslib.as_array(tris_p, (nt.value, 3)).copy() \
            if nt.value else np.zeros((0, 3), np.int32)
    finally:
        lib.mc_free(verts_p)
        lib.mc_free(tris_p)
    return verts, tris


def export_obj(verts: np.ndarray, tris: np.ndarray, path: str):
    """Minimal OBJ writer (replaces ``mcubes.export_obj``)."""
    os.makedirs(osp.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for t in tris:
            f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")
