"""Build the CUDA sources under ``ops/csrc`` into a plain-C shared library.

``nvcc`` compiles every ``*.cu`` of ``csrc/`` for ``sm_90a`` (H100), one
process per source, all started together, and links them into
``build/torch_kernels/<hash>/libmoco_kernels.so`` at the repository root,
where ``<hash>`` covers the sources and the flags, so an edited source
rebuilds and an unchanged one is reused. The library exposes a C interface
and is loaded with ``ctypes``: no PyTorch headers are compiled, so a build
takes seconds. Building happens at the first kernel launch, never at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
# full-precision sinf/cosf: no --use_fast_math (the top NeRF band, 2^9,
# pushes sin/cos arguments to ~1e3 rad, where the fast intrinsics are wrong)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def library_path() -> Path:
    srcs = sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16] / "libmoco_kernels.so"


def build() -> tuple[Path, str]:
    """Compile the library if it is not built yet; returns (path, the
    compiler's output, which lists each kernel's registers and shared
    memory). Raises with the compiler's output if nvcc fails."""
    out = library_path()
    if out.exists():
        return out, "(cached build)"
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    # one nvcc per source, all started together, then one link
    srcs = sorted(_CSRC.glob("*.cu"))
    objs = [tmp.with_name(f"{p.stem}.{os.getpid()}.o") for p in srcs]
    procs = [(subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o),
                                str(p)], stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True), p)
             for p, o in zip(srcs, objs)]
    log = ""
    failed = []
    for proc, p in procs:
        out_txt = proc.communicate()[0]
        log += f"--- {p.name}\n{out_txt}"
        if proc.returncode != 0:
            failed.append(p.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{log}")
    link = [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
            *map(str, objs)]
    proc = subprocess.run(link, capture_output=True, text=True)
    log += proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed (rc={proc.returncode}):\n"
                           f"{' '.join(link)}\n{log}")
    for o in objs:
        o.unlink()
    os.replace(tmp, out)
    return out, log


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built library with its C functions' signatures declared."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    lib.render_pass_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_void_p]
    lib.render_pass_launch.restype = ctypes.c_int
    lib.render_pass_error.argtypes = [ctypes.c_int]
    lib.render_pass_error.restype = ctypes.c_char_p
    args = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    for name in ("nerf_fwd_launch", "nerf_bwd_launch", "chain_fwd_launch",
                 "chain_bwd_launch", "nof_fwd_launch", "nof_bwd_launch",
                 "fused_mlp_nerf_launch", "fused_mlp_nof_launch",
                 "wg_probe_launch"):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = ctypes.c_int
    for name in ("nerf_bwd_scratch_bytes", "chain_bwd_scratch_bytes",
                 "nof_bwd_scratch_bytes"):
        getattr(lib, name).argtypes = args[:2]
        getattr(lib, name).restype = ctypes.c_int64
    lib.wgrad_reduce.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_int64, ctypes.c_void_p,
                                 ctypes.c_void_p]
    lib.wgrad_reduce.restype = ctypes.c_int
    for name in ("nerf_bwd_error", "chain_bwd_error", "fused_mlp_error"):
        getattr(lib, name).argtypes = [ctypes.c_int]
        getattr(lib, name).restype = ctypes.c_char_p
    return lib
