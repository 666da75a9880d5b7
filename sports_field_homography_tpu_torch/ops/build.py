"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources compile with ``nvcc`` into one shared library with a plain C
interface, loaded with ``ctypes``.  The library is built on first use into
``build/torch_kernels/`` at the root of the checkout, under a name keyed by
a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads at once.  Nothing here runs at import time: the CPU
tests import every module on a machine without ``nvcc``.

Each C entry point launches on the stream it is given, never synchronises,
and returns ``cudaGetLastError()``; ``check`` turns a non-zero code into an
exception.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["load_library", "check", "build_dir", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures: name -> argtypes (every function returns an int error code)
_SIGNATURES = {
    "sfh_warp_nearest": [_P, _I, _I, _P, _I, _I, _I, _I, _I, _I,
                         _F, _F, _F, _F, _F, _P, _P],
    "sfh_conv3x3": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "sfh_deconv2x2": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
}


def build_dir() -> Path:
    return _PKG.parent / "build" / "torch_kernels"


def _sources():
    return sorted(list(_CSRC.glob("*.cu")) + list(_CSRC.glob("*.cuh")))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    out_dir = build_dir()
    so = out_dir / f"libsfh_kernels_{_digest()}.so"
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cus = [str(s) for s in _sources() if s.suffix == ".cu"]
        cmd = [_nvcc()] + NVCC_FLAGS + ["-o", str(tmp)] + cus
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = out_dir / (so.stem + ".log")
        log.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stderr[-4000:]}")
        os.replace(tmp, so)
        load_library.build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


load_library.build_seconds = 0.0


def check(code: int, what: str) -> None:
    """Raise if a kernel launch reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
