"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with its own ``nvcc`` process, all started together,
and the objects link into one shared library with a plain C interface,
loaded with ``ctypes``.  The library is built on first use into
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures: name -> argtypes (every function returns an int error code)
_SIGNATURES = {
    "sfh_warp_nearest": [_P, _I, _I, _P, _I, _I, _I, _I, _I, _I,
                         _F, _F, _F, _F, _P, _P, _I, _P],
    "sfh_conv3x3": [_P] * 10 + [_I] * 7 + [_P],
    "sfh_conv3x3_sm90": [_P] * 10 + [_I] * 6 + [_P],
    "sfh_wgrad3x3_sm90": [_P] * 3 + [_I] * 7 + [_P],
    "sfh_deconv2x2": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "sfh_deconv2x2_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "sfh_deconv2x2_sm90": [_P] * 4 + [_I] * 5 + [_P],
    "sfh_deconv2x2_bwd_sm90": [_P] * 5 + [_I] * 7 + [_P],
    "sfh_wgrad3x3": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "sfh_bn_relu_bwd": [_P] * 9 + [_I] * 5 + [_P],
    "sfh_bn_relu_bwd_sums": [_P] * 8 + [_I] * 5 + [_P],
    "sfh_bn_relu_bwd_dx": [_P] * 8 + [_I] * 6 + [_P],
    "sfh_bn_relu_stats": [_P, _P, _I, _I, _I, _I, _P],
    "sfh_bn_relu_norm": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "sfh_sum_rows": [_P, _P, _I, _I, _I, _I, _P],
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


def _compile(out_dir: Path, tag: str) -> Path:
    """One nvcc per source, all at once, then one link; returns the .so."""
    so = out_dir / f"libsfh_kernels_{tag}.so"
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    cus = [s for s in _sources() if s.suffix == ".cu"]
    objs = [out_dir / f"{s.stem}_{tag}.{os.getpid()}.o" for s in cus]
    procs = [(subprocess.Popen([nvcc] + NVCC_FLAGS + ["-c", "-o", str(o), str(s)],
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                               text=True), s)
             for s, o in zip(cus, objs)]
    log, failed = [], []
    for proc, src in procs:
        out, err = proc.communicate()
        log.append(f"== {src.name} (exit {proc.returncode})\n{out}{err}")
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{err[-3000:]}")
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp)]
                              + [str(o) for o in objs],
                              capture_output=True, text=True)
        log.append(f"== link (exit {link.returncode})\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append(f"link:\n{link.stderr[-3000:]}")
    for o in objs:
        o.unlink(missing_ok=True)
    (out_dir / f"libsfh_kernels_{tag}.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    out_dir = build_dir()
    tag = _digest()
    so = out_dir / f"libsfh_kernels_{tag}.so"
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        so = _compile(out_dir, tag)
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
