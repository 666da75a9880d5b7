"""Device dispatch shared by the kernel wrappers.

A wrapper takes its plain PyTorch version only for tensors on the CPU, and
launches its CUDA kernel for tensors on a CUDA device.  Anything else
raises: there is no fallback from a failed kernel to the plain version.
For the ``sfh`` operators (``ops/library.py``) the dispatcher makes that
choice and the wrappers check the devices before it.
"""
from __future__ import annotations

import contextlib

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on the CPU, False when every tensor is on
    one CUDA device; raises on a mix or on any other device."""
    same_device(*tensors)
    dev = tensors[0].device
    if dev.type == "cpu":
        return True
    if dev.type == "cuda":
        return False
    raise ValueError(f"unsupported device {dev}")


def same_device(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on one device (the operators' fake
    implementations, whose tensors may be fake or on ``meta``)."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")


def check_pixels(n: int, h: int, w: int) -> None:
    """The kernels index pixels with 32-bit ints."""
    if n * h * w >= 2 ** 31:
        raise ValueError(f"{n}x{h}x{w} pixels exceed the kernels' int32 range")


def dtype_code(dtype: torch.dtype) -> int:
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, not {dtype}")
    return _DTYPE_CODES[dtype]


def on_device(device: torch.device):
    """A context that makes ``device`` the current CUDA device: a no-op
    where it already is, ``torch.cuda.device(device)`` otherwise."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def stream_handle(device: torch.device) -> int:
    """PyTorch's current stream on ``device`` as a raw ``cudaStream_t``;
    kernels launch on it (under ``torch.cuda.device(device)``) and never
    synchronise.  Read with the call PyTorch's own generated kernels use,
    which skips building a ``torch.cuda.Stream`` (a few microseconds a
    launch on the host)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The plain versions' accumulation dtype: float32 for bf16 and f32
    inputs, float64 for float64 inputs (a float64 reference run)."""
    return torch.promote_types(dtype, torch.float32)
