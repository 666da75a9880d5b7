"""Device dispatch shared by the kernel wrappers.

A wrapper takes its plain PyTorch version only for tensors on the CPU, and
launches its CUDA kernel for tensors on a CUDA device.  Anything else
raises: there is no fallback from a failed kernel to the plain version.
"""
from __future__ import annotations

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on the CPU, False when every tensor is on
    one CUDA device; raises on a mix or on any other device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type == "cuda":
        return False
    raise ValueError(f"unsupported device {dev}")


def check_pixels(n: int, h: int, w: int) -> None:
    """The kernels index pixels with 32-bit ints."""
    if n * h * w >= 2 ** 31:
        raise ValueError(f"{n}x{h}x{w} pixels exceed the kernels' int32 range")


def dtype_code(dtype: torch.dtype) -> int:
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, not {dtype}")
    return _DTYPE_CODES[dtype]


def stream_handle(device: torch.device) -> int:
    """PyTorch's current stream on ``device``; kernels launch on it (under
    ``torch.cuda.device(device)``) and never synchronise."""
    return torch.cuda.current_stream(device).cuda_stream


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The plain versions' accumulation dtype: float32 for bf16 and f32
    inputs, float64 for float64 inputs (a float64 reference run)."""
    return torch.promote_types(dtype, torch.float32)
