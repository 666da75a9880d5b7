"""The ``sfh`` operator namespace: the predict path's kernels as PyTorch
operators, so that the dispatcher -- and ``torch.export`` -- sees them.

    sfh::warp_nearest   K1      (ops/warp.py)
    sfh::conv3x3        K2      (ops/conv3x3.py), and sfh::conv3x3_stats
                                with its stats epilogue (the train path)
    sfh::deconv2x2      K3      (ops/deconv.py)
    sfh::bn_relu_norm   K7-fwd's norm (ops/bn_relu.py)

Each operator has three implementations, registered by its module with
``define``: on the CPU the plain PyTorch version, on CUDA the ctypes launch
of the hand-written kernel (with its route checks and launch counters), and
a fake one that gives only the outputs' shapes and dtypes, which tracing
calls on fake tensors (a symbolic batch included).  The public wrappers
(``warp_nearest``, ``conv3x3``, ``deconv2x2``, ``bn_relu_norm``) call the
operators, so an eager call, a training step and an exported program all
launch a kernel the same way.

The operators are bound with ``Library.define`` and ``Library.impl``, the
cheaper of PyTorch's two Python bindings in host time a call (the other is
``torch.library.custom_op``; ``chip_smoke.py`` times both beside the bare
ctypes call).  The training-only kernels (K3-bwd, K5, K7-fwd's stats,
K7-bwd) stay plain ctypes calls: no exported program holds them.
"""
from __future__ import annotations

import importlib

import torch

__all__ = ["LIB", "define", "load_operators", "OPERATOR_MODULES"]

LIB = torch.library.Library("sfh", "DEF")

# the modules whose import registers an operator of the namespace
OPERATOR_MODULES = ("warp", "conv3x3", "deconv", "bn_relu")


def define(schema: str, cpu, cuda, fake) -> torch._ops.OpOverload:
    """Define ``sfh::<schema>`` with its CPU, CUDA and fake implementations;
    returns the operator's default overload (the cheapest handle to call)."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, cpu, "CPU")
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"sfh::{name}", fake, lib=LIB)
    return getattr(torch.ops.sfh, name).default


def load_operators() -> None:
    """Register every ``sfh`` operator (what loading an exported program
    needs): imports the kernel modules, and nothing of the models."""
    for mod in OPERATOR_MODULES:
        importlib.import_module(f"{__package__}.{mod}")
