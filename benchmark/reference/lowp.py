"""The control: the reference put in the program's place one precision
below the configuration's.  For a bfloat16 configuration that is fp8
(e4m3): every convolution's and linear layer's input, weight and bias
are rounded to float8_e4m3fn with one scale per tensor (its largest magnitude
onto 448, the format's largest value), then computed in float32.  The
gradient passes the rounding straight through.

``to_bf16_model`` is no control but a witness: the reference computed in
the configuration's own precision, which shows what bfloat16 alone moves.
"""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["fp8_round", "to_fp8_model", "to_bf16_model"]

_FP8_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 with a per-tensor scale, back in x's dtype."""
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = amax / _FP8_MAX
    q = (x.float() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q.to(x.dtype) - x).detach()


class _FP8(nn.Module):
    def forward(self, w):
        return fp8_round(w)


def to_fp8_model(model: nn.Module) -> nn.Module:
    """Round the inputs, weights and biases of ``model``'s conv and linear
    layers to fp8 at every call (load the weights first: the
    parametrization renames them in the state dict)."""
    from torch.nn.utils import parametrize

    for m in list(model.modules()):
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            parametrize.register_parametrization(m, "weight", _FP8())
            if m.bias is not None:
                parametrize.register_parametrization(m, "bias", _FP8())
            m.register_forward_pre_hook(lambda mod, args: (fp8_round(args[0]),) + args[1:])
    return model


def to_bf16_model(model: nn.Module) -> nn.Module:
    """The reference computed in bfloat16: its parameters and buffers cast,
    its input cast at the call, its outputs returned in float32."""
    model.to(torch.bfloat16)
    model.register_forward_pre_hook(lambda mod, args: tuple(
        a.to(torch.bfloat16) if torch.is_tensor(a) and a.is_floating_point() else a
        for a in args))
    model.register_forward_hook(lambda mod, args, out: tuple(o.float() for o in out))
    return model
