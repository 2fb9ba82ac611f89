"""Roundings for the control: the reference computed in a precision below
the configuration's.

``fp8()`` rounds a tensor to float8 with one scale per tensor (its
largest magnitude onto the format's largest value), the way fp8
training scales a tensor: e4m3 for values going forward, e5m2 for
gradients coming back. Passed as the reference's ``rd``.
"""

from __future__ import annotations

import torch


def quantize(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / torch.finfo(dtype).max,
                        torch.ones_like(amax))
    return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return quantize(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return quantize(g, torch.float8_e5m2)


def fp8():
    return _Fp8.apply
