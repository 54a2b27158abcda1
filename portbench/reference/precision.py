"""The arithmetic of the reference's products.

``fp32``: every product in fp32, TF32 off (``strict_fp32``). ``fp8``: the
control. Both operands of each product are rounded to float8 e4m3 with one
scale a tensor (its largest magnitude to 448, e4m3's largest value), and
the gradient that reaches a product's output is rounded alike before the
backward products take it; the products then run in fp32 on the rounded
values, as an fp8 tensor core accumulates in fp32."""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def strict_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class _RoundOperand(torch.autograd.Function):
    """fp8 rounding in the forward; the gradient passes through."""

    @staticmethod
    def forward(ctx, x):
        return round_fp8(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundGrad(torch.autograd.Function):
    """The identity in the forward; the gradient rounded to fp8."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return round_fp8(g)


class Precision:
    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "fp8"):
            raise ValueError(f"precision is fp32 or fp8, got {mode!r}")
        self.mode = mode

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor):
        if self.mode == "fp32":
            return torch.einsum(eq, a, b)
        out = torch.einsum(eq, _RoundOperand.apply(a), _RoundOperand.apply(b))
        return _RoundGrad.apply(out) if out.requires_grad else out
