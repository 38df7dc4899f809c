"""The reference's arithmetic: plain float32 with TF32 off, and the control.

The configurations state float32 results (the program's ``highest`` mode).
The reference multiplies in float32 with TF32 off in cuBLAS and cuDNN. The
control is the same reference one precision lower, in TF32: each operand of
every matrix product rounded to TF32 (10 mantissa bits, to nearest, ties
away from zero) and the product summed in float32. That is the arithmetic
of a TF32 tensor-core product, made explicit so that it is the same on the
CPU and on the card; in training the control's backward products are
rounded the same way.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def fp32():
    """float32 products: TF32 off in cuBLAS and cuDNN inside the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32, held in float32."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32Matmul(torch.autograd.Function):
    """``a @ b`` for ``a`` of shape (..., K) and ``b`` of shape (K, N), every
    product of the forward and the backward on TF32-rounded operands."""

    @staticmethod
    def forward(ctx, a, b):
        a32, b32 = to_tf32(a), to_tf32(b)
        ctx.save_for_backward(a32, b32)
        return a32 @ b32

    @staticmethod
    def backward(ctx, g):
        a32, b32 = ctx.saved_tensors
        g32 = to_tf32(g)
        grad_a = g32 @ b32.T
        grad_b = a32.reshape(-1, a32.shape[-1]).T @ g32.reshape(-1, g32.shape[-1])
        return grad_a, grad_b


def matmul(a: torch.Tensor, b: torch.Tensor, control: bool = False) -> torch.Tensor:
    """``a @ b`` in the reference's float32, or in TF32 for the control."""
    return _TF32Matmul.apply(a, b) if control else a @ b
