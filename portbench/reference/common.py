"""Operations the references share: RMSNorm, a float32 product with TF32
off or from float8 e4m3 operands, and a path lookup in a parameter tree.
"""
from __future__ import annotations

from typing import Optional

import torch

FP8_MAX = 448.0          # largest finite float8 e4m3fn


def tree_get(tree: dict, path: str):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float
            ) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale for the tensor (its
    largest magnitude onto 448), back in float32."""
    s = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def matmul(a: torch.Tensor, b: torch.Tensor, quant: Optional[str] = None
           ) -> torch.Tensor:
    """``a @ b`` in float32.  ``quant="fp8"`` rounds both operands to
    float8 e4m3 first (the control); anything else is an error."""
    if quant == "fp8":
        a, b = fp8(a), fp8(b)
    elif quant is not None:
        raise ValueError(f"unknown quantisation {quant!r}")
    return a @ b


def strict_float32() -> None:
    """Float32 products stay float32 on the card: no TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
