"""Int8 error-feedback gradient compression over a mesh axis: the port of
the JAX package's ``optim/compression.py``.

Gradients are quantized to int8 against a globally agreed scale (one MAX
all-reduce of a scalar), summed with a SUM all-reduce in int32 (exact: the
reduction adds no quantization noise), and dequantized; each rank's
quantization residual is carried forward and added to the next step's
gradient (error feedback), so the scheme is unbiased over time.  The int8
values are widened to int32 for the sum exactly where the JAX package
widens them (``psum(q.astype(int32))``).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.optim.adamw import tree_map


def _quantize(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)


def quantized_psum(g32: torch.Tensor, group=None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One float32 leaf: (int32 sum over ``group`` of the int8 quantized
    values, the shared scale, this rank's int8 values)."""
    amax = g32.abs().max().reshape(())
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = _quantize(g32, scale)
    s = q.to(torch.int32)
    dist.all_reduce(s, op=dist.ReduceOp.SUM, group=group)
    return s, scale, q


def compressed_psum(grads: Any, residual: Any, mesh, axis: str
                    ) -> Tuple[Any, Any]:
    """All-reduce-mean ``grads`` (trees of plain tensors, laid out alike
    on every rank of ``mesh``'s ``axis``) with an int8 payload and error
    feedback.  Returns (mean gradients, new residual), both float32."""
    group = mesh.get_group(axis)
    n = mesh.size(mesh.mesh_dim_names.index(axis))

    def one(g, r):
        g32 = g.float() + r
        s, scale, q = quantized_psum(g32, group)
        new_r = g32 - q.float() * scale             # error feedback
        return s.float() * scale / n, new_r

    outs = tree_map(one, grads, residual)
    leaf = lambda t: isinstance(t, tuple)
    return (_unzip(outs, 0, leaf), _unzip(outs, 1, leaf))


def _unzip(tree: Any, i: int, is_pair) -> Any:
    if is_pair(tree):
        return tree[i]
    return {k: _unzip(v, i, is_pair) for k, v in tree.items()}


def residual_init(grads_like: Any) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)

