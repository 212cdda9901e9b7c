"""Public wrapper for GQA flash attention on ``[B, S, H, hd]`` tensors,
forward only (the prefill's attention).

``flash_attention(q, k, v, causal=True)`` takes q ``[B,S,Hq,hd]`` and k, v
``[B,S,Hkv,hd]`` with ``Hq % Hkv == 0`` and returns ``[B,S,Hq,hd]`` in q's
dtype: the contract of the JAX package's
``kernels/flash_attention/ops.py:flash_attention``.  ``softmax_scale``
(default ``1/sqrt(hd)``, the JAX contract's) scales the scores, as the
kernel's own argument does.  CUDA tensors go
through the CUDA kernel, which reads them in place through their strides
(no transposed copies, no repeated K/V) and launches or raises; CPU tensors
go through the plain torch version below.  Unlike the JAX wrapper, any S
is taken: the kernel masks its ragged last tile.

The kernel has two routes, chosen by :func:`flash_route` from dtype and
strides before the launch (never after a failure): ``"tc"``, bf16 on the
tensor cores with TMA loads, for bf16 tensors TMA can address; ``"fma"``,
float32 FMAs on the CUDA cores, for float32 and any other layout.

Forward only, like the TPU kernel: with grad enabled, a tensor that
requires grad raises instead of returning a result without a gradient.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _lib

MAX_HEAD_DIM = 256
ROUTES = ("tc", "fma")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NEG_INF = -1e30          # the finite mask value of the JAX kernel


def _shape(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
           ) -> Tuple[int, int, int, int, int]:
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"flash_attention: want q [B,S,Hq,hd] and k, v "
                         f"[B,S,Hkv,hd]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, s, hd) or hkv == 0 \
            or hq % hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)} do not form GQA heads")
    return b, s, hq, hkv, hd


def _forward_only(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                  ) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention is forward-only: call it under "
                           "torch.no_grad() or on tensors that do not "
                           "require grad (training uses attention_core)")


def _tma_addressable(t: torch.Tensor) -> bool:
    """A [B,S,H,hd] bf16 tensor TMA can read as 4-D (d, h, s, b): dim
    stride 1, the other strides and the base on 16 bytes, hd a multiple of
    8 up to 256."""
    hd = t.shape[-1]
    return (t.dtype == torch.bfloat16 and t.stride(3) == 1
            and 0 < hd <= MAX_HEAD_DIM and hd % 8 == 0
            and all(st > 0 and st % 8 == 0 for st in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def flash_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel route for these operands, from dtype and strides alone:
    ``"tc"`` when q, k and v are bf16 and TMA can address each of them,
    else ``"fma"``."""
    return "tc" if all(_tma_addressable(t) for t in (q, k, v)) else "fma"


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          softmax_scale: Optional[float] = None
                          ) -> torch.Tensor:
    """Plain torch version (the JAX package's ``flash_attention_ref`` with
    its GQA repeat): float32 scores, the finite causal mask, softmax,
    float32 P.V, cast to q's dtype."""
    _, s, hq, hkv, hd = _shape(q, k, v)
    n_rep = hq // hkv
    if n_rep > 1:
        k = torch.repeat_interleave(k, n_rep, dim=2)
        v = torch.repeat_interleave(v, n_rep, dim=2)
    scale = 1.0 / np.sqrt(hd) if softmax_scale is None else softmax_scale
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, *, causal: bool = True,
                         route: str = "",
                         softmax_scale: Optional[float] = None
                         ) -> torch.Tensor:
    """Launch the kernel on CUDA tensors of one card and one dtype
    (float32 or bfloat16), any strides, head dim up to 256.  Returns a
    new contiguous ``[B,S,Hq,hd]`` tensor on the card.  ``route`` forces
    ``"fma"`` (any operands) or ``"tc"`` (operands :func:`flash_route`
    sends there); by default :func:`flash_route` picks it."""
    b, s, hq, hkv, hd = _shape(q, k, v)
    _forward_only(q, k, v)
    dev = q.device
    if not (q.is_cuda and k.device == dev and v.device == dev):
        raise ValueError("flash_attention: q, k and v must lie on one card")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}; the kernel takes float32 or bfloat16")
    if hd > MAX_HEAD_DIM or b * hq > 65535:
        raise ValueError(f"flash_attention: head dim {hd} (max "
                         f"{MAX_HEAD_DIM}) or B*Hq {b * hq} (max 65535)")
    chosen = flash_route(q, k, v)
    route = route or chosen
    if route not in ROUTES or (route == "tc" and chosen != "tc"):
        raise ValueError(f"flash_attention: route {route!r} does not take "
                         f"these operands (flash_route says {chosen!r})")
    out = torch.empty((b, s, hq, hd), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    scale = float(1.0 / np.sqrt(hd) if softmax_scale is None
                  else softmax_scale)
    with torch.cuda.device(dev):
        if route == "tc":
            _lib.call("kishu_flash_attention_tc", q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, hq,
                      hkv, hd, int(causal), scale, *q.stride()[:3],
                      *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                      _lib.stream_of(q))
        else:
            _lib.call("kishu_flash_attention", q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), out.data_ptr(), b, s, hq, hkv, hd,
                      _DTYPE_CODES[q.dtype], int(causal), scale,
                      *q.stride(), *k.stride(), *v.stride(), *out.stride(),
                      _lib.stream_of(q))
    _lib.note_launch("flash_attention", route)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    softmax_scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,S,Hq,hd]; k, v: [B,S,Hkv,hd] (Hq % Hkv == 0) -> [B,S,Hq,hd]."""
    _shape(q, k, v)
    _forward_only(q, k, v)
    if q.is_cuda and k.is_cuda and v.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal,
                                    softmax_scale=softmax_scale)
    if q.device.type == k.device.type == v.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     softmax_scale=softmax_scale)
    raise ValueError(f"flash_attention: unsupported devices {q.device}, "
                     f"{k.device}, {v.device}")
