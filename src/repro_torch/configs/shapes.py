"""Assigned input shapes and abstract input specs for the dry run (the port
of the JAX package's ``configs/shapes.py``).

Every (arch x shape) cell resolves to a *step kind* plus a tree of
stand-in tensors on the ``meta`` device (shape and dtype, no storage):

  train_4k    -> train_step   tokens/labels [256, 4096]
  prefill_32k -> prefill_step tokens [32, 32768]
  decode_32k  -> serve_step   1 new token, KV/SSM cache filled to 32768, B=128
  long_500k   -> serve_step   1 new token, cache 524288, B=1 (sub-quadratic only)

Modality frontends are stubs: audio provides encoder frame embeddings,
vlm provides patch/text embeddings + M-RoPE position ids.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.core.serialize import torch_dtype
from repro_torch.models import lm
from repro_torch.models.config import ArchConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: str) -> Tuple[bool, str]:
    """(applicable, reason-if-not)."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, ("long_500k needs sub-quadratic attention; "
                       f"{cfg.name} is pure full-attention (see DESIGN.md §5)")
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    dt = torch_dtype(dtype) if isinstance(dtype, str) else dtype
    return torch.empty(tuple(shape), dtype=dt, device="meta")


def to_meta(tree: Any) -> Any:
    """A tree of (fake) tensors as ``meta`` tensors of the same shapes and
    dtypes."""
    if isinstance(tree, dict):
        return {k: to_meta(v) for k, v in tree.items()}
    return _meta(tree.shape, tree.dtype)


def abstract(fn, *args, **kwargs) -> Any:
    """``fn``'s tree of tensors as meta stand-ins, built under a fake
    tensor mode (no allocation: the JAX package's ``eval_shape``)."""
    with FakeTensorMode():
        out = fn(*args, **kwargs)
    return to_meta(out)


def token_batch(cfg: ArchConfig, batch: int, seq: int, *,
                labels: bool) -> Dict[str, Any]:
    """Abstract input batch for full-sequence steps."""
    d = cfg.d_model
    b: Dict[str, Any] = {}
    if cfg.frontend == "vision":
        b["embeds"] = _meta((batch, seq, d), cfg.dtype)
        b["positions_thw"] = _meta((batch, seq, 3), torch.int32)
    else:
        b["tokens"] = _meta((batch, seq), torch.int32)
    if cfg.enc_dec:
        b["enc_embeds"] = _meta((batch, seq, d), cfg.dtype)
    if labels:
        b["labels"] = _meta((batch, seq), torch.int32)
    return b


def decode_batch(cfg: ArchConfig, batch: int) -> Dict[str, Any]:
    b: Dict[str, Any] = {"index": _meta((), torch.int32)}
    if cfg.frontend == "vision":
        b["embeds"] = _meta((batch, 1, cfg.d_model), cfg.dtype)
    else:
        b["tokens"] = _meta((batch, 1), torch.int32)
    return b


def abstract_params(cfg: ArchConfig) -> Dict[str, Any]:
    """Meta stand-ins of the parameter tree."""
    return abstract(lm.init_params, cfg, torch.Generator())


def abstract_caches(cfg: ArchConfig, batch: int, seq: int) -> Dict[str, Any]:
    """Meta stand-ins of the decode caches (no allocation)."""
    return abstract(lm.init_caches, cfg, batch, seq, device="cpu",
                    enc_seq=min(seq, 4096) if cfg.enc_dec else 0)


def input_specs(cfg: ArchConfig, shape: str) -> Dict[str, Any]:
    """Returns {"kind", "batch", and for decode "caches"} — all abstract."""
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        raise ValueError(f"{cfg.name} x {shape}: {why}")
    s = SHAPES[shape]
    if s.kind == "train":
        return {"kind": "train",
                "batch": token_batch(cfg, s.global_batch, s.seq_len,
                                     labels=True)}
    if s.kind == "prefill":
        return {"kind": "prefill",
                "batch": token_batch(cfg, s.global_batch, s.seq_len,
                                     labels=False)}
    return {"kind": "decode",
            "batch": decode_batch(cfg, s.global_batch),
            "caches": abstract_caches(cfg, s.global_batch, s.seq_len)}


def cells(arch_ids: Optional[List[str]] = None
          ) -> List[Tuple[str, str, bool, str]]:
    """All (arch, shape, applicable, reason) cells — 40 total."""
    from repro_torch import configs as cfgs
    from repro_torch.models.config import get_config
    out = []
    for a in (arch_ids or cfgs.ARCH_IDS):
        cfg = get_config(a)
        for sh in SHAPES:
            ok, why = shape_applicable(cfg, sh)
            out.append((a, sh, ok, why))
    return out
