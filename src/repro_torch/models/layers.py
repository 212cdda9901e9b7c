"""Core neural layers: RMSNorm, RoPE, GQA attention (full sequence and
one-token decode against a KV cache) and the gated MLP, as plain functions
on tensors (the port of the JAX package's ``models/layers.py``; MLA, M-RoPE
and cross-attention are not ported yet).  Parameters are nested dicts of
tensors with the JAX package's names, shapes and layouts.

Conventions
-----------
- activations: [batch, seq, d_model] unless noted
- attention tensors: [batch, seq, heads, head_dim]
- every product accumulates in float32 and is cast back to the activation
  dtype where the JAX package casts (``preferred_element_type=float32``):
  :func:`einsum_f32` upcasts its operands, so a bf16 product is exact in
  float32 before the one rounding, on every device.
- initialisers draw from a seeded ``torch.Generator`` on the target device.
  ``lead`` prepends the stacked-unit axis: the JAX package vmaps one unit's
  init over ``n_units`` keys, so every per-layer leaf has a leading
  ``[n_units]`` axis, and the port keeps that layout.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.config import ArchConfig

Shape = Sequence[int]


def einsum_f32(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``einsum`` with float32 operands and result (the JAX package's
    ``preferred_element_type=jnp.float32`` on bf16 or f32 inputs)."""
    return torch.einsum(eq, *[o.float() for o in ops])


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP Queue A, "
        f"remaining workloads: MLA with MTP, enc-dec, M-RoPE and the "
        f"vision frontend)")


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def _dense_init(gen: torch.Generator, shape: Shape, in_axis_size: int,
                dtype: torch.dtype, lead: Shape = ()) -> torch.Tensor:
    scale = 1.0 / np.sqrt(max(in_axis_size, 1))
    out = torch.empty((*lead, *shape), dtype=torch.float32,
                      device=gen.device)
    return out.uniform_(-scale, scale, generator=gen).to(dtype)


def dense_param(gen: torch.Generator, d_in: int, d_out, dtype: torch.dtype,
                lead: Shape = ()) -> torch.Tensor:
    shape = (d_in, d_out) if isinstance(d_out, int) else (d_in, *d_out)
    return _dense_init(gen, shape, d_in, dtype, lead)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype: torch.dtype, device, lead: Shape = ()
                 ) -> dict:
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                            / head_dim))


@functools.lru_cache(maxsize=None)
def rope_table(head_dim: int, theta: float, device: torch.device
               ) -> torch.Tensor:
    """The float32 frequencies [head_dim/2] on ``device``, copied there once
    per (head_dim, theta, device).  A copy from host memory on every call
    would be illegal inside a CUDA-graph capture (the decode step's); the
    values are those of :func:`rope_frequencies` rounded to float32, as
    before.  Callers only read the table."""
    return torch.tensor(rope_frequencies(head_dim, theta),
                        dtype=torch.float32, device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """Standard rotary embedding (half-split rotation, float32 angles).
    x: [B,S,H,hd]; positions: [B,S] (int)."""
    freqs = rope_table(x.shape[-1], float(theta), x.device)
    ang = positions[..., None].float() * freqs                  # [B,S,hd/2]
    cos = torch.cos(ang)[:, :, None, :]                         # [B,S,1,hd/2]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention core
# ---------------------------------------------------------------------------

def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B,S,Hkv,hd] -> [B,S,Hkv*n_rep,hd] by head-group broadcast."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d) \
        .reshape(b, s, h * n_rep, d)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, q_offset: Union[int, torch.Tensor] = 0,
                   softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Scaled dot-product attention with GQA broadcast.

    q: [B,Sq,Hq,hd]  k,v: [B,Skv,Hkv,hd(v)]  -> [B,Sq,Hq,hd_v]
    ``q_offset``: absolute position of q[0] (for decode: the cache fill,
    an int or a 0-d tensor on q's device).  Masked logits are the finite
    -1e30, as in the JAX package, not -inf.  The probabilities are cast to
    v's dtype before P.V, as in the JAX package.
    """
    sq, hq, hd = q.shape[1], q.shape[2], q.shape[3]
    n_rep = hq // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    scale = softmax_scale if softmax_scale is not None else 1.0 / np.sqrt(hd)
    logits = einsum_f32("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(k.shape[1], device=q.device)[None, :]
        logits = logits.masked_fill(~(qpos >= kpos)[None, None], -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return einsum_f32("bhqk,bkhd->bqhd", probs, v).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------

def gqa_init(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype,
             lead: Shape = ()) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p = {
        "wq": dense_param(gen, d, (cfg.n_heads, hd), dtype, lead),
        "wk": dense_param(gen, d, (cfg.n_kv_heads, hd), dtype, lead),
        "wv": dense_param(gen, d, (cfg.n_kv_heads, hd), dtype, lead),
        "wo": _dense_init(gen, (cfg.n_heads, hd, d), cfg.n_heads * hd, dtype,
                          lead),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, dtype, gen.device, lead)
        p["k_norm"] = rmsnorm_init(hd, dtype, gen.device, lead)
    return p


def _project_qkv(p: dict, cfg: ArchConfig, x: torch.Tensor,
                 positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = einsum_f32("bsd,dhk->bshk", x, p["wq"]).to(x.dtype)
    k = einsum_f32("bsd,dhk->bshk", x, p["wk"]).to(x.dtype)
    v = einsum_f32("bsd,dhk->bshk", x, p["wv"]).to(x.dtype)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if cfg.rope_type == "standard":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope_type != "none":
        raise not_ported(f"rope_type={cfg.rope_type!r} (M-RoPE)")
    return q, k, v


def gqa_forward(p: dict, cfg: ArchConfig, x: torch.Tensor,
                positions: torch.Tensor, *, causal: bool = True,
                training: bool = False) -> torch.Tensor:
    """Full self-attention (train / prefill). Returns [B,S,d].

    ``training=True`` keeps :func:`attention_core` (autograd, the JAX
    package's training attention); the inference forward goes through
    ``kernels.flash_attention``: the CUDA kernel on the card, its plain
    version on the CPU.  The two differ at bf16 by one rounding: the kernel
    keeps the probabilities in float32 for P.V."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    if training:
        out = attention_core(q, k, v, causal=causal)
    else:
        out = flash_attention(q, k, v, causal=causal)
    return einsum_f32("bshk,hkd->bsd", out, p["wo"]).to(x.dtype)


def gqa_decode(p: dict, cfg: ArchConfig, x: torch.Tensor, cache: dict,
               positions: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """One-token decode against a KV cache, updated in place.

    cache: {"k": [B,S,Hkv,hd], "v": [B,S,Hkv,hd], "index": 0-d int32}
    x: [B,1,d].  The new K/V row is cast to the cache dtype and written at
    ``index``; attention runs over the whole cache with the causal mask at
    ``q_offset=index`` (unfilled slots masked), in plain torch as in the
    JAX package; then ``index`` moves by one.  Returns (y [B,1,d], cache):
    the same cache tensors, so a Kishu session sees the in-place write.
    """
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    idx = cache["index"]
    slot = idx.reshape(1).long()
    k, v = cache["k"], cache["v"]
    k.index_copy_(1, slot, k_new.to(k.dtype))
    v.index_copy_(1, slot, v_new.to(v.dtype))
    out = attention_core(q, k, v, causal=True, q_offset=idx)
    y = einsum_f32("bshk,hkd->bsd", out, p["wo"]).to(x.dtype)
    idx.add_(1)
    return y, cache


def gqa_cache_init(cfg: ArchConfig, batch: int, seq: int,
                   dtype: torch.dtype, device, lead: Shape = ()) -> dict:
    """Zeroed KV cache (the JAX package's leaves; ``lead`` prepends the
    stacked-unit axis)."""
    hd = cfg.resolved_head_dim
    return {
        "k": torch.zeros((*lead, batch, seq, cfg.n_kv_heads, hd),
                         dtype=dtype, device=device),
        "v": torch.zeros((*lead, batch, seq, cfg.n_kv_heads, hd),
                         dtype=dtype, device=device),
        "index": torch.zeros(tuple(lead), dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# gated MLP
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d: int, d_ff: int, dtype: torch.dtype,
             lead: Shape = ()) -> dict:
    return {
        "w_gate": dense_param(gen, d, d_ff, dtype, lead),
        "w_up": dense_param(gen, d, d_ff, dtype, lead),
        "w_down": dense_param(gen, d_ff, d, dtype, lead),
    }


def mlp_forward(p: dict, x: torch.Tensor) -> torch.Tensor:
    g = einsum_f32("bsd,df->bsf", x, p["w_gate"])
    u = einsum_f32("bsd,df->bsf", x, p["w_up"])
    h = (F.silu(g) * u).to(x.dtype)
    return einsum_f32("bsf,fd->bsd", h, p["w_down"]).to(x.dtype)
