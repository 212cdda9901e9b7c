"""Core neural layers: RMSNorm, RoPE (standard and M-RoPE), GQA attention
(full sequence and one-token decode against a KV cache), the decoder's
cross-attention, MLA attention (DeepSeek-V3: full sequence and decode
against the compressed latent cache) and the gated MLP, as plain
functions on tensors (the port of the JAX package's ``models/layers.py``).
Parameters are nested dicts of tensors with the JAX package's names,
shapes and layouts.

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
    return _rotate(x, positions[..., None].float() * freqs)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """The half-split rotation of x [B,S,H,hd] by float32 angles
    [B,S,hd/2], shared by every head."""
    cos = torch.cos(ang)[:, :, None, :]                         # [B,S,1,hd/2]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=None)
def mrope_section_ids(sections: Tuple[int, int, int], device: torch.device
                      ) -> torch.Tensor:
    """Which of the (t, h, w) position ids rotates each of the head_dim/2
    frequency bands: ``[0]*t + [1]*h + [2]*w`` (int64), built once per
    (sections, device), as :func:`rope_table` is."""
    return torch.tensor(np.repeat(np.arange(3), np.asarray(sections)),
                        dtype=torch.int64, device=device)


def apply_mrope(x: torch.Tensor, positions_thw: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): the head_dim/2 frequency bands are split
    into (t, h, w) sections, each rotated by its own position id.

    x: [B,S,H,hd]; positions_thw: [B,S,3] (int); sections sum to hd//2."""
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"M-RoPE sections {sections} do not sum to head "
                         f"dim {hd} / 2")
    freqs = rope_table(hd, float(theta), x.device)
    sect = mrope_section_ids(tuple(sections), x.device)
    return _rotate(x, positions_thw.float()[..., sect] * freqs)


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
    elif cfg.rope_type == "mrope":
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
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
# cross attention (whisper decoder)
# ---------------------------------------------------------------------------

def cross_attn_init(gen: torch.Generator, cfg: ArchConfig,
                    dtype: torch.dtype, lead: Shape = ()) -> dict:
    return gqa_init(gen, cfg.replace(qk_norm=False), dtype, lead)


def cross_attn_forward(p: dict, cfg: ArchConfig, x: torch.Tensor,
                       enc_out: torch.Tensor) -> torch.Tensor:
    """Decoder cross-attention over the encoder output (no RoPE, no mask).
    x: [B,S,d], enc_out: [B,S_enc,d] -> [B,S,d].  Query and key lengths
    differ, which the flash kernel's contract does not take; the JAX
    package runs this attention in plain XLA too, so it goes through
    :func:`attention_core` in prefill, decode and training alike.  K and
    V are projected from ``enc_out`` on every call, as in the JAX
    package."""
    q = einsum_f32("bsd,dhk->bshk", x, p["wq"]).to(x.dtype)
    k = einsum_f32("bsd,dhk->bshk", enc_out, p["wk"]).to(x.dtype)
    v = einsum_f32("bsd,dhk->bshk", enc_out, p["wv"]).to(x.dtype)
    out = attention_core(q, k, v, causal=False)
    return einsum_f32("bshk,hkd->bsd", out, p["wo"]).to(x.dtype)


# ---------------------------------------------------------------------------
# MLA attention (DeepSeek-V3)
# ---------------------------------------------------------------------------

def mla_init(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype,
             lead: Shape = ()) -> dict:
    m, d, nq = cfg.mla, cfg.d_model, cfg.n_heads
    qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": dense_param(gen, d, m.q_lora_rank, dtype, lead),
        "q_a_norm": rmsnorm_init(m.q_lora_rank, dtype, gen.device, lead),
        "wq_b": dense_param(gen, m.q_lora_rank, (nq, qk_hd), dtype, lead),
        # kv down-projection -> compressed latent + decoupled rope key
        "wkv_a": dense_param(gen, d, m.kv_lora_rank + m.qk_rope_head_dim,
                             dtype, lead),
        "kv_a_norm": rmsnorm_init(m.kv_lora_rank, dtype, gen.device, lead),
        "wkv_b": dense_param(gen, m.kv_lora_rank,
                             (nq, m.qk_nope_head_dim + m.v_head_dim), dtype,
                             lead),
        "wo": _dense_init(gen, (nq, m.v_head_dim, d), nq * m.v_head_dim,
                          dtype, lead),
    }


def _mla_qkv(p: dict, cfg: ArchConfig, x: torch.Tensor,
             positions: torch.Tensor):
    """(q_nope [B,S,H,nope], q_rope [B,S,H,rope], c_kv [B,S,r],
    k_rope [B,S,1,rope]): the query through its low-rank pair, the
    compressed latent and the one decoupled RoPE key head."""
    m = cfg.mla
    q_lat = einsum_f32("bsd,dr->bsr", x, p["wq_a"]).to(x.dtype)
    q_lat = rmsnorm(p["q_a_norm"], q_lat, cfg.norm_eps)
    q = einsum_f32("bsr,rhk->bshk", q_lat, p["wq_b"]).to(x.dtype)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim],
                             dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    kv = einsum_f32("bsd,dr->bsr", x, p["wkv_a"]).to(x.dtype)
    c_kv, k_rope = kv.split([m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    c_kv = rmsnorm(p["kv_a_norm"], c_kv, cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def _mla_attend(p: dict, cfg: ArchConfig, q_nope: torch.Tensor,
                q_rope: torch.Tensor, c_kv: torch.Tensor,
                k_rope: torch.Tensor, *, q_offset=0, flash: bool = False
                ) -> torch.Tensor:
    """Attention in the latent space: the whole of ``c_kv`` expanded to
    per-head k_nope and v through ``wkv_b`` (as the JAX package does, on
    every call), the RoPE key broadcast over heads, scale
    1/sqrt(nope + rope).  Returns [B,S,H,v_head_dim].

    ``flash=True`` (the prefill) sends it through ``kernels.flash_attention``,
    whose contract wants k and v of one shape and scales by 1/sqrt of
    q's head dim: v is zero-padded to the qk head dim (192 for
    deepseek-v3), so the kernel's scale is MLA's and the padded columns
    of its output are zeros, which are sliced away."""
    m, nq = cfg.mla, cfg.n_heads
    kv = einsum_f32("bsr,rhk->bshk", c_kv, p["wkv_b"]).to(c_kv.dtype)
    k_nope, v = kv.split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    b, s = k_rope.shape[:2]
    k = torch.cat([k_nope, k_rope.expand(b, s, nq, m.qk_rope_head_dim)],
                  dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
    if not flash:
        return attention_core(q, k, v, causal=True, q_offset=q_offset,
                              softmax_scale=1.0 / np.sqrt(qk_hd))
    if m.v_head_dim > qk_hd:
        raise ValueError(f"MLA prefill: v head dim {m.v_head_dim} exceeds "
                         f"the qk head dim {qk_hd}; the flash kernel's "
                         f"scale would not be MLA's")
    v = F.pad(v, (0, qk_hd - m.v_head_dim))
    return flash_attention(q, k, v, causal=True)[..., :m.v_head_dim]


def mla_forward(p: dict, cfg: ArchConfig, x: torch.Tensor,
                positions: torch.Tensor, *, training: bool = False
                ) -> torch.Tensor:
    """Full MLA self-attention (train / prefill). Returns [B,S,d].
    ``training=True`` keeps :func:`attention_core`; the inference forward
    goes through the flash kernel with v padded (:func:`_mla_attend`)."""
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, cfg, x, positions)
    out = _mla_attend(p, cfg, q_nope, q_rope, c_kv, k_rope,
                      flash=not training)
    return einsum_f32("bshk,hkd->bsd", out, p["wo"]).to(x.dtype)


def mla_decode(p: dict, cfg: ArchConfig, x: torch.Tensor, cache: dict,
               positions: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """One-token decode against the *compressed* MLA cache, updated in
    place: {"c_kv": [B,S,r], "k_rope": [B,S,1,rope], "index": 0-d int32}.
    The new latent row and RoPE key are cast to the cache dtype and written
    at ``index`` (``index_copy_``, no host sync); attention runs over the
    whole cache, expanded through ``wkv_b``, masked causally at
    ``q_offset=index``; then ``index`` moves by one."""
    q_nope, q_rope, c_new, kr_new = _mla_qkv(p, cfg, x, positions)
    idx = cache["index"]
    slot = idx.reshape(1).long()
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    c_kv.index_copy_(1, slot, c_new.to(c_kv.dtype))
    k_rope.index_copy_(1, slot, kr_new.to(k_rope.dtype))
    out = _mla_attend(p, cfg, q_nope, q_rope, c_kv, k_rope, q_offset=idx)
    y = einsum_f32("bshk,hkd->bsd", out, p["wo"]).to(x.dtype)
    idx.add_(1)
    return y, cache


def mla_cache_init(cfg: ArchConfig, batch: int, seq: int,
                   dtype: torch.dtype, device, lead: Shape = ()) -> dict:
    """Zeroed compressed cache (the JAX package's leaves)."""
    m = cfg.mla
    return {
        "c_kv": torch.zeros((*lead, batch, seq, m.kv_lora_rank),
                            dtype=dtype, device=device),
        "k_rope": torch.zeros((*lead, batch, seq, 1, m.qk_rope_head_dim),
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
