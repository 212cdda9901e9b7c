"""Plain float32 reference of a Llama-architecture decoder (SmolLM-360M):
RMSNorm, grouped-query attention with half-split RoPE, a SwiGLU MLP,
a final RMSNorm and the tied unembedding.

It reads the benchmark's weights in the parameter layout the port serves
(``stages/stage_0/sub_0/...``, each per-layer leaf stacked on a leading
``[n_layers]`` axis), upcasts one layer at a time, and computes every
product in float32 with TF32 off.  ``quant="fp8"`` computes each product
from operands rounded to float8 e4m3 (one scale a tensor): the control,
a precision below the bfloat16 the configuration serves.

It imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.common import matmul, rmsnorm, tree_get


def layout(m: dict) -> Dict[str, Tuple[Tuple[int, ...], str, tuple]]:
    """name -> (shape, dtype, init) of every parameter leaf, under the
    port's names; ``init`` is read by ``portbench.weights.make``."""
    L, d, hd = m["n_layers"], m["d_model"], m.get("head_dim") \
        or m["d_model"] // m["n_heads"]
    nq, nkv, ff = m["n_heads"], m["n_kv_heads"], m["d_ff"]
    pv = -(-m["vocab_size"] // m["vocab_pad_multiple"]) \
        * m["vocab_pad_multiple"]
    dt = m["dtype"]
    p = "stages/stage_0/sub_0/"
    return {
        "embed": ((pv, d), dt, ("normal", 0.02)),
        "final_norm/scale": ((d,), dt, ("uniform", 0.5, 1.5)),
        p + "norm1/scale": ((L, d), dt, ("uniform", 0.5, 1.5)),
        p + "attn/wq": ((L, d, nq, hd), dt, ("fan_in", d)),
        # K and V at 4x the fan-in scale (values near 2, spanning several
        # binades, as served caches do): at 1x the device codec's probe of
        # the dirty KV rows engaged on some seeds and not on others, and
        # the bytes a commit stores changed with the seed
        p + "attn/wk": ((L, d, nkv, hd), dt, ("fan_in", d // 16)),
        p + "attn/wv": ((L, d, nkv, hd), dt, ("fan_in", d // 16)),
        p + "attn/wo": ((L, nq, hd, d), dt, ("fan_in", nq * hd)),
        p + "norm2/scale": ((L, d), dt, ("uniform", 0.5, 1.5)),
        p + "mlp/w_gate": ((L, d, ff), dt, ("fan_in", d)),
        p + "mlp/w_up": ((L, d, ff), dt, ("fan_in", d)),
        p + "mlp/w_down": ((L, ff, d), dt, ("fan_in", ff)),
    }


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotary embedding of x [B,S,H,hd] at positions [S]."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                        device=x.device) / hd))
    ang = (pos.double()[:, None] * inv[None, :]).float()     # [S, hd/2]
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :,
                                                                None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def logits(m: dict, params: dict, tokens: torch.Tensor, keep: int,
           quant: Optional[str] = None) -> torch.Tensor:
    """Float32 logits [B, keep, vocab] of the last ``keep`` positions of
    ``tokens`` [B, S] under a causal full-sequence forward."""
    L, eps = m["n_layers"], m["norm_eps"]
    nq, nkv = m["n_heads"], m["n_kv_heads"]
    b, s = tokens.shape
    p = "stages/stage_0/sub_0/"
    x = tree_get(params, "embed")[tokens.long()].float()       # [B,S,d]
    pos = torch.arange(s, device=x.device)
    mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    for i in range(L):
        w = {k: tree_get(params, p + k)[i].float() for k in (
            "norm1/scale", "attn/wq", "attn/wk", "attn/wv", "attn/wo",
            "norm2/scale", "mlp/w_gate", "mlp/w_up", "mlp/w_down")}
        hd = w["attn/wq"].shape[-1]
        h = rmsnorm(x, w["norm1/scale"], eps)
        q = matmul(h, w["attn/wq"].flatten(1), quant).view(b, s, nq, hd)
        k = matmul(h, w["attn/wk"].flatten(1), quant).view(b, s, nkv, hd)
        v = matmul(h, w["attn/wv"].flatten(1), quant).view(b, s, nkv, hd)
        q, k = _rope(q, pos, m["rope_theta"]), _rope(k, pos, m["rope_theta"])
        rep = nq // nkv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
        att = matmul(q.transpose(1, 2), k.permute(0, 2, 3, 1), quant) \
            / math.sqrt(hd)                                     # [B,H,S,S]
        att = att.masked_fill(~mask, float("-inf")).softmax(dim=-1)
        o = matmul(att, v.transpose(1, 2), quant)               # [B,H,S,hd]
        o = o.transpose(1, 2).reshape(b, s, nq * hd)
        x = x + matmul(o, w["attn/wo"].reshape(nq * hd, -1), quant)
        h = rmsnorm(x, w["norm2/scale"], eps)
        g = matmul(h, w["mlp/w_gate"], quant)
        u = matmul(h, w["mlp/w_up"], quant)
        x = x + matmul(F.silu(g) * u, w["mlp/w_down"], quant)
    x = rmsnorm(x[:, s - keep:], tree_get(params, "final_norm/scale")
                .float(), eps)
    emb = tree_get(params, "embed")[:m["vocab_size"]].float()
    return matmul(x, emb.t(), quant)
