"""Plain float32 reference of IBM Granite 4.0-H (``granitemoehybrid``):
a hybrid stack of Mamba-2 and attention layers, each followed by a
mixture of SwiGLU experts and a shared SwiGLU expert.

    x = embedding_multiplier * E[t]
    per layer:  x += residual_multiplier * mixer(RMSNorm(x))
                h  = RMSNorm(x)
                x += residual_multiplier * (MoE(h) + shared(h))
    logits = RMSNorm(x) E^T / logits_scaling

The mixer is the layer's kind in the repeating ``hybrid_pattern``:

- ``ssm``: Mamba-2 as ``mamba2.py`` computes it: the input projection
  into (z, x, B, C, dt), the causal depthwise convolution with bias and
  SiLU over (x, B, C), the selective state-space recurrence token by
  token from zero state, the gated RMSNorm ``norm(y * silu(z))`` and the
  output projection.
- ``attn``: causal grouped-query attention with no positional encoding
  (``position_embedding_type: nope``) and softmax scale
  ``attention_multiplier``.

The MoE takes the top ``top_k`` of the router's logits, a softmax over
those, and sums the chosen SwiGLU experts so weighted; no assignment is
dropped (the published model routes dropless).

Departures from the published model, each the program's too: the
weights are random, drawn from the run's seed; the router leaf is float32
where the published one is bfloat16.

It reads the benchmark's weights in the port's layout (one stage whose
unit is the pattern, each per-layer leaf stacked on ``[n_units]`` under
``stages/stage_0/sub_<j>``), upcasts one layer at a time and computes in
float32 with TF32 off; ``quant="fp8"`` rounds the operands of each
projection, router, expert product, attention product and of the
unembedding to float8 e4m3 (the control).

It imports nothing of the program.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.common import matmul, rmsnorm, tree_get
from portbench.reference.mamba2 import dims as ssm_dims

P = "stages/stage_0/"
SSM_KEYS = ("ssm/in_proj", "ssm/conv_w", "ssm/conv_b", "ssm/dt_bias",
            "ssm/A_log", "ssm/D", "ssm/norm/scale", "ssm/out_proj")
ATTN_KEYS = ("attn/wq", "attn/wk", "attn/wv", "attn/wo")
MOE_KEYS = ("moe/router", "moe/w_gate", "moe/w_up", "moe/w_down",
            "moe/shared/w_gate", "moe/shared/w_up", "moe/shared/w_down")
# The embedding's std: x = 12 E[t] enters the residual stream at 12x its
# scale, and the tied unembedding scores each token by E.  At 0.02 the
# input token's own embedding outweighs everything the 80 sublayers add,
# every sequence echoes its fed token and no precision changes a pick;
# at 0.002 the layers' sum decides the pick.
EMBED_STD = 0.002


def layout(m: dict) -> Dict[str, Tuple[Tuple[int, ...], str, tuple]]:
    """name -> (shape, dtype, init) under the port's names, read by
    ``portbench.weights.make``.  Products take the port's uniform
    +-1/sqrt(fan_in); K and V take 4x that scale, as ``llama.py``'s do
    (served K/V span several binades); the Mamba-2 leaves take
    ``mamba2.py``'s initialisers; the router is float32."""
    d, pat = m["d_model"], m["hybrid_pattern"]
    units = m["n_layers"] // len(pat)
    hd, nq, nkv = m["head_dim"], m["n_heads"], m["n_kv_heads"]
    e = m["moe"]
    n_e, ff = e["n_experts"], e["d_ff_expert"]
    ffs = ff * e["n_shared_experts"]
    d_in, nh, gn, proj = ssm_dims(m)
    w = m["ssm"]["conv_width"]
    conv_ch = d_in + 2 * gn
    pv = -(-m["vocab_size"] // m["vocab_pad_multiple"]) \
        * m["vocab_pad_multiple"]
    dt = m["dtype"]
    norm = ("uniform", 0.5, 1.5)
    out = {"embed": ((pv, d), dt, ("normal", EMBED_STD)),
           "final_norm/scale": ((d,), dt, norm)}
    for j, kind in enumerate(pat):
        p = f"{P}sub_{j}/"
        leaves = {"norm1/scale": ((d,), dt, norm),
                  "norm2/scale": ((d,), dt, norm),
                  "moe/router": ((d, n_e), "float32", ("fan_in", d)),
                  "moe/w_gate": ((n_e, d, ff), dt, ("fan_in", d)),
                  "moe/w_up": ((n_e, d, ff), dt, ("fan_in", d)),
                  "moe/w_down": ((n_e, ff, d), dt, ("fan_in", ff)),
                  "moe/shared/w_gate": ((d, ffs), dt, ("fan_in", d)),
                  "moe/shared/w_up": ((d, ffs), dt, ("fan_in", d)),
                  "moe/shared/w_down": ((ffs, d), dt, ("fan_in", ffs))}
        if kind == "attn":
            leaves.update({
                "attn/wq": ((d, nq, hd), dt, ("fan_in", d)),
                "attn/wk": ((d, nkv, hd), dt, ("fan_in", d // 16)),
                "attn/wv": ((d, nkv, hd), dt, ("fan_in", d // 16)),
                "attn/wo": ((nq, hd, d), dt, ("fan_in", nq * hd))})
        else:
            leaves.update({
                "ssm/in_proj": ((d, proj), dt, ("fan_in", d)),
                "ssm/conv_w": ((w, conv_ch), dt, ("normal", 0.1)),
                "ssm/conv_b": ((conv_ch,), dt, ("normal", 0.1)),
                "ssm/dt_bias": ((nh,), "float32", ("dt_bias", 0.001, 0.1)),
                "ssm/A_log": ((nh,), "float32", ("a_log", 1.0, 16.0)),
                "ssm/D": ((nh,), "float32", ("const", 1.0)),
                "ssm/norm/scale": ((d_in,), dt, norm),
                "ssm/out_proj": ((d_in, d), dt, ("fan_in", d_in))})
        for k, (shape, dtype, init) in leaves.items():
            out[p + k] = ((units, *shape), dtype, init)
    return out


def _ssm(m: dict, g: dict, h: torch.Tensor, quant) -> torch.Tensor:
    """Mamba-2 over h [B,S,d] from zero state, token by token."""
    eps, s_cfg = m["norm_eps"], m["ssm"]
    d_in, nh, gn, _ = ssm_dims(m)
    hp, n, w = s_cfg["head_dim"], s_cfg["d_state"], s_cfg["conv_width"]
    rep = nh // s_cfg["n_groups"]
    b, s, _ = h.shape
    z, xbc, dt = torch.split(matmul(h, g["ssm/in_proj"], quant),
                             [d_in, d_in + 2 * gn, nh], dim=-1)
    pad = F.pad(xbc, (0, 0, w - 1, 0))
    conv = sum(pad[:, j:j + s] * g["ssm/conv_w"][j] for j in range(w))
    xs, bs, cs = torch.split(F.silu(conv + g["ssm/conv_b"]),
                             [d_in, gn, gn], dim=-1)
    xs = xs.reshape(b, s, nh, hp)
    bs = bs.reshape(b, s, -1, 1, n).expand(-1, -1, -1, rep, -1) \
        .reshape(b, s, nh, n)
    cs = cs.reshape(b, s, -1, 1, n).expand(-1, -1, -1, rep, -1) \
        .reshape(b, s, nh, n)
    dt = F.softplus(dt + g["ssm/dt_bias"])                      # [B,S,H]
    decay = torch.exp(dt * -torch.exp(g["ssm/A_log"]))
    dtx = dt[..., None] * xs                                    # [B,S,H,P]
    state = torch.zeros((b, nh, hp, n), dtype=torch.float32,
                        device=h.device)
    ys = []
    for t in range(s):
        state = state * decay[:, t, :, None, None] \
            + dtx[:, t, :, :, None] * bs[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", state, cs[:, t]))
    y = torch.stack(ys, dim=1) + xs * g["ssm/D"][:, None]
    y = rmsnorm(y.reshape(b, s, d_in) * F.silu(z), g["ssm/norm/scale"], eps)
    return matmul(y, g["ssm/out_proj"], quant)


def _attn(m: dict, g: dict, h: torch.Tensor, quant) -> torch.Tensor:
    """Causal GQA over h [B,S,d], no positions, scale
    ``attention_multiplier``."""
    nq, nkv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    b, s, _ = h.shape
    q = matmul(h, g["attn/wq"].flatten(1), quant).view(b, s, nq, hd)
    k = matmul(h, g["attn/wk"].flatten(1), quant).view(b, s, nkv, hd)
    v = matmul(h, g["attn/wv"].flatten(1), quant).view(b, s, nkv, hd)
    k = k.repeat_interleave(nq // nkv, dim=2)
    v = v.repeat_interleave(nq // nkv, dim=2)
    att = matmul(q.transpose(1, 2), k.permute(0, 2, 3, 1), quant) \
        * m["attention_multiplier"]                             # [B,H,S,S]
    mask = torch.ones((s, s), dtype=torch.bool, device=h.device).tril()
    att = att.masked_fill(~mask, float("-inf")).softmax(dim=-1)
    o = matmul(att, v.transpose(1, 2), quant).transpose(1, 2)   # [B,S,H,hd]
    return matmul(o.reshape(b, s, nq * hd), g["attn/wo"].reshape(nq * hd, -1),
                  quant)


def _swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
            wd: torch.Tensor, quant) -> torch.Tensor:
    return matmul(F.silu(matmul(x, wg, quant)) * matmul(x, wu, quant), wd,
                  quant)


def _moe(m: dict, g: dict, h: torch.Tensor, quant) -> torch.Tensor:
    """The routed experts plus the shared expert over h [B,S,d]."""
    k = m["moe"]["top_k"]
    hf = h.reshape(-1, h.shape[-1])
    top_l, top_e = matmul(hf, g["moe/router"], quant).topk(k, dim=-1)
    weight = top_l.softmax(dim=-1)                              # [T,K]
    out = _swiglu(hf, g["moe/shared/w_gate"], g["moe/shared/w_up"],
                  g["moe/shared/w_down"], quant)
    for e in range(g["moe/w_gate"].shape[0]):
        rows, slot = (top_e == e).nonzero(as_tuple=True)
        if rows.numel():
            y = _swiglu(hf[rows], g["moe/w_gate"][e], g["moe/w_up"][e],
                        g["moe/w_down"][e], quant)
            out.index_add_(0, rows, y * weight[rows, slot, None])
    return out.view(h.shape)


def logits(m: dict, params: dict, tokens: torch.Tensor, keep: int,
           quant: Optional[str] = None) -> torch.Tensor:
    """Float32 logits [B, keep, vocab] of the last ``keep`` positions of
    ``tokens`` [B, S] under a causal full-sequence forward."""
    eps, pat = m["norm_eps"], m["hybrid_pattern"]
    r = m["residual_multiplier"]
    s = tokens.shape[1]
    x = tree_get(params, "embed")[tokens.long()].float() \
        * m["embedding_multiplier"]
    for i in range(m["n_layers"]):
        u, j = divmod(i, len(pat))
        mixer = ATTN_KEYS if pat[j] == "attn" else SSM_KEYS
        g = {key: tree_get(params, f"{P}sub_{j}/{key}")[u].float()
             for key in ("norm1/scale", "norm2/scale") + mixer + MOE_KEYS}
        h = rmsnorm(x, g["norm1/scale"], eps)
        y = _attn(m, g, h, quant) if pat[j] == "attn" \
            else _ssm(m, g, h, quant)
        x = x + r * y
        x = x + r * _moe(m, g, rmsnorm(x, g["norm2/scale"], eps), quant)
    x = rmsnorm(x[:, s - keep:], tree_get(params, "final_norm/scale")
                .float(), eps)
    emb = tree_get(params, "embed")[:m["vocab_size"]].float()
    return matmul(x, emb.t(), quant) / m["logits_scaling"]
