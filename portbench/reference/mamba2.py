"""Plain float32 reference of a Mamba-2 (SSD) decoder, Mamba-2 780M:
per layer RMSNorm, the input projection into (z, x, B, C, dt), a causal
depthwise convolution with SiLU over (x, B, C), the selective state-space
recurrence run token by token (``h = exp(dt A) h + dt x (x) B``,
``y = C . h + D x``), the gated RMSNorm ``norm(y * silu(z))`` and the
output projection; then a final RMSNorm and the tied unembedding.

As configured in this repository (``rope_type`` "none"), sinusoidal
absolute positions are added to the token embeddings, a departure from
the published model that the program makes and the reference follows.

It reads the benchmark's weights in the port's layout (per-layer leaves
stacked on ``[n_layers]``), upcasts one layer at a time, and computes in
float32 with TF32 off; ``quant="fp8"`` rounds the operands of each
projection and of the unembedding to float8 e4m3 (the control).

It imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.common import matmul, rmsnorm, tree_get


def dims(m: dict) -> Tuple[int, int, int, int]:
    s = m["ssm"]
    d_in = s["expand"] * m["d_model"]
    nh = d_in // s["head_dim"]
    gn = s["n_groups"] * s["d_state"]
    return d_in, nh, gn, 2 * d_in + 2 * gn + nh


def layout(m: dict) -> Dict[str, Tuple[Tuple[int, ...], str, tuple]]:
    """name -> (shape, dtype, init) under the port's names, read by
    ``portbench.weights.make``; ``A_log`` and ``dt_bias`` take the
    published Mamba-2 initialisers (A uniform in [1, 16], dt log-uniform
    in [0.001, 0.1])."""
    L, d, s = m["n_layers"], m["d_model"], m["ssm"]
    d_in, nh, gn, proj = dims(m)
    conv_ch = d_in + 2 * gn
    pv = -(-m["vocab_size"] // m["vocab_pad_multiple"]) \
        * m["vocab_pad_multiple"]
    dt = m["dtype"]
    p = "stages/stage_0/sub_0/"
    return {
        # std 0.5, not 0.02: the added sinusoid (norm sqrt(d/2)) would
        # otherwise drown the tokens, and every sequence decode alike
        "embed": ((pv, d), dt, ("normal", 0.5)),
        "final_norm/scale": ((d,), dt, ("uniform", 0.5, 1.5)),
        p + "norm1/scale": ((L, d), dt, ("uniform", 0.5, 1.5)),
        p + "ssm/in_proj": ((L, d, proj), dt, ("fan_in", d)),
        p + "ssm/conv_w": ((L, s["conv_width"], conv_ch), dt, ("normal", 0.1)),
        p + "ssm/conv_b": ((L, conv_ch), dt, ("normal", 0.1)),
        p + "ssm/dt_bias": ((L, nh), "float32", ("dt_bias", 0.001, 0.1)),
        p + "ssm/A_log": ((L, nh), "float32", ("a_log", 1.0, 16.0)),
        p + "ssm/D": ((L, nh), "float32", ("const", 1.0)),
        p + "ssm/norm/scale": ((L, d_in), dt, ("uniform", 0.5, 1.5)),
        p + "ssm/out_proj": ((L, d_in, d), dt, ("fan_in", d_in)),
    }


def _sinusoid(s: int, d: int, device) -> torch.Tensor:
    half = d // 2
    inv = torch.exp(torch.arange(half, dtype=torch.float32, device=device)
                    * -(math.log(10_000.0) / max(half - 1, 1)))
    ang = torch.arange(s, dtype=torch.float32, device=device)[:, None] * inv
    out = torch.zeros((s, d), dtype=torch.float32, device=device)
    out[:, 0::2] = torch.sin(ang)
    out[:, 1::2] = torch.cos(ang)
    return out


def logits(m: dict, params: dict, tokens: torch.Tensor, keep: int,
           quant: Optional[str] = None) -> torch.Tensor:
    """Float32 logits [B, keep, vocab] of the last ``keep`` positions of
    ``tokens`` [B, S], the recurrence starting from zero state."""
    L, eps, s_cfg = m["n_layers"], m["norm_eps"], m["ssm"]
    d_in, nh, gn, _ = dims(m)
    hp, n, w = s_cfg["head_dim"], s_cfg["d_state"], s_cfg["conv_width"]
    rep = nh // s_cfg["n_groups"]
    b, s = tokens.shape
    p = "stages/stage_0/sub_0/"
    x = tree_get(params, "embed")[tokens.long()].float()
    if m.get("rope_type") == "none":
        x = x + _sinusoid(s, m["d_model"], x.device)
    for i in range(L):
        g = {k: tree_get(params, p + k)[i].float() for k in (
            "norm1/scale", "ssm/in_proj", "ssm/conv_w", "ssm/conv_b",
            "ssm/dt_bias", "ssm/A_log", "ssm/D", "ssm/norm/scale",
            "ssm/out_proj")}
        h = rmsnorm(x, g["norm1/scale"], eps)
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
        dt = F.softplus(dt + g["ssm/dt_bias"])                  # [B,S,H]
        decay = torch.exp(dt * -torch.exp(g["ssm/A_log"]))      # [B,S,H]
        dtx = dt[..., None] * xs                                # [B,S,H,P]
        state = torch.zeros((b, nh, hp, n), dtype=torch.float32,
                            device=x.device)
        ys = []
        for t in range(s):
            state = state * decay[:, t, :, None, None] \
                + dtx[:, t, :, :, None] * bs[:, t, :, None, :]
            ys.append(torch.einsum("bhpn,bhn->bhp", state, cs[:, t]))
        y = torch.stack(ys, dim=1) + xs * g["ssm/D"][:, None]   # [B,S,H,P]
        y = rmsnorm(y.reshape(b, s, d_in) * F.silu(z),
                    g["ssm/norm/scale"], eps)
        x = x + matmul(y, g["ssm/out_proj"], quant)
    x = rmsnorm(x[:, s - keep:], tree_get(params, "final_norm/scale")
                .float(), eps)
    emb = tree_get(params, "embed")[:m["vocab_size"]].float()
    return matmul(x, emb.t(), quant)
