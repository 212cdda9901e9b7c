"""Mixture-of-Experts layer with capacity-based gather/scatter dispatch: the
port of the JAX package's ``models/moe.py``.

Tokens are ranked within their expert by a stable sort and segment offsets
and scattered into an ``[E, capacity, d]`` buffer; the expert products are
batched einsums over the expert axis; results are gathered back and
combined with the router probabilities.  Assignments ranked at or past the
capacity are dropped, as in the JAX package: a stable sort by expert, a
rank within the expert, ``rank >= cap`` dropped, so which assignments drop
depends on the routing alone, never on the order kernels run in.

No step reads a value back to the host (the counts come from
``scatter_add_``, not ``bincount`` or ``nonzero``), so the decode step
stays capturable in a CUDA graph.

Inside ``sharding.context.moe_weight_gather`` the expert weights are
redistributed to the dispatch layout at use time (ZeRO-style gather) and,
with ``moe_dispatch_shard``, the dispatch buffer and the hidden
activations are constrained to expert-sharded layouts, where the JAX
package applies its sharding constraints.  These act on DTensors only:
without the context, or on plain tensors, the layer does exactly what it
does on one device.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.models import layers
from repro_torch.models.config import ArchConfig, MoEConfig
from repro_torch.models.layers import Shape, einsum_f32
from repro_torch.sharding import context as shctx

# one MoE layer's routing: expert ids [B,S,K] int32, kept [B,S,K] bool
Route = Tuple[torch.Tensor, torch.Tensor]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def capacity(n_tokens: int, mcfg: MoEConfig) -> int:
    c = math.ceil(n_tokens * mcfg.top_k / mcfg.n_experts
                  * mcfg.capacity_factor)
    return max(_round_up(c, 8), 8)


def moe_init(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype,
             lead: Shape = ()) -> dict:
    """The JAX package's leaves and distributions; the router is f32."""
    m = cfg.moe
    d_ff = m.d_ff_expert or cfg.d_ff
    d = cfg.d_model
    p = {
        "router": layers.dense_param(gen, d, m.n_experts, torch.float32,
                                     lead),
        "w_gate": layers._dense_init(gen, (m.n_experts, d, d_ff), d, dtype,
                                     lead),
        "w_up": layers._dense_init(gen, (m.n_experts, d, d_ff), d, dtype,
                                   lead),
        "w_down": layers._dense_init(gen, (m.n_experts, d_ff, d), d_ff,
                                     dtype, lead),
    }
    if m.n_shared_experts:
        p["shared"] = layers.mlp_init(gen, d, d_ff * m.n_shared_experts,
                                      dtype, lead)
    return p


def route(router_w: torch.Tensor, x_flat: torch.Tensor, mcfg: MoEConfig
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Router: (probs [T,K] float32, expert ids [T,K] int32)."""
    logits = einsum_f32("td,de->te", x_flat, router_w)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, mcfg.top_k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return top_p, top_e.to(torch.int32)


def dispatch_indices(top_e: torch.Tensor, n_experts: int, cap: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Destination slots of each (token, k) assignment.

    Returns (dest [T*K] int64 in [0, E*cap] — E*cap is the drop slot,
    valid [T*K] bool)."""
    flat_e = top_e.reshape(-1).long()                            # [T*K]
    tk = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)                   # by expert
    sorted_e = flat_e[order]
    counts = torch.zeros((n_experts,), dtype=torch.int64,
                         device=flat_e.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    seg_start = torch.cumsum(counts, dim=0) - counts             # exclusive
    rank_sorted = torch.arange(tk, device=flat_e.device) - seg_start[sorted_e]
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    valid = rank < cap
    dest = torch.where(valid, flat_e * cap + rank,
                       torch.full_like(rank, n_experts * cap))
    return dest, valid


def _replicated(x: torch.Tensor, mesh) -> DTensor:
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def moe_forward(p: dict, cfg: ArchConfig, x: torch.Tensor,
                routes: Optional[List[Route]] = None) -> torch.Tensor:
    """x: [B,S,d] -> [B,S,d].  Where ``routes`` is a list, the layer's
    routing is appended to it: (expert ids [B,S,K] int32, kept [B,S,K]
    bool — False where the assignment was dropped at capacity).

    With DTensor activations the routing and the dispatch indices run on
    the gathered tokens, alike on every rank (their integer ops have no
    sharding rules), the dispatch buffer enters the expert products as a
    replicated DTensor against the sharded expert weights, and the output
    returns to ``x``'s placements."""
    if isinstance(x, DTensor):
        mesh, placements = x.device_mesh, x.placements
        out = _moe(p, cfg, x.full_tensor(), routes, mesh)
        return _replicated(out, mesh).redistribute(mesh, placements)
    return _moe(p, cfg, x, routes, None)


def _moe(p: dict, cfg: ArchConfig, x: torch.Tensor,
         routes: Optional[List[Route]], mesh) -> torch.Tensor:
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    cap = capacity(t, m)

    top_p, top_e = route(layers.whole(p["router"]), xt, m)
    dest, valid = dispatch_indices(top_e, m.n_experts, cap)
    if routes is not None:
        routes.append((top_e.reshape(b, s, m.top_k),
                       valid.reshape(b, s, m.top_k)))

    # scatter tokens into expert buffers (the extra row is the drop slot)
    x_rep = xt[:, None, :].expand(t, m.top_k, d).reshape(t * m.top_k, d)
    buf = torch.zeros((m.n_experts * cap + 1, d), dtype=x.dtype,
                      device=x.device).index_copy_(0, dest, x_rep)
    buf = buf[:-1].reshape(m.n_experts, cap, d)
    if mesh is not None:
        buf = _replicated(buf, mesh)

    # optional ZeRO-style weight gather (sharding/context.py): the expert
    # weights are gathered to the dispatch layout instead of reducing the
    # dispatch-sized product outputs across ranks
    w_gate, w_up, w_down = p["w_gate"], p["w_up"], p["w_down"]
    shs = shctx.get_moe_weight_shardings()
    if shs is not None:
        w_gate = shctx.constrain(w_gate, shs[0])
        w_up = shctx.constrain(w_up, shs[1])
        w_down = shctx.constrain(w_down, shs[2])
        buf = shctx.constrain(buf, shs[3])

    g = einsum_f32("ecd,edf->ecf", buf, w_gate)
    u = einsum_f32("ecd,edf->ecf", buf, w_up)
    h = (F.silu(g) * u).to(x.dtype)
    if shs is not None:
        h = shctx.constrain(h, shs[4])
    y = layers.whole(einsum_f32("ecf,efd->ecd", h, w_down).to(x.dtype))

    y = torch.cat([y.reshape(m.n_experts * cap, d),
                   torch.zeros((1, d), dtype=y.dtype, device=y.device)])
    y_tok = y[dest]                                              # [T*K, d]
    w = top_p.reshape(-1) * valid.float()
    out = (y_tok.float() * w[:, None]).reshape(t, m.top_k, d) \
        .sum(dim=1).to(x.dtype)

    if m.n_shared_experts:
        xs = x if mesh is None else _replicated(x, mesh)
        out = out + layers.whole(
            layers.mlp_forward(p["shared"], xs)).reshape(t, d)
    return out.reshape(b, s, d)


def aux_load_balance_loss(router_w: torch.Tensor, x_flat: torch.Tensor,
                          mcfg: MoEConfig) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss (float32 scalar; over
    the gathered tokens for DTensors, as :func:`moe_forward` routes, and
    then a replicated DTensor)."""
    mesh = x_flat.device_mesh if isinstance(x_flat, DTensor) else None
    x_flat, router_w = layers.whole(x_flat), layers.whole(router_w)
    logits = einsum_f32("td,de->te", x_flat, router_w)
    probs = torch.softmax(logits, dim=-1)
    top1 = probs.argmax(dim=-1)
    frac_tokens = torch.zeros((mcfg.n_experts,), dtype=torch.float32,
                              device=x_flat.device) \
        .index_add_(0, top1, torch.ones_like(top1, dtype=torch.float32)) \
        / x_flat.shape[0]
    frac_probs = probs.mean(dim=0)
    aux = mcfg.n_experts * torch.sum(frac_tokens * frac_probs)
    return aux if mesh is None else _replicated(aux, mesh)
