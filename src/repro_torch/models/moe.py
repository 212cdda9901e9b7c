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

On DTensor activations (:func:`_moe_sharded`) each rank computes its
share: the routing is the global one, gathered from each rank's rows,
the dispatch buffer is assembled from each rank's own tokens onto the
experts' mesh dims, the expert products run on the DTensor einsum's
plan, and each rank combines its own slots.  Inside
``sharding.context.moe_weight_gather`` the expert weights are
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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

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


def _top_k(probs: torch.Tensor, mcfg: MoEConfig
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(top-k probabilities renormalised to sum 1, float32; their expert
    ids, int32) of router probabilities [T,E]."""
    top_p, top_e = torch.topk(probs, mcfg.top_k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return top_p, top_e.to(torch.int32)


def route(router_w: torch.Tensor, x_flat: torch.Tensor, mcfg: MoEConfig
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Router: (probs [T,K] float32, expert ids [T,K] int32)."""
    logits = einsum_f32("td,de->te", x_flat, router_w)
    return _top_k(torch.softmax(logits, dim=-1), mcfg)


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


def _scatter(xt: torch.Tensor, dest: torch.Tensor, mcfg: MoEConfig,
             cap: int) -> torch.Tensor:
    """Tokens xt [T,d] into the [E, cap, d] dispatch buffer at their
    assignments' slots ``dest`` [T*K] (the extra row is the drop slot);
    unfilled slots are zero."""
    t, d = xt.shape
    x_rep = xt[:, None, :].expand(t, mcfg.top_k, d).reshape(t * mcfg.top_k, d)
    buf = torch.zeros((mcfg.n_experts * cap + 1, d), dtype=xt.dtype,
                      device=xt.device).index_copy_(0, dest, x_rep)
    return buf[:-1].reshape(mcfg.n_experts, cap, d)


def _experts(p: dict, buf: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The expert products of the dispatch buffer [E, cap, d] -> [E, cap,
    d].  Inside ``sharding.context.moe_weight_gather`` the expert weights
    are gathered to the dispatch layout (ZeRO-style) instead of reducing
    the dispatch-sized product outputs across ranks, and the buffer and
    the hidden activations are constrained where the context says."""
    w_gate, w_up, w_down = p["w_gate"], p["w_up"], p["w_down"]
    shs = shctx.get_moe_weight_shardings()
    if shs is not None:
        w_gate = shctx.constrain(w_gate, shs[0])
        w_up = shctx.constrain(w_up, shs[1])
        w_down = shctx.constrain(w_down, shs[2])
        buf = shctx.constrain(buf, shs[3])
    g = einsum_f32("ecd,edf->ecf", buf, w_gate)
    u = einsum_f32("ecd,edf->ecf", buf, w_up)
    h = (F.silu(g) * u).to(dtype)
    if shs is not None:
        h = shctx.constrain(h, shs[4])
    return einsum_f32("ecf,efd->ecd", h, w_down).to(dtype)


def _combine(y: torch.Tensor, slot: torch.Tensor, w: torch.Tensor, k: int
             ) -> torch.Tensor:
    """Float32 [T, d] outputs: each token's k expert rows ``y[slot]``
    ([n, d]; ``slot`` [T*k], ``n`` the zero drop row) weighted by ``w``
    [T*k] and summed in float32."""
    d = y.shape[-1]
    y = torch.cat([y, torch.zeros((1, d), dtype=y.dtype, device=y.device)])
    return (y[slot].float() * w[:, None]).reshape(-1, k, d).sum(dim=1)


def moe_forward(p: dict, cfg: ArchConfig, x: torch.Tensor,
                routes: Optional[List[Route]] = None) -> torch.Tensor:
    """x: [B,S,d] -> [B,S,d].  Where ``routes`` is a list, the layer's
    routing is appended to it: (expert ids [B,S,K] int32, kept [B,S,K]
    bool — False where the assignment was dropped at capacity).  DTensor
    activations take :func:`_moe_sharded`."""
    if isinstance(x, DTensor):
        return _moe_sharded(p, cfg, x, routes)
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    cap = capacity(t, m)
    top_p, top_e = route(p["router"], xt, m)
    dest, valid = dispatch_indices(top_e, m.n_experts, cap)
    if routes is not None:
        routes.append((top_e.reshape(b, s, m.top_k),
                       valid.reshape(b, s, m.top_k)))
    y = _experts(p, _scatter(xt, dest, m, cap), x.dtype)
    out = _combine(y.reshape(m.n_experts * cap, d), dest,
                   top_p.reshape(-1) * valid.float(), m.top_k).to(x.dtype)
    if m.n_shared_experts:
        out = out + layers.mlp_forward(p["shared"], x).reshape(t, d)
    return out.reshape(b, s, d)


def _moe_sharded(p: dict, cfg: ArchConfig, x: DTensor,
                 routes: Optional[List[Route]]) -> DTensor:
    """:func:`moe_forward` on DTensor activations, each rank computing its
    share.  The routing must be the global one (the capacity and the drop
    order follow the global token order), so:

    - the router product runs on the batch-sharded tokens (the DTensor
      einsum), each rank takes the top-k of its own rows, and the [T,K]
      choices are gathered: the dispatch indices are then computed alike
      on every rank (integer ops, no FLOPs);
    - each rank scatters only its own tokens into the [E, cap, d] buffer,
      zeros elsewhere, so the buffer is ``Partial`` over the batch's mesh
      dims (each slot holds one token, so the sum is exact), reduced onto
      the dispatch layout: the expert dim where the weights shard it
      (:func:`_dispatch_layout`);
    - the expert products run on the DTensor einsum's plan;
    - each rank combines its own slots of the result into float32 rows
      for every token, ``Partial`` over the mesh dims that shard the
      experts or the capacity, reduce-scattered onto the batch in float32
      and then cast, as the plain layer sums in float32 and casts;
    - the shared expert runs on the batch-sharded tokens.

    The top-k weights' gradient is partial where the combine's is
    (``full_tensor(grad_placements=...)``)."""
    m = cfg.moe
    mesh = x.device_mesh
    b, s, d = x.shape
    t = b * s
    cap = capacity(t, m)
    rows = [q if isinstance(q, Shard) and q.dim == 0 else Replicate()
            for q in x.placements]
    xr = x.redistribute(mesh, rows)
    xf = xr.reshape(t, d)

    logits = einsum_f32("td,de->te", xf, p["router"])
    logits = logits.redistribute(mesh, [
        q if isinstance(q, Shard) and q.dim == 0 else Replicate()
        for q in logits.placements])
    probs = torch.softmax(logits, dim=-1)
    lp, le = _top_k(probs.to_local(), m)
    top_p = DTensor.from_local(lp, mesh, probs.placements, run_check=False)
    top_e = DTensor.from_local(le, mesh, probs.placements,
                               run_check=False).full_tensor()
    dest, valid = dispatch_indices(top_e, m.n_experts, cap)
    if routes is not None:
        routes.append((top_e.reshape(b, s, m.top_k),
                       valid.reshape(b, s, m.top_k)))

    (bl, _, _), (b0, _, _) = layers.shard_box(xr)
    mine = dest.reshape(t, m.top_k)[b0 * s:(b0 + bl) * s].reshape(-1)
    buf = _scatter(xr.to_local().reshape(bl * s, d), mine, m, cap)
    part = [Partial() if isinstance(q, Shard) else Replicate() for q in rows]
    buf = DTensor.from_local(buf, mesh, part, run_check=False)
    buf = buf.redistribute(mesh, _dispatch_layout(
        layers._as_dtensor(p["w_gate"], mesh), part, m, cap))
    y = _experts(p, buf, x.dtype)

    (el, cl, dl), (e0, c0, _) = layers.shard_box(y)
    e, c = dest // cap, dest % cap
    ours = valid & (e >= e0) & (e < e0 + el) & (c >= c0) & (c < c0 + cl)
    slot = torch.where(ours, (e - e0) * cl + (c - c0),
                       torch.full_like(dest, el * cl))
    w = top_p.full_tensor(grad_placements=[
        Partial() if isinstance(q, Shard) else Replicate()
        for q in y.placements]).reshape(-1) * ours.float()
    out = _combine(y.to_local().reshape(el * cl, dl), slot, w, m.top_k)
    out = DTensor.from_local(out, mesh, [
        Partial() if isinstance(q, Shard) and q.dim < 2
        else Shard(1) if isinstance(q, Shard) else Replicate()
        for q in y.placements], run_check=False)
    out = out.redistribute(mesh, rows).to(x.dtype)
    if m.n_shared_experts:
        out = out + layers.mlp_forward(p["shared"], xr).reshape(t, d)
    return out.reshape(b, s, d).redistribute(mesh, x.placements)


def _dispatch_layout(w_gate: DTensor, part: List, mcfg: MoEConfig,
                     cap: int) -> List:
    """The dispatch buffer's placements, from its partial ones ``part``:
    the experts on each mesh dim that shards the expert weights' expert
    dim; the capacity on each other mesh dim where the buffer is partial
    (a reduce-scatter, not an all-reduce); replicated elsewhere (the
    expert products' plan then picks what to shard).  Each only where it
    divides."""
    out, ways = [], [1, 1]
    for i, (q, r) in enumerate(zip(w_gate.placements, part)):
        dim = 0 if q == Shard(0) else 1 if r.is_partial() else None
        n = w_gate.device_mesh.size(i)
        if dim is not None and (mcfg.n_experts, cap)[dim] % (ways[dim] * n) \
                == 0:
            ways[dim] *= n
            out.append(Shard(dim))
        else:
            out.append(Replicate())
    return out


def aux_load_balance_loss(router_w: torch.Tensor, x_flat: torch.Tensor,
                          mcfg: MoEConfig) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss (float32 scalar).  On a
    DTensor ``x_flat`` the router product and the softmax run on the
    sharded tokens; the top-1 counts and the mean probabilities are
    reduced over the ranks, and the loss is a replicated DTensor."""
    logits = einsum_f32("td,de->te", x_flat, router_w)
    n = x_flat.shape[0]
    if not isinstance(logits, DTensor):
        probs = torch.softmax(logits, dim=-1)
        top1 = probs.argmax(dim=-1)
        frac_tokens = torch.zeros((mcfg.n_experts,), dtype=torch.float32,
                                  device=x_flat.device) \
            .index_add_(0, top1, torch.ones_like(top1, dtype=torch.float32)) \
            / n
        return mcfg.n_experts * torch.sum(frac_tokens * probs.mean(dim=0))
    mesh = logits.device_mesh
    probs = torch.softmax(logits.redistribute(mesh, [
        q if isinstance(q, Shard) and q.dim == 0 else Replicate()
        for q in logits.placements]), dim=-1)
    local = probs.to_local().detach()
    top1 = local.argmax(dim=-1)
    counts = torch.zeros((mcfg.n_experts,), dtype=torch.float32,
                         device=local.device) \
        .index_add_(0, top1, torch.ones_like(top1, dtype=torch.float32))
    counts = DTensor.from_local(counts, mesh, [
        Partial() if isinstance(q, Shard) else Replicate()
        for q in probs.placements], run_check=False).full_tensor()
    aux = mcfg.n_experts * torch.sum(
        counts / n * probs.mean(dim=0).full_tensor())
    return layers._as_dtensor(aux, mesh)
