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
- every product accumulates in float32 and gives a float32 result, cast
  back to the activation dtype where the JAX package casts
  (``preferred_element_type=float32``).  :func:`einsum_f32` keeps that
  contract without a float32 copy of a bf16/f16 operand on the card: two
  operands of one half dtype on CUDA go to cuBLAS as they are, through
  ``mm``/``bmm`` with ``out_dtype=float32`` (float32 accumulation and
  result); DTensor operands the same way on their local shards, laid out
  by :func:`label_plan` over the equation's labels.  Its backward splits the float32 cotangent exactly into three bf16 parts, so
  gradients are the upcast path's up to float32 summation order (f16
  operands upcast there).  Everything else — CPU tensors (the oracle; the
  CPU has no ``mm.dtype``), float32 or mixed operands and the
  three-operand SSD equations (``mamba.py``; activations only, no
  weight) — upcasts the operands and runs ``torch.einsum`` in float32.
- decode writes each new cache row at ``min(index, S-1)``, as the JAX
  package's ``dynamic_update_slice`` clamps it; on DTensor caches sharded
  on the sequence (``ShardingRules.cache_spec``) each rank writes its own
  slots and attends over them (:func:`split_attention`: a global max, a
  global sum and the summed P.V, three small all-reduces a layer), so no
  cache moves.
- initialisers draw from a seeded ``torch.Generator`` on the target device.
  ``lead`` prepends the stacked-unit axis: the JAX package vmaps one unit's
  init over ``n_units`` keys, so every per-layer leaf has a leading
  ``[n_units]`` axis, and the port keeps that layout.
"""
from __future__ import annotations

import functools
import itertools
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.models.config import ArchConfig

Shape = Sequence[int]


class EinsumPlan(NamedTuple):
    """A two-operand einsum as one batched matrix product: ``a`` permuted
    to [batch..., m..., k...] and reshaped to [B, M, K], ``b`` to
    [batch..., k..., n...] -> [B, K, N]; the [B, M, N] product reshaped to
    ``c_shape`` ([batch..., m..., n...]) and permuted by ``perm_out`` into
    the equation's output order."""
    perm_a: Tuple[int, ...]
    a3: Tuple[int, int, int]
    perm_b: Tuple[int, ...]
    b3: Tuple[int, int, int]
    c_shape: Tuple[int, ...]
    perm_out: Tuple[int, ...]


@functools.lru_cache(maxsize=None)
def einsum_plan(eq: str, shape_a: Tuple[int, ...], shape_b: Tuple[int, ...]
                ) -> EinsumPlan:
    """The permute/reshape decomposition of ``eq`` (``"ab,bc->ac"`` form,
    two operands, explicit output) for operands of these shapes.  Labels
    in both operands and the output are batch dims, in both operands only
    contracted, in one operand and the output free.  A label in one
    operand only and not in the output, a repeated label, or a size
    mismatch raises ``ValueError``."""
    lhs, out = eq.replace(" ", "").split("->")
    la, lb = lhs.split(",")
    if len(la) != len(shape_a) or len(lb) != len(shape_b):
        raise ValueError(f"{eq}: operand ranks {len(shape_a)}, "
                         f"{len(shape_b)}")
    if len(set(la)) != len(la) or len(set(lb)) != len(lb) \
            or len(set(out)) != len(out):
        raise ValueError(f"{eq}: repeated label")
    size = dict(zip(la, shape_a))
    for c, n in zip(lb, shape_b):
        if size.setdefault(c, n) != n:
            raise ValueError(f"{eq}: label {c} is {size[c]} and {n}")
    batch = [c for c in out if c in la and c in lb]
    m = [c for c in out if c in la and c not in lb]
    n = [c for c in out if c in lb and c not in la]
    k = [c for c in la if c in lb and c not in out]
    if sorted(batch + m + k) != sorted(la) or \
            sorted(batch + n + k) != sorted(lb) or \
            sorted(batch + m + n) != sorted(out):
        raise ValueError(f"{eq}: a label is summed out of one operand")

    def prod(labels):
        return int(np.prod([size[c] for c in labels], dtype=np.int64))

    c_order = batch + m + n
    return EinsumPlan(
        perm_a=tuple(la.index(c) for c in batch + m + k),
        a3=(prod(batch), prod(m), prod(k)),
        perm_b=tuple(lb.index(c) for c in batch + k + n),
        b3=(prod(batch), prod(k), prod(n)),
        c_shape=tuple(size[c] for c in c_order),
        perm_out=tuple(c_order.index(c) for c in out))


def einsum_via(eq: str, a: torch.Tensor, b: torch.Tensor, matmul
               ) -> torch.Tensor:
    """``eq`` on plain ``a``, ``b`` by :func:`einsum_plan` and ``matmul``
    ([B,M,K] x [B,K,N] -> [B,M,N]).  Permutes are views; a reshape copies
    only where the permuted dims cannot merge in place."""
    pl = einsum_plan(eq, tuple(a.shape), tuple(b.shape))
    a3 = a.permute(pl.perm_a).reshape(pl.a3)
    b3 = b.permute(pl.perm_b).reshape(pl.b3)
    return matmul(a3, b3).reshape(pl.c_shape).permute(pl.perm_out)


def _mm_f32(a3: torch.Tensor, b3: torch.Tensor) -> torch.Tensor:
    """[B,M,K] x [B,K,N] half-precision operands -> float32 [B,M,N],
    accumulated in float32 by cuBLAS (``aten::mm.dtype``/``bmm.dtype``)."""
    if a3.shape[0] == 1:
        return torch.mm(a3[0], b3[0], out_dtype=torch.float32)[None]
    return torch.bmm(a3, b3, out_dtype=torch.float32)


def _split_bf16(x: torch.Tensor) -> List[torch.Tensor]:
    """Three bf16 tensors whose float32 sum is float32 ``x`` exactly: each
    takes the next 8 significant bits of what the others leave (24 in
    all)."""
    parts = []
    for _ in range(3):
        parts.append(x.to(torch.bfloat16))
        x = x - parts[-1].float()
    return parts


def _bmm_f32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[B,M,K] x [B,K,N] -> float32, on local (plain) tensors.  Two float32
    operands: ``bmm``.  Two of one half dtype: :func:`_mm_f32`.  A float32
    operand (a cotangent) beside a bf16 one: the float32 one split exactly
    by :func:`_split_bf16`, three :func:`_mm_f32` products summed — the
    float32 product up to summation order, with no float32 copy of the
    bf16 operand.  Anything else (f16 beside float32) upcasts both."""
    if x.dtype == y.dtype == torch.float32:
        return torch.bmm(x, y)
    if x.dtype == y.dtype:
        return _mm_f32(x, y)
    if {x.dtype, y.dtype} == {torch.float32, torch.bfloat16}:
        if x.dtype == torch.float32:
            return sum(_mm_f32(p, y) for p in _split_bf16(x))
        return sum(_mm_f32(x, p) for p in _split_bf16(y))
    return torch.bmm(x.float(), y.float())


class _MMF32(torch.autograd.Function):
    """:func:`_bmm_f32` with a backward (``mm.dtype`` has no derivative).
    Both gradients are products (:func:`_bmm_f32`) of the float32
    cotangent with the other operand — on the card three bf16 products of
    its exact split, the upcast path's float32 products up to summation
    order — each rounded to its operand's dtype as the upcast path's
    ``.float()`` backward rounds it."""

    @staticmethod
    def forward(ctx, a3, b3):
        ctx.save_for_backward(a3, b3)
        return _bmm_f32(a3, b3)

    @staticmethod
    def backward(ctx, g):
        a3, b3 = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = _bmm_f32(g, b3.transpose(1, 2)).to(a3.dtype)
        if ctx.needs_input_grad[1]:
            gb = _bmm_f32(a3.transpose(1, 2), g).to(b3.dtype)
        return ga, gb


def _mm_f32_autograd(a3: torch.Tensor, b3: torch.Tensor) -> torch.Tensor:
    if torch.is_grad_enabled() and (a3.requires_grad or b3.requires_grad):
        return _MMF32.apply(a3, b3)
    return _bmm_f32(a3, b3)


def _half_on_card(ops: Sequence[torch.Tensor]) -> bool:
    dt = ops[0].dtype
    return len(ops) == 2 and dt in (torch.bfloat16, torch.float16) \
        and all(o.dtype == dt and o.is_cuda for o in ops)


class LabelPlan(NamedTuple):
    """An einsum over a device mesh, one choice a mesh dim (``labels``:
    the label it shards, or ``None``): the placements each operand takes
    for the local product (``ins``), the product's (``out``: ``Partial``
    where a contracted label is sharded) and each operand's gradient's
    (``grads``: ``Partial`` where the mesh dim shards a label the operand
    lacks, so that its local gradient sums over only part of it), and the
    product's once reduced (``reduced``: each partial mesh dim
    reduce-scattered onto the output dim an operand had sharded there
    before, such as the batch rows of an activation, where that dim
    divides and the product does not shard it already; else
    all-reduced)."""
    labels: Tuple[Optional[str], ...]
    ins: Tuple[tuple, ...]
    out: tuple
    grads: Tuple[tuple, ...]
    reduced: tuple


def _local_bytes(shape: Shape, itemsize: int, placements, mesh_shape
                 ) -> float:
    n = float(np.prod(shape, dtype=np.float64)) * itemsize
    for p, m in zip(placements, mesh_shape):
        if isinstance(p, Shard):
            n /= m
    return n


def _move_bytes(shape: Shape, itemsize: int, cur, new, mesh_shape) -> float:
    """Bytes a rank receives to take a tensor from placements ``cur`` to
    ``new``: an all-gather, all-to-all or reduce-scatter moves (n-1)/n of
    the larger local shard on each mesh dim of n ranks that changes, an
    all-reduce twice that, a slice of a replicated dim nothing; a dim
    whose mesh dims must nest in another order, the whole tensor."""
    big = max(_local_bytes(shape, itemsize, cur, mesh_shape),
              _local_bytes(shape, itemsize, new, mesh_shape))
    total = 0.0
    for d in range(len(shape)):
        # a dim split by several mesh dims nests them in mesh order: a
        # layout whose order does not extend the other's from the inside
        # is reached only through the whole tensor (DTensor gathers it)
        a = [i for i, p in enumerate(cur) if p == Shard(d)]
        b = [i for i, q in enumerate(new) if q == Shard(d)]
        k = min(len(a), len(b))
        if a[:k] != b[:k]:
            total += float(np.prod(shape, dtype=np.float64)) * itemsize
    for p, q, n in zip(cur, new, mesh_shape):
        if p == q or n == 1 or (p.is_replicate() and isinstance(q, Shard)):
            continue
        frac = (n - 1) / n
        total += (2 * frac if p.is_partial() and q.is_replicate()
                  else frac) * big
    return total


@functools.lru_cache(maxsize=None)
def label_plan(eq: str, shapes: Tuple[Tuple[int, ...], ...],
               placements: Tuple[tuple, ...], mesh_shape: Tuple[int, ...],
               items: Tuple[int, ...]) -> LabelPlan:
    """The :class:`LabelPlan` of ``eq`` (explicit output, no repeated
    label) for operands of these shapes, placements and item sizes on a
    mesh of ``mesh_shape``.  Each mesh dim shards one label in every
    operand that has it — an output label (a batch or a free label) or a
    contracted one, which makes the product partial — or none, where
    every mesh dim sharding a label divides its size, and where the
    largest operand keeps every output label it is sharded on.  Of all
    such
    choices the plan takes the one that moves the fewest bytes: the
    operands' redistribution (:func:`_move_bytes`) plus the all-reduce of
    a partial float32 product; on a tie the one with the smallest local
    product, then the one that changes the fewest placements on mesh
    dims of one rank, then the first in the order (none, the output's
    labels, the contracted labels), so that products feeding one
    elementwise op shard alike.  So a large activation stays where it is
    and a weight moves (training gathers an FSDP weight), a small one
    moves instead (decode all-reduces activations), and on a one-rank
    mesh no placement changes."""
    lhs, out = eq.replace(" ", "").split("->")
    ins = lhs.split(",")
    size = {}
    for labels, shape in zip(ins, shapes):
        size.update(zip(labels, shape))
    order = [None] + list(out) + sorted(set(lhs) - set(out) - {","},
                                        key=lhs.index)
    out_shape = tuple(size[c] for c in out)
    total = float(np.prod(list(size.values()), dtype=np.float64))
    # the largest operand keeps the output labels it is sharded on (an
    # activation its batch rows), so a layout never drifts from op to op
    big = max(range(len(ins)), key=lambda j: (
        np.prod(shapes[j], dtype=np.float64) * items[j], -j))
    keep = {i: ins[big][p.dim] for i, p in enumerate(placements[big])
            if isinstance(p, Shard) and ins[big][p.dim] in out}
    best = None
    for combo in itertools.product(order, repeat=len(mesh_shape)):
        if any(combo[i] != c for i, c in keep.items()):
            continue
        ways = {}
        for c, n in zip(combo, mesh_shape):
            if c is not None:
                ways[c] = ways.get(c, 1) * n
        if any(size[c] % w for c, w in ways.items()):
            continue

        def pl(labels):
            return tuple(Shard(labels.index(c)) if c is not None
                         and c in labels else Replicate() for c in combo)
        pin = tuple(pl(labels) for labels in ins)
        po = tuple(Partial() if c is not None and c not in out else q
                   for c, q in zip(combo, pl(out)))
        done = _reduced(po, ins, placements, out, out_shape, mesh_shape)
        cost = sum(_move_bytes(*args, mesh_shape) for args in
                   zip(shapes, items, placements, pin))
        for q, r, n in zip(po, done, mesh_shape):
            if q.is_partial():
                cost += (1 if isinstance(r, Shard) else 2) * (n - 1) / n \
                    * _local_bytes(out_shape, 4, po, mesh_shape)
        local = total / float(np.prod(list(ways.values()) or [1]))
        changes = sum(p != q and n == 1 for cur, new in zip(placements, pin)
                      for p, q, n in zip(cur, new, mesh_shape))
        key = (cost, local, changes)
        if best is None or key < best[0]:
            best = (key, combo, pin, po, done)
    _, combo, pin, po, done = best
    grads = tuple(tuple(Partial() if c is not None and c not in labels
                        else q for c, q in zip(combo, p))
                  for labels, p in zip(ins, pin))
    return LabelPlan(combo, pin, po, grads, done)


def _reduced(po: tuple, ins: Sequence[str], placements: Tuple[tuple, ...],
             out: str, out_shape: Shape, mesh_shape: Tuple[int, ...]
             ) -> tuple:
    """``LabelPlan.reduced`` of the product's placements ``po``."""
    done, ways = list(po), {}
    for i, q in enumerate(po):
        if not q.is_partial():
            continue
        done[i] = Replicate()
        for labels, pls in zip(ins, placements):
            p = pls[i]
            if isinstance(p, Shard) and labels[p.dim] in out:
                d = out.index(labels[p.dim])
                n = ways.get(d, 1) * mesh_shape[i]
                if out_shape[d] % n == 0 and Shard(d) not in po:
                    done[i], ways[d] = Shard(d), n
                break
    return tuple(done)


def _as_dtensor(x: torch.Tensor, mesh) -> DTensor:
    """A DTensor as it is; a plain tensor as replicated over ``mesh``."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _dt_einsum(eq: str, *ops: torch.Tensor) -> DTensor:
    """:func:`einsum_f32` of operands with a DTensor among them (a plain
    one acts as replicated): each redistributed per tensor dim by
    :func:`label_plan` (a DTensor is never reshaped), the plain route on
    the local shards, the product wrapped on the output labels'
    placements and a partial one reduced in float32 at once
    (``LabelPlan.reduced``), before any cast or nonlinear op.

    Autograd runs through the same layout: the local product's backward
    is the plain route's, on the forward's shards, so each rank computes
    its share of every cotangent product, and each local gradient goes
    back as ``Partial`` where it holds part of a sum
    (``LabelPlan.grads``), reduced (reduce-scatter or all-reduce) onto
    the operand's own placements."""
    mesh = next(o for o in ops if isinstance(o, DTensor)).device_mesh
    ops = [_as_dtensor(o, mesh) for o in ops]
    plan = label_plan(eq, tuple(tuple(o.shape) for o in ops),
                      tuple(tuple(o.placements) for o in ops),
                      tuple(mesh.shape), tuple(o.element_size() for o in ops))
    local = [o.redistribute(mesh, q).to_local(grad_placements=g)
             for o, q, g in zip(ops, plan.ins, plan.grads)]
    out = DTensor.from_local(einsum_f32(eq, *local), mesh, plan.out,
                             run_check=False)
    if plan.reduced != plan.out:
        out = out.redistribute(mesh, plan.reduced)
    return out


def einsum_f32(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``einsum`` with float32 accumulation and a float32 result (the JAX
    package's ``preferred_element_type=jnp.float32``).  Two bf16 (or
    two f16) CUDA operands run as one cuBLAS product of the operands as
    they are, with no float32 copy of either; operands with a DTensor
    among them run the plain route on their local shards
    (:func:`_dt_einsum`); any other call upcasts its operands (see the
    module docstring)."""
    if any(isinstance(o, DTensor) for o in ops):
        return _dt_einsum(eq, *ops)
    if _half_on_card(ops):
        return einsum_via(eq, ops[0], ops[1], _mm_f32_autograd)
    return torch.einsum(eq, *[o.float() for o in ops])


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``: the rows of an embedding table [V,d] for integer
    ids [...] -> [..., d].

    On DTensors the rows keep the ids' placements (the batch stays
    sharded where the tokens are) and are replicated over every other
    mesh dim: the lookup GSPMD's propagation gives the JAX package, which
    sets no sharding constraint there.  Per mesh dim: where the ids are
    sharded the table is gathered whole on that dim, as an FSDP weight is
    (its local gradient is then partial, reduce-scattered back); where
    the table is sharded on the vocab and the ids are not, each rank
    looks up the ids in its own vocab rows, zeros the others, and the
    rows are summed over the dim at once (one rank holds each row, so the
    sum is exact); anything else is gathered.  A plain ``table`` and
    ``ids`` take the plain lookup."""
    if not isinstance(table, DTensor) and not isinstance(ids, DTensor):
        return table[ids.long()]
    from repro_torch.sharding.resharding import local_box
    mesh = (table if isinstance(table, DTensor) else ids).device_mesh
    table, ids = _as_dtensor(table, mesh), _as_dtensor(ids, mesh)
    # per mesh dim: (the table's, the ids', the table's gradient's and
    # the rows' placements)
    plans = [(Replicate(), i, Partial(), i) if isinstance(i, Shard)
             else (t, Replicate(), t, Partial()) if t == Shard(0)
             else (Replicate(),) * 4
             for t, i in zip(table.placements, ids.placements)]
    tq, iq, gq, oq = (list(q) for q in zip(*plans))
    local = table.redistribute(mesh, tq).to_local(grad_placements=gq)
    idx = ids.redistribute(mesh, iq).to_local().long()
    (n, _), (lo, _) = local_box(tuple(table.shape), tuple(mesh.shape),
                                mesh.get_coordinate(), tq)
    if n == table.shape[0]:
        rows = local[idx]
    else:
        j = idx - lo
        inside = (j >= 0) & (j < n)
        rows = local[j.clamp(0, n - 1)].masked_fill(~inside[..., None], 0)
    out = DTensor.from_local(rows, mesh, oq, run_check=False)
    if any(q.is_partial() for q in oq):
        out = out.redistribute(mesh, [Replicate() if q.is_partial() else q
                                      for q in oq])
    return out


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
# decode writes and decode on sharded caches
# ---------------------------------------------------------------------------

def decode_write(bufs: Sequence[torch.Tensor], rows: Sequence[torch.Tensor],
                 index: torch.Tensor) -> None:
    """Write each new row [B,1,...] into its plain cache [B,S,...] in
    place, cast to the cache dtype, at slot ``min(index, S-1)``: the JAX
    package's ``dynamic_update_slice``, which clamps its start so that
    the update fits.  The clamp runs on the device (one launch for all
    ``bufs``), so nothing is read back and a CUDA graph can capture it."""
    slot = index.reshape(1).long().clamp(max=bufs[0].shape[1] - 1)
    for buf, row in zip(bufs, rows):
        buf.index_copy_(1, slot, row.to(buf.dtype))


def split_attention(q: torch.Tensor, ks: Sequence[torch.Tensor],
                    vs: Sequence[torch.Tensor], los: Sequence[int], *,
                    q_offset: torch.Tensor, reduce_max, reduce_sum,
                    softmax_scale: Optional[float] = None) -> torch.Tensor:
    """:func:`attention_core` (``causal=True`` at ``q_offset``) over a
    cache cut along the sequence into pieces ``ks[i]``, ``vs[i]``
    [B,S_i,Hkv,hd] whose first slots are the global positions ``los[i]``.

    ``reduce_max`` and ``reduce_sum`` take a list with one tensor per
    piece of ``ks`` and return their elementwise max and sum over every
    piece of the whole cache: on a sharded cache this rank's one piece
    and an all-reduce over the mesh dims that shard the sequence; in a
    test, the pieces of one plain cache.  The softmax is the reference's:
    logits masked with the finite -1e30 at key positions ``los[i] +
    arange(S_i)``, ``p = exp(s - M) / L`` with the global max ``M`` and
    sum ``L``, cast to v's dtype *before* P.V; the float32 partial
    products are summed by ``reduce_sum`` and cast to q's dtype.  Three
    reductions in all, of [B,H,Sq,1] twice and [B,Sq,H,hd_v] once."""
    sq, hq, hd = q.shape[1], q.shape[2], q.shape[3]
    n_rep = hq // ks[0].shape[2]
    scale = softmax_scale if softmax_scale is not None else 1.0 / np.sqrt(hd)
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    logits = []
    for k, lo in zip(ks, los):
        s = einsum_f32("bqhd,bkhd->bhqk", q, _repeat_kv(k, n_rep)) * scale
        kpos = torch.arange(lo, lo + k.shape[1], device=q.device)[None, :]
        logits.append(s.masked_fill(~(qpos >= kpos)[None, None], -1e30))
    m = reduce_max([s.amax(dim=-1, keepdim=True) for s in logits])
    e = [torch.exp(s - m) for s in logits]
    total = reduce_sum([x.sum(dim=-1, keepdim=True) for x in e])
    parts = [einsum_f32("bhqk,bkhd->bqhd", (x / total).to(v.dtype),
                        _repeat_kv(v, n_rep)) for x, v in zip(e, vs)]
    return reduce_sum(parts).to(q.dtype)


class SeqShard(NamedTuple):
    """This rank's shard of a decode cache leaf [B,S,...] sharded on the
    sequence (and possibly the batch): its mesh, the placements of its
    batch rows with every other dim whole (``rows``), its first global
    slot ``lo`` and its ``n`` slots (DTensor's local box), the mesh dims
    that shard the sequence (``seq_dims``: the reductions run over them,
    a dim of one rank included) and the global batch."""
    mesh: object
    rows: tuple
    lo: int
    n: int
    seq_dims: Tuple[int, ...]
    batch: int

    def reduce(self, op: str):
        """A :func:`split_attention` reduction: this rank's one piece
        all-reduced with ``op`` over ``seq_dims`` (functional
        collectives, which ``CommDebugMode`` counts)."""
        def reduce(xs):
            (x,) = xs
            for i in self.seq_dims:
                x = funcol.all_reduce(x, op, (self.mesh, i))
            return x.wait() if isinstance(x, funcol.AsyncCollectiveTensor) \
                else x
        return reduce

    def attention(self, q, k, v, *, causal: bool, q_offset,
                  softmax_scale: Optional[float] = None) -> torch.Tensor:
        """:func:`attention_core`'s signature (causal decode only) over
        this rank's local K/V shard: :func:`split_attention`."""
        if not causal:
            raise ValueError("the sharded decode attention is causal")
        return split_attention(q, [k], [v], [self.lo], q_offset=q_offset,
                               reduce_max=self.reduce("max"),
                               reduce_sum=self.reduce("sum"),
                               softmax_scale=softmax_scale)

    def wrap(self, out: torch.Tensor) -> DTensor:
        """This rank's rows of a [B,...] result as a DTensor on the
        cache's batch placements."""
        out = out.contiguous()
        shape = (self.batch, *out.shape[1:])
        return DTensor.from_local(out, self.mesh, list(self.rows),
                                  run_check=False, shape=shape,
                                  stride=torch.empty(shape, device="meta")
                                  .stride())


def shard_box(x: DTensor) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(local shape, global offset) of this rank's shard of ``x``."""
    from repro_torch.sharding.resharding import local_box
    mesh = x.device_mesh
    return local_box(tuple(x.shape), tuple(mesh.shape),
                     mesh.get_coordinate(), x.placements)


def seq_shard(buf: DTensor) -> SeqShard:
    """The :class:`SeqShard` of a DTensor cache leaf; a leaf sharded on
    any dim but the batch and the sequence raises."""
    mesh = buf.device_mesh
    bad = [p for p in buf.placements
           if not p.is_replicate() and not (isinstance(p, Shard)
                                            and p.dim in (0, 1))]
    if bad:
        raise ValueError(f"decode cache placements {buf.placements}: only "
                         f"the batch and the sequence may be sharded")
    local, offset = shard_box(buf)
    rows = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in buf.placements)
    seq = tuple(i for i, p in enumerate(buf.placements)
                if isinstance(p, Shard) and p.dim == 1)
    return SeqShard(mesh, rows, int(offset[1]), int(local[1]), seq,
                    int(buf.shape[0]))


def local_rows(x: torch.Tensor, sh: SeqShard) -> torch.Tensor:
    """This rank's batch rows of ``x`` [B,...] with every other dim whole
    (a plain ``x`` acts as replicated), as a plain tensor."""
    return _as_dtensor(x, sh.mesh).redistribute(sh.mesh, sh.rows).to_local()


def whole(x: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole on every rank (a plain tensor); a plain
    tensor as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def sharded_decode_write(bufs: Sequence[DTensor], rows, index
                         ) -> Tuple[SeqShard, List[torch.Tensor],
                                    torch.Tensor]:
    """:func:`decode_write` for DTensor caches ``bufs`` [B,S,...] sharded
    alike on the sequence (and the batch).  Each rank owns slots
    [lo, lo + n) and writes, at ``clamp(g - lo)`` of its local shard, the
    new row (its batch rows, heads whole) where ``g = min(index, S-1)``
    falls in its range and the slot's old value elsewhere: the same
    clamp, on the device, with no host sync.  Returns the shard, the
    local caches and this rank's plain ``index``."""
    sh = seq_shard(bufs[0])
    i = index.to_local() if isinstance(index, DTensor) else index
    g = i.clamp(max=bufs[0].shape[1] - 1) - sh.lo
    inside = (g >= 0) & (g < sh.n)
    slot = g.clamp(0, sh.n - 1).reshape(1).long()
    local = []
    for buf, row in zip(bufs, rows):
        if seq_shard(buf)[2:4] != (sh.lo, sh.n):
            raise ValueError("decode caches of one layer are sharded "
                             "unlike")
        t = buf.to_local()
        new = local_rows(row, sh).to(t.dtype)
        t.index_copy_(1, slot, torch.where(inside, new,
                                           t.index_select(1, slot)))
        local.append(t)
    return sh, local, i


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
    # "none" (sinusoids added to the embeddings) and "nope" rotate nothing
    if cfg.rope_type == "standard":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope_type == "mrope":
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    return q, k, v


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True,
           softmax_scale: Optional[float] = None) -> torch.Tensor:
    """``kernels.flash_attention`` (``softmax_scale`` as there: None is
    1/sqrt(hd)); DTensor q, k, v (a sharded prefill) run
    it on their local shards, each rank with its own batch rows and heads
    (the kernel sees whole sequences).  Each mesh dim keeps q's batch or
    heads where it shards them evenly, else takes the heads, else the
    batch where they divide, else the heads unevenly (some ranks hold one
    head more, some none; one mesh dim only), else nothing (the work is
    replicated there).  Where the heads are sharded more ways than k and
    v have heads, k and v are repeated to q's heads first (the kernel's
    GQA broadcast, done before the split)."""
    if not isinstance(q, DTensor):
        return flash_attention(q, k, v, causal=causal,
                               softmax_scale=softmax_scale)
    mesh = q.device_mesh
    ways = {0: 1, 2: 1}
    uneven = False

    def even(d, n):
        return q.shape[d] % (ways[d] * n) == 0 and (
            d == 2 or all(t.shape[0] % (ways[0] * n) == 0 for t in (k, v)))
    pl = []
    for i, p in enumerate(q.placements):
        n = mesh.size(i)
        keep = p.dim % 4 if type(p) is Shard else None
        d = next((d for d in (keep, 2, 0) if d in ways and even(d, n)),
                 None)
        if d is None and not uneven and ways[2] == 1 and q.shape[2] > 1:
            d, uneven = 2, True
        if d is None:
            pl.append(Replicate())
        else:
            ways[d] *= n
            pl.append(Shard(d))
    if ways[2] > 1 and (uneven or k.shape[2] % ways[2]):
        k, v = (_repeat_kv(t, q.shape[2] // k.shape[2]) for t in (k, v))
    local = [t.redistribute(mesh, pl).to_local() for t in (q, k, v)]
    # meta shards (the dry run) have no kernel: the plain version's shapes
    run = flash_attention_plain if local[0].is_meta else flash_attention
    out = run(*local, causal=causal, softmax_scale=softmax_scale) \
        if local[0].shape[2] else \
        torch.empty_like(local[0])          # a rank with no head
    b, s, h, hd = q.shape
    return DTensor.from_local(out.contiguous(), mesh, pl, run_check=False,
                              shape=(b, s, h, hd),
                              stride=(s * h * hd, h * hd, hd, 1))


def gqa_forward(p: dict, cfg: ArchConfig, x: torch.Tensor,
                positions: torch.Tensor, *, causal: bool = True,
                training: bool = False) -> torch.Tensor:
    """Full self-attention (train / prefill). Returns [B,S,d].

    ``training=True`` keeps :func:`attention_core` (autograd, the JAX
    package's training attention); the inference forward goes through
    ``kernels.flash_attention``: the CUDA kernel on the card, its plain
    version on the CPU.  The two differ at bf16 by one rounding: the kernel
    keeps the probabilities in float32 for P.V.  The softmax scale is
    ``cfg.attn_scale`` (1/sqrt(hd) unless ``attention_multiplier`` sets
    one)."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    if training:
        out = attention_core(q, k, v, causal=causal,
                             softmax_scale=cfg.attn_scale)
    else:
        out = _flash(q, k, v, causal=causal, softmax_scale=cfg.attn_scale)
    return einsum_f32("bshk,hkd->bsd", out, p["wo"]).to(x.dtype)


def gqa_decode(p: dict, cfg: ArchConfig, x: torch.Tensor, cache: dict,
               positions: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """One-token decode against a KV cache, updated in place.

    cache: {"k": [B,S,Hkv,hd], "v": [B,S,Hkv,hd], "index": 0-d int32}
    x: [B,1,d].  The new K/V row is cast to the cache dtype and written at
    ``min(index, S-1)`` (:func:`decode_write`, the JAX package's
    ``dynamic_update_slice`` clamp); attention runs over the whole cache
    with the causal mask at ``q_offset=index`` (unfilled slots masked), in
    plain torch as in the JAX package; then ``index`` moves by one.
    DTensor caches (sharded on the sequence, ``ShardingRules.cache_spec``)
    are written by :func:`sharded_decode_write` and attended by
    ``SeqShard.attention`` on each rank's shard.  Returns (y [B,1,d],
    cache): the same cache tensors, so a Kishu session sees the in-place
    write."""
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    idx = cache["index"]
    k, v = cache["k"], cache["v"]
    if isinstance(k, DTensor):
        sh, (k, v), i = sharded_decode_write([k, v], [k_new, v_new], idx)
        out = sh.wrap(sh.attention(local_rows(q, sh), k, v, causal=True,
                                   q_offset=i, softmax_scale=cfg.attn_scale))
    else:
        decode_write([k, v], [k_new, v_new], idx)
        out = attention_core(q, k, v, causal=True, q_offset=idx,
                             softmax_scale=cfg.attn_scale)
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
                k_rope: torch.Tensor, *, q_offset=0, flash: bool = False,
                core=attention_core) -> torch.Tensor:
    """Attention in the latent space: the whole of ``c_kv`` expanded to
    per-head k_nope and v through ``wkv_b`` (as the JAX package does, on
    every call), the RoPE key broadcast over heads, scale
    1/sqrt(nope + rope).  Returns [B,S,H,v_head_dim].

    ``flash=True`` (the prefill) sends it through ``kernels.flash_attention``,
    whose contract wants k and v of one shape and scales by 1/sqrt of
    q's head dim: v is zero-padded to the qk head dim (192 for
    deepseek-v3), so the kernel's scale is MLA's and the padded columns
    of its output are zeros, which are sliced away.  ``core`` is the
    attention otherwise (``SeqShard.attention`` on a rank's sequence
    shard of the cache)."""
    m, nq = cfg.mla, cfg.n_heads
    kv = einsum_f32("bsr,rhk->bshk", c_kv, p["wkv_b"]).to(c_kv.dtype)
    k_nope, v = kv.split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    b, s = k_rope.shape[:2]
    k = torch.cat([k_nope, k_rope.expand(b, s, nq, m.qk_rope_head_dim)],
                  dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
    if not flash:
        return core(q, k, v, causal=True, q_offset=q_offset,
                    softmax_scale=1.0 / np.sqrt(qk_hd))
    if m.v_head_dim > qk_hd:
        raise ValueError(f"MLA prefill: v head dim {m.v_head_dim} exceeds "
                         f"the qk head dim {qk_hd}; the flash kernel's "
                         f"scale would not be MLA's")
    v = F.pad(v, (0, qk_hd - m.v_head_dim))
    return _flash(q, k, v, causal=True)[..., :m.v_head_dim]


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
    at ``min(index, S-1)`` (:func:`decode_write`, no host sync); attention
    runs over the whole cache, expanded through ``wkv_b``, masked causally
    at ``q_offset=index``; then ``index`` moves by one.  DTensor caches
    are written by :func:`sharded_decode_write`, and each rank expands its
    sequence shard through ``wkv_b`` gathered whole: of the cache
    (sharded on the sequence over ``model``) and ``wkv_b`` (sharded on
    the heads over the same dim) the weight moves, never the cache."""
    q_nope, q_rope, c_new, kr_new = _mla_qkv(p, cfg, x, positions)
    idx = cache["index"]
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    if isinstance(c_kv, DTensor):
        sh, (c_kv, k_rope), i = sharded_decode_write(
            [c_kv, k_rope], [c_new, kr_new], idx)
        out = sh.wrap(_mla_attend(
            {"wkv_b": whole(p["wkv_b"])}, cfg, local_rows(q_nope, sh),
            local_rows(q_rope, sh), c_kv, k_rope, q_offset=i,
            core=sh.attention))
    else:
        decode_write([c_kv, k_rope], [c_new, kr_new], idx)
        out = _mla_attend(p, cfg, q_nope, q_rope, c_kv, k_rope,
                          q_offset=idx)
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
