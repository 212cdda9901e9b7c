"""The decoder LM over stacked per-unit parameters (the port of the JAX
package's ``models/lm.py``).

Layers are grouped into *stages* of repeating units as in the JAX package,
and each stage's parameters are stacked along a leading ``[n_units]`` axis
— the same leaf names, shapes and dtypes, so the Kishu store records the
same tensors.  Where the JAX package scans over units, the port runs a
Python loop over ``unbind(0)`` of each stacked leaf (one stacking op in the
backward pass).

What runs: every architecture the JAX package runs.  GQA attention
(standard RoPE, M-RoPE or sinusoidal positions, optional per-head
qk-norm), MLA attention (DeepSeek-V3's compressed latent) and Mamba-2/SSD
layers (``models/mamba.py``), each followed by a SwiGLU MLP, an MoE
feed-forward (``models/moe.py``) or nothing, in any periodic stack the
config describes; the encoder-decoder (a causal encoder over precomputed
frame embeddings, as in the JAX package, and cross-attention in every
decoder layer); precomputed input embeddings (the stubbed frontends);
the MTP block's t+2 logits in training; RMSNorm and the tied or untied
unembed.  Granite 4.0's four scalars (``ArchConfig.embedding_multiplier``,
``attention_multiplier``, ``residual_multiplier``, ``logits_scaling``)
scale the embedding, the softmax, each sublayer's output before its
residual add and the logits; at their neutral values no operation is
added, so every other architecture runs exactly the operations it ran.

Serving: :func:`forward` with ``training=False`` (the default, as in the
JAX package) is the prefill, whose attention goes through the flash
kernel; :func:`init_caches` and :func:`decode_step` run one-token decode
against KV, MLA latent and SSM caches stacked ``[n_units, ...]`` per
stage, exactly as the JAX package's ``vmap`` lays them out, and updated in
place; an enc-dec model's caches carry ``enc_out``, which decode reads and
never writes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core.serialize import torch_dtype
from repro_torch.core.session import resolve_device
from repro_torch.models import layers, mamba
from repro_torch.models import moe as moe_lib
from repro_torch.models.config import ArchConfig
from repro_torch.sharding.context import constrain


# ---------------------------------------------------------------------------
# layer specs and stages
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LayerSpec:
    kind: str          # "attn" | "ssm"
    ffn: str           # "dense" | "moe" | "none"
    cross: bool = False  # decoder cross-attention (enc-dec)


@dataclass(frozen=True)
class StageSpec:
    unit: Tuple[LayerSpec, ...]
    n_units: int


def layer_specs(cfg: ArchConfig, *, decoder: bool = True) -> List[LayerSpec]:
    kinds = cfg.layer_kinds
    specs = []
    for i, kind in enumerate(kinds):
        if cfg.family == "ssm":
            ffn = "none"
        elif cfg.moe is not None and i >= cfg.moe.n_dense_layers and \
                (i % cfg.moe.every_k_layers == cfg.moe.every_k_layers - 1):
            ffn = "moe"
        else:
            ffn = "dense"
        specs.append(LayerSpec(kind, ffn, cross=cfg.enc_dec and decoder))
    return specs


def _min_period(specs: List[LayerSpec]) -> int:
    n = len(specs)
    for u in range(1, n + 1):
        if n % u == 0 and all(specs[i] == specs[i % u] for i in range(n)):
            return u
    return n


def build_stages(cfg: ArchConfig, *, decoder: bool = True) -> List[StageSpec]:
    """Split the layer stack into (prefix) + (periodic) stages."""
    specs = layer_specs(cfg, decoder=decoder)
    prefix = cfg.moe.n_dense_layers if cfg.moe else 0
    stages: List[StageSpec] = []
    if prefix:
        head = specs[:prefix]
        u = _min_period(head)
        stages.append(StageSpec(tuple(head[:u]), len(head) // u))
        specs = specs[prefix:]
    if specs:
        u = _min_period(specs)
        stages.append(StageSpec(tuple(specs[:u]), len(specs) // u))
    return stages


def encoder_stages(cfg: ArchConfig) -> List[StageSpec]:
    n_enc = cfg.n_encoder_layers or cfg.n_layers
    return [StageSpec((LayerSpec("attn", "dense", cross=False),), n_enc)]


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def _init_layer(gen: torch.Generator, cfg: ArchConfig, spec: LayerSpec,
                dtype: torch.dtype, lead=()) -> dict:
    d = cfg.d_model
    p: Dict[str, Any] = {"norm1": layers.rmsnorm_init(d, dtype, gen.device,
                                                      lead)}
    if spec.kind == "attn":
        init = layers.mla_init if cfg.mla is not None else layers.gqa_init
        p["attn"] = init(gen, cfg, dtype, lead)
    else:
        p["ssm"] = mamba.ssm_init(gen, cfg, dtype, lead)
    if spec.cross:
        p["cross_norm"] = layers.rmsnorm_init(d, dtype, gen.device, lead)
        p["cross"] = layers.cross_attn_init(gen, cfg, dtype, lead)
    if spec.ffn == "dense":
        p["norm2"] = layers.rmsnorm_init(d, dtype, gen.device, lead)
        p["mlp"] = layers.mlp_init(gen, d, cfg.d_ff, dtype, lead)
    elif spec.ffn == "moe":
        p["norm2"] = layers.rmsnorm_init(d, dtype, gen.device, lead)
        p["moe"] = moe_lib.moe_init(gen, cfg, dtype, lead)
    return p


def _init_stage(gen: torch.Generator, cfg: ArchConfig, stage: StageSpec,
                dtype: torch.dtype) -> dict:
    return {f"sub_{j}": _init_layer(gen, cfg, spec, dtype,
                                    lead=(stage.n_units,))
            for j, spec in enumerate(stage.unit)}


def init_params(cfg: ArchConfig, gen: torch.Generator,
                dtype: torch.dtype | None = None) -> dict:
    """Parameters drawn from ``gen`` on its device: the JAX package's
    distributions (normal x 0.02 embedding, uniform +-1/sqrt(fan_in)
    products, unit norms), not its values.  Enc-dec models get an
    ``encoder`` (``final_norm``, ``stages``), MTP models an ``mtp`` block
    (``proj [2d, d]``, ``norm``, ``block``: one unstacked dense attention
    layer), as in the JAX package."""
    dtype = dtype or torch_dtype(cfg.dtype)
    d = cfg.d_model
    embed = (torch.empty((cfg.padded_vocab, d), dtype=torch.float32,
                         device=gen.device).normal_(generator=gen)
             * 0.02).to(dtype)
    params: Dict[str, Any] = {
        "embed": embed,
        "final_norm": layers.rmsnorm_init(d, dtype, gen.device),
        "stages": {},
    }
    for i, stage in enumerate(build_stages(cfg)):
        params["stages"][f"stage_{i}"] = _init_stage(gen, cfg, stage, dtype)
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.dense_param(gen, d, cfg.padded_vocab,
                                               dtype)
    if cfg.enc_dec:
        params["encoder"] = {
            "final_norm": layers.rmsnorm_init(d, dtype, gen.device),
            "stages": {f"stage_{i}": _init_stage(gen, cfg, stage, dtype)
                       for i, stage in enumerate(encoder_stages(cfg))}}
    if cfg.mtp:
        params["mtp"] = {
            "proj": layers.dense_param(gen, 2 * d, d, dtype),
            "norm": layers.rmsnorm_init(d, dtype, gen.device),
            "block": _init_layer(gen, cfg, LayerSpec("attn", "dense"),
                                 dtype)}
    # tied-embedding aliasing is realised at the state level (the training
    # state exposes `lm_head` as the same tensor as `embed`); inside the
    # model we read cfg.tie_embeddings.
    return params


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------

def _positions_of(batch: dict, cfg: ArchConfig, seq: int, bsz: int,
                  offset: int = 0, device=None) -> torch.Tensor:
    """[B,S] int32 positions; M-RoPE models take ``batch["positions_thw"]``
    [B,S,3] where given, else the text positions stacked three times."""
    if cfg.rope_type == "mrope" and "positions_thw" in batch:
        return batch["positions_thw"]
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :] \
        + offset
    pos = pos.expand(bsz, seq)
    if cfg.rope_type == "mrope":
        return torch.stack([pos, pos, pos], dim=-1)
    return pos


def _sinusoidal_embed(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal positional embedding (float32). positions [B,S] ->
    [B,S,d]; computed on the positions' device, so a captured decode step
    reads its index from the card."""
    half = d // 2
    inv = torch.exp(torch.arange(half, dtype=torch.float32,
                                 device=positions.device)
                    * -(math.log(10_000.0) / max(half - 1, 1)))
    ang = positions.float()[..., None] * inv
    out = torch.zeros((*positions.shape, d), dtype=torch.float32,
                      device=positions.device)
    out[..., 0::2] = torch.sin(ang)
    out[..., 1::2] = torch.cos(ang)
    return out


def _add_positions(cfg: ArchConfig, x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    """``rope_type="none"``: the sinusoidal embedding added to the token
    embedding in float32; RoPE models take positions in attention."""
    if cfg.rope_type != "none":
        return x
    if isinstance(positions, DTensor):    # replicated: every rank's whole
        positions = positions.to_local()
    return (x.float() + _sinusoidal_embed(positions, x.shape[-1])).to(x.dtype)


def _residual(cfg: ArchConfig, x: torch.Tensor, y: torch.Tensor
              ) -> torch.Tensor:
    """``x + residual_multiplier * y`` (the sublayer output ``y`` scaled in
    its own dtype, as Granite does); ``x + y`` at the neutral 1."""
    m = cfg.residual_multiplier
    return x + y if m == 1 else x + y * m


def _apply_layer(p: dict, cfg: ArchConfig, spec: LayerSpec, x: torch.Tensor,
                 positions: torch.Tensor, *,
                 enc_out: Optional[torch.Tensor] = None,
                 training: bool = False,
                 routes: Optional[List[moe_lib.Route]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence layer: attention (GQA or MLA) or SSM, cross-attention
    over ``enc_out`` in an enc-dec decoder, then the gated MLP or the MoE
    feed-forward, each residual.  Returns (x, the MoE aux loss: a float32
    zero for other layers); ``routes`` collects an MoE layer's routing
    (:func:`moe.moe_forward`)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = layers.rmsnorm(p["norm1"], x, cfg.norm_eps)
    if spec.kind == "attn":
        attn = layers.mla_forward if cfg.mla is not None \
            else layers.gqa_forward
        x = _residual(cfg, x, attn(p["attn"], cfg, h, positions,
                                   training=training))
    else:
        x = _residual(cfg, x, mamba.ssm_forward(p["ssm"], cfg, h))
    if spec.cross:
        h = layers.rmsnorm(p["cross_norm"], x, cfg.norm_eps)
        x = _residual(cfg, x, layers.cross_attn_forward(p["cross"], cfg, h,
                                                        enc_out))
    if spec.ffn == "dense":
        h = layers.rmsnorm(p["norm2"], x, cfg.norm_eps)
        x = _residual(cfg, x, layers.mlp_forward(p["mlp"], h))
    elif spec.ffn == "moe":
        h = layers.rmsnorm(p["norm2"], x, cfg.norm_eps)
        y = moe_lib.moe_forward(p["moe"], cfg, h, routes)
        aux = moe_lib.aux_load_balance_loss(
            p["moe"]["router"], h.reshape(-1, h.shape[-1]), cfg.moe)
        x = _residual(cfg, x, y)
    return x, aux


class _UnbindUnits(torch.autograd.Function):
    """``unbind(0)`` of a stacked DTensor leaf whose backward reduces each
    unit's gradient onto that unit's own placements before stacking them.
    Autograd's own backward stacks the units' gradients as they come, and
    one partial unit makes the whole stacked gradient partial; reduced
    unit by unit, each unit's gradient costs the same collective wherever
    it is, so a step's collectives grow linearly with the units (what the
    dry run's calibration fits)."""

    @staticmethod
    def forward(ctx, x):
        parts = x.unbind(0)
        ctx.unit = (x.device_mesh, tuple(parts[0].placements),
                    parts[0].to_local().shape, x.dtype,
                    parts[0].to_local().device)
        return parts

    @staticmethod
    def backward(ctx, *grads):
        mesh, pl, local, dtype, device = ctx.unit
        return torch.stack([
            DTensor.from_local(torch.zeros(local, dtype=dtype, device=device),
                               mesh, pl, run_check=False)
            if g is None else g.redistribute(mesh, pl) for g in grads])


def _unstack(tree: Any, n: int) -> List[Any]:
    """A tree of stacked leaves -> ``n`` trees of per-unit leaves.  A
    DTensor sharded on the stacked dim (the rules shard a shared expert's
    leading dim as if it were the experts') is replicated on it first; a
    DTensor that takes a gradient is unbound by :class:`_UnbindUnits`."""
    if isinstance(tree, dict):
        subs = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: subs[k][u] for k in tree} for u in range(n)]
    if isinstance(tree, DTensor) and any(
            isinstance(p, Shard) and p.dim == 0 for p in tree.placements):
        tree = tree.redistribute(tree.device_mesh, [
            Replicate() if isinstance(p, Shard) and p.dim == 0 else p
            for p in tree.placements])
    if isinstance(tree, DTensor) and tree.requires_grad \
            and torch.is_grad_enabled():
        parts = _UnbindUnits.apply(tree)
    else:
        parts = tree.unbind(0)
    if len(parts) != n:
        raise ValueError(f"stacked leaf has {len(parts)} units, want {n}")
    return list(parts)


def _run_stages(stages_params: dict, stage_specs: List[StageSpec],
                cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor,
                *, enc_out: Optional[torch.Tensor] = None,
                training: bool = False,
                routes: Optional[List[moe_lib.Route]] = None,
                hidden_sharding=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All stages in order.  Returns (x, the MoE aux loss summed over
    layers).  ``hidden_sharding`` (a ``(mesh, placements)`` layout) is
    applied to the residual stream before the first stage and after each,
    as the JAX package's ``with_sharding_constraint``: a ``redistribute``
    of DTensor activations, nothing for plain tensors."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    x = constrain(x, hidden_sharding)
    for i, stage in enumerate(stage_specs):
        units = _unstack(stages_params[f"stage_{i}"], stage.n_units)
        for unit_params in units:
            for j, spec in enumerate(stage.unit):
                x, aux = _apply_layer(unit_params[f"sub_{j}"], cfg, spec, x,
                                      positions, enc_out=enc_out,
                                      training=training, routes=routes)
                aux_total = aux_total + aux
        x = constrain(x, hidden_sharding)
    return x, aux_total


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

def embed_inputs(cfg: ArchConfig, params: dict, batch: dict) -> torch.Tensor:
    """Token embeddings, or ``batch["embeds"]`` (the stubbed frontends'
    precomputed embeddings) cast to the config's dtype.  DTensor tokens
    give embeddings on their batch placements (``layers.embed_lookup``),
    as precomputed ``embeds`` arrive, so every later op runs on a rank's
    share of the batch.  Either is scaled by ``embedding_multiplier``
    where it is not 1."""
    if "embeds" in batch:
        x = batch["embeds"].to(torch_dtype(cfg.dtype))
    else:
        x = layers.embed_lookup(params["embed"], batch["tokens"])
    m = cfg.embedding_multiplier
    return x if m == 1 else x * m


def forward(cfg: ArchConfig, params: dict, batch: dict, *,
            training: bool = False, return_aux: bool = False,
            routes: Optional[List[moe_lib.Route]] = None,
            hidden_sharding=None):
    """Full-sequence forward. Returns float32 logits [B,S,V] (and an aux
    dict: ``moe_aux``, the MoE load-balance loss summed over layers — a
    float32 zero without MoE layers — and, for an MTP model with
    ``training=True``, ``mtp_logits``, the t+2 logits).  Where ``routes``
    is a list, each MoE layer appends its routing to it
    (:func:`moe.moe_forward`).  An enc-dec model encodes
    ``batch["enc_embeds"]`` first (:func:`encode`).

    ``training=False`` (the prefill) sends attention through the flash
    kernel, which is forward-only; ``training=True`` keeps the plain
    attention that autograd differentiates.  ``hidden_sharding``: see
    :func:`_run_stages`."""
    x = embed_inputs(cfg, params, batch)
    bsz, seq, _ = x.shape
    positions = _positions_of(batch, cfg, seq, bsz, device=x.device)
    x = _add_positions(cfg, x, positions)
    enc_out = encode(cfg, params, batch, training=training) \
        if cfg.enc_dec else None
    x, aux = _run_stages(params["stages"], build_stages(cfg), cfg, x,
                         positions, enc_out=enc_out, training=training,
                         routes=routes, hidden_sharding=hidden_sharding)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = unembed(cfg, params, x)
    if not return_aux:
        return logits
    aux_d = {"moe_aux": aux}
    if cfg.mtp and training:
        aux_d["mtp_logits"] = _mtp_logits(cfg, params, x, batch, positions)
    return logits, aux_d


def encode(cfg: ArchConfig, params: dict, batch: dict, *,
           training: bool = False) -> torch.Tensor:
    """The encoder of an enc-dec model: ``batch["enc_embeds"]`` [B,S_enc,d]
    (precomputed frame embeddings, moved to the parameters' device) plus
    sinusoidal positions, through the encoder stack, then its final norm.
    Returns [B,S_enc,d] in the config's dtype.

    The stack is **causal**, as the JAX package's encoder is
    (``_apply_layer`` keeps its attention's causal default): whisper's
    encoder is bidirectional, but the port is held to the reference's
    logits and stored bytes.  ``training=False`` runs the flash kernel."""
    enc = params["encoder"]
    enc_x = batch["enc_embeds"].to(device=enc["final_norm"]["scale"].device,
                                   dtype=torch_dtype(cfg.dtype))
    bsz, s_enc, d = enc_x.shape
    pos = torch.arange(s_enc, dtype=torch.int32,
                       device=enc_x.device)[None, :].expand(bsz, s_enc)
    enc_x = (enc_x.float() + _sinusoidal_embed(pos, d)).to(enc_x.dtype)
    enc_x, _ = _run_stages(enc["stages"], encoder_stages(cfg), cfg, enc_x,
                           pos, training=training)
    return layers.rmsnorm(enc["final_norm"], enc_x, cfg.norm_eps)


def unembed(cfg: ArchConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Float32 logits, divided by ``logits_scaling`` where it is not 1."""
    if cfg.tie_embeddings or "lm_head" not in params:
        logits = layers.einsum_f32("bsd,vd->bsv", x, params["embed"])
    else:
        logits = layers.einsum_f32("bsd,dv->bsv", x, params["lm_head"])
    s = cfg.logits_scaling
    return logits if s == 1 else logits / s


def _mtp_logits(cfg: ArchConfig, params: dict, h_final: torch.Tensor,
                batch: dict, positions: torch.Tensor) -> torch.Tensor:
    """DeepSeek-V3-style multi-token prediction: one extra dense attention
    block predicts token t+2 from [norm(h_t) ; embed(token_{t+1})].
    ``h_final`` is the final-normed hidden state; the next-token shift
    repeats the last token, as in the JAX package."""
    mtp = params["mtp"]
    tok = batch["tokens"]
    nxt = torch.cat([tok[:, 1:], tok[:, -1:]], dim=1)
    h = torch.cat([layers.rmsnorm(mtp["norm"], h_final, cfg.norm_eps),
                   layers.embed_lookup(params["embed"], nxt)], dim=-1)
    h = layers.einsum_f32("bsk,kd->bsd", h, mtp["proj"]).to(h_final.dtype)
    h, _ = _apply_layer(mtp["block"], cfg, LayerSpec("attn", "dense"), h,
                        positions, training=True)
    return unembed(cfg, params, h)


# ---------------------------------------------------------------------------
# decode (one token against caches)
# ---------------------------------------------------------------------------

def _init_layer_cache(cfg: ArchConfig, spec: LayerSpec, batch: int,
                      seq: int, dtype: torch.dtype, device, lead=()) -> dict:
    if spec.kind == "attn":
        init = layers.mla_cache_init if cfg.mla is not None \
            else layers.gqa_cache_init
        return {"attn": init(cfg, batch, seq, dtype, device, lead)}
    return {"ssm": mamba.ssm_cache_init(cfg, batch, dtype, device, lead)}


def init_caches(cfg: ArchConfig, batch: int, seq: int,
                dtype: torch.dtype | None = None, device=None,
                enc_seq: int = 0) -> dict:
    """Cache tree: per stage, leaves stacked along ``n_units`` (the JAX
    package's names, shapes and dtypes: KV with an int32 ``index`` for GQA
    layers, the compressed ``c_kv`` and ``k_rope`` for MLA layers, ``conv``
    and float32 ``state`` for SSM layers), on ``device`` (``cuda`` unless
    the caller names another).  An enc-dec model's tree also holds
    ``enc_out`` [batch, enc_seq or seq, d_model], zeroed: the caller writes
    :func:`encode`'s output into it."""
    device = resolve_device(device)
    dtype = dtype or torch_dtype(cfg.dtype)
    caches: Dict[str, Any] = {"stages": {
        f"stage_{i}": {f"sub_{j}": _init_layer_cache(
            cfg, spec, batch, seq, dtype, device, lead=(stage.n_units,))
            for j, spec in enumerate(stage.unit)}
        for i, stage in enumerate(build_stages(cfg))}}
    if cfg.enc_dec:
        caches["enc_out"] = torch.zeros((batch, enc_seq or seq, cfg.d_model),
                                        dtype=dtype, device=device)
    return caches


def _decode_layer(p: dict, c: dict, cfg: ArchConfig, spec: LayerSpec,
                  x: torch.Tensor, positions: torch.Tensor,
                  routes: Optional[List[moe_lib.Route]] = None,
                  enc_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One layer of one-token decode; ``c`` (the layer's cache) is updated
    in place; ``enc_out`` is only read."""
    h = layers.rmsnorm(p["norm1"], x, cfg.norm_eps)
    if spec.kind == "attn":
        dec = layers.mla_decode if cfg.mla is not None \
            else layers.gqa_decode
        y, _ = dec(p["attn"], cfg, h, c["attn"], positions)
    else:
        y, _ = mamba.ssm_decode(p["ssm"], cfg, h, c["ssm"])
    x = _residual(cfg, x, y)
    if spec.cross:
        h = layers.rmsnorm(p["cross_norm"], x, cfg.norm_eps)
        x = _residual(cfg, x, layers.cross_attn_forward(p["cross"], cfg, h,
                                                        enc_out))
    if spec.ffn == "dense":
        h = layers.rmsnorm(p["norm2"], x, cfg.norm_eps)
        x = _residual(cfg, x, layers.mlp_forward(p["mlp"], h))
    elif spec.ffn == "moe":
        h = layers.rmsnorm(p["norm2"], x, cfg.norm_eps)
        x = _residual(cfg, x, moe_lib.moe_forward(p["moe"], cfg, h, routes))
    return x


def decode_step(cfg: ArchConfig, params: dict, caches: dict, batch: dict,
                *, routes: Optional[List[moe_lib.Route]] = None
                ) -> Tuple[torch.Tensor, dict]:
    """One-token decode. batch: {"tokens": [B,1] (or "embeds": [B,1,d]),
    "index": the cache fill (an int or a 0-d int tensor)}.  Returns
    (float32 logits [B,1,V], caches): the caches are the same tensors,
    updated in place (an enc-dec model's ``enc_out`` is read, never
    written).  Where ``routes`` is a list, each MoE layer appends its
    routing to it.

    On DTensors (params under ``ShardingRules``, caches under its
    ``cache_spec``; run it under ``train.step.spmd``) the step is one SPMD
    program: the index and positions are replicated DTensors, attention
    and SSM layers decode on their local cache shards
    (``layers.sharded_decode_write``, ``SeqShard.attention``,
    ``mamba._sharded_ssm_decode``), the
    batch-sharded ``enc_out`` is only read (cross-attention recomputes
    its K/V, as the reference does) and MoE routes the batch-sharded
    tokens by the gathered routing (``moe.moe_forward``)."""
    x = embed_inputs(cfg, params, batch)
    bsz = x.shape[0]
    index = batch["index"]
    if isinstance(index, DTensor):
        index = index.to(dtype=torch.int32)
    else:
        # a Python int becomes a device scalar by a fill, not a blocking
        # copy
        index = index.to(device=x.device, dtype=torch.int32) \
            if isinstance(index, torch.Tensor) else \
            torch.full((), int(index), dtype=torch.int32, device=x.device)
        if isinstance(x, DTensor):       # replicated over the SPMD mesh
            mesh = x.device_mesh
            index = DTensor.from_local(index, mesh,
                                       [Replicate()] * mesh.ndim,
                                       run_check=False)
    positions = index.reshape(1, 1).expand(bsz, 1)
    x = _add_positions(cfg, x, positions)
    if cfg.rope_type == "mrope":
        positions = torch.stack([positions, positions, positions], dim=-1)
    enc_out = caches.get("enc_out")
    for i, stage in enumerate(build_stages(cfg)):
        units_p = _unstack(params["stages"][f"stage_{i}"], stage.n_units)
        units_c = _unstack(caches["stages"][f"stage_{i}"], stage.n_units)
        for unit_p, unit_c in zip(units_p, units_c):
            for j, spec in enumerate(stage.unit):
                x = _decode_layer(unit_p[f"sub_{j}"], unit_c[f"sub_{j}"],
                                  cfg, spec, x, positions, routes, enc_out)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(cfg, params, x), caches
