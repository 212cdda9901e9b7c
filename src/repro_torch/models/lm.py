"""The decoder LM over stacked per-unit parameters (the port of the JAX
package's ``models/lm.py``).

Layers are grouped into *stages* of repeating units as in the JAX package,
and each stage's parameters are stacked along a leading ``[n_units]`` axis
— the same leaf names, shapes and dtypes, so the Kishu store records the
same tensors.  Where the JAX package scans over units, the port runs a
Python loop over ``unbind(0)`` of each stacked leaf (one stacking op in the
backward pass).

What runs: GQA attention (standard RoPE, optional per-head qk-norm) and
Mamba-2/SSD layers (``models/mamba.py``), each followed by a SwiGLU MLP, an
MoE feed-forward (``models/moe.py``) or nothing, in any periodic stack the
config describes (dense, ``ssm``, ``moe`` and ``hybrid`` families), with
RoPE or sinusoidal positions (``rope_type="none"``), RMSNorm and the tied
or untied unembed.  MLA, enc-dec, M-RoPE, frontends and MTP raise
``NotImplementedError``.

Serving: :func:`forward` with ``training=False`` (the default, as in the
JAX package) is the prefill, whose attention goes through the flash
kernel; :func:`init_caches` and :func:`decode_step` run one-token decode
against KV and SSM caches stacked ``[n_units, ...]`` per stage, exactly as
the JAX package's ``vmap`` lays them out, and updated in place.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.serialize import torch_dtype
from repro_torch.core.session import resolve_device
from repro_torch.models import layers, mamba
from repro_torch.models import moe as moe_lib
from repro_torch.models.config import ArchConfig


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


def check_supported(cfg: ArchConfig) -> None:
    """Raise for any feature of ``cfg`` the port does not run yet."""
    for present, what in (
            (cfg.mla is not None, "MLA attention"),
            (cfg.enc_dec, "enc-dec / cross-attention"),
            (cfg.rope_type not in ("standard", "none"),
             f"rope_type={cfg.rope_type!r} (M-RoPE)"),
            (cfg.frontend is not None, f"the {cfg.frontend} frontend"),
            (cfg.mtp, "multi-token prediction")):
        if present:
            raise layers.not_ported(f"{cfg.name}: {what}")


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def _init_layer(gen: torch.Generator, cfg: ArchConfig, spec: LayerSpec,
                dtype: torch.dtype, lead=()) -> dict:
    d = cfg.d_model
    p: Dict[str, Any] = {"norm1": layers.rmsnorm_init(d, dtype, gen.device,
                                                      lead)}
    if spec.kind == "attn":
        p["attn"] = layers.gqa_init(gen, cfg, dtype, lead)
    else:
        p["ssm"] = mamba.ssm_init(gen, cfg, dtype, lead)
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
    products, unit norms), not its values."""
    check_supported(cfg)
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
    # tied-embedding aliasing is realised at the state level (the training
    # state exposes `lm_head` as the same tensor as `embed`); inside the
    # model we read cfg.tie_embeddings.
    return params


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------

def _positions_of(batch: dict, cfg: ArchConfig, seq: int, bsz: int,
                  offset: int = 0, device=None) -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :] \
        + offset
    return pos.expand(bsz, seq)


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
    return (x.float() + _sinusoidal_embed(positions, x.shape[-1])).to(x.dtype)


def _apply_layer(p: dict, cfg: ArchConfig, spec: LayerSpec, x: torch.Tensor,
                 positions: torch.Tensor, *, training: bool = False,
                 routes: Optional[List[moe_lib.Route]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence layer: attention or SSM, then the gated MLP or the MoE
    feed-forward, each residual.  Returns (x, the MoE aux loss: a float32
    zero for other layers); ``routes`` collects an MoE layer's routing
    (:func:`moe.moe_forward`)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = layers.rmsnorm(p["norm1"], x, cfg.norm_eps)
    if spec.kind == "attn":
        x = x + layers.gqa_forward(p["attn"], cfg, h, positions,
                                   training=training)
    else:
        x = x + mamba.ssm_forward(p["ssm"], cfg, h)
    if spec.ffn == "dense":
        h = layers.rmsnorm(p["norm2"], x, cfg.norm_eps)
        x = x + layers.mlp_forward(p["mlp"], h)
    elif spec.ffn == "moe":
        h = layers.rmsnorm(p["norm2"], x, cfg.norm_eps)
        y = moe_lib.moe_forward(p["moe"], cfg, h, routes)
        aux = moe_lib.aux_load_balance_loss(
            p["moe"]["router"], h.reshape(-1, h.shape[-1]), cfg.moe)
        x = x + y
    return x, aux


def _unstack(tree: Any, n: int) -> List[Any]:
    """A tree of stacked leaves -> ``n`` trees of per-unit leaves."""
    if isinstance(tree, dict):
        subs = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: subs[k][u] for k in tree} for u in range(n)]
    parts = tree.unbind(0)
    if len(parts) != n:
        raise ValueError(f"stacked leaf has {len(parts)} units, want {n}")
    return list(parts)


def _run_stages(stages_params: dict, stage_specs: List[StageSpec],
                cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor,
                *, training: bool = False,
                routes: Optional[List[moe_lib.Route]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All stages in order.  Returns (x, the MoE aux loss summed over
    layers)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, stage in enumerate(stage_specs):
        units = _unstack(stages_params[f"stage_{i}"], stage.n_units)
        for unit_params in units:
            for j, spec in enumerate(stage.unit):
                x, aux = _apply_layer(unit_params[f"sub_{j}"], cfg, spec, x,
                                      positions, training=training,
                                      routes=routes)
                aux_total = aux_total + aux
    return x, aux_total


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

def embed_inputs(cfg: ArchConfig, params: dict, batch: dict) -> torch.Tensor:
    if "embeds" in batch:
        raise layers.not_ported("precomputed input embeddings (frontends)")
    return params["embed"][batch["tokens"].long()]


def forward(cfg: ArchConfig, params: dict, batch: dict, *,
            training: bool = False, return_aux: bool = False,
            routes: Optional[List[moe_lib.Route]] = None):
    """Full-sequence forward. Returns float32 logits [B,S,V] (and an aux
    dict: ``moe_aux``, the MoE load-balance loss summed over layers — a
    float32 zero without MoE layers).  Where ``routes`` is a list, each
    MoE layer appends its routing to it (:func:`moe.moe_forward`).

    ``training=False`` (the prefill) sends attention through the flash
    kernel, which is forward-only; ``training=True`` keeps the plain
    attention that autograd differentiates."""
    check_supported(cfg)
    x = embed_inputs(cfg, params, batch)
    bsz, seq, _ = x.shape
    positions = _positions_of(batch, cfg, seq, bsz, device=x.device)
    x = _add_positions(cfg, x, positions)
    x, aux = _run_stages(params["stages"], build_stages(cfg), cfg, x,
                         positions, training=training, routes=routes)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = unembed(cfg, params, x)
    if return_aux:
        return logits, {"moe_aux": aux}
    return logits


def unembed(cfg: ArchConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings or "lm_head" not in params:
        return layers.einsum_f32("bsd,vd->bsv", x, params["embed"])
    return layers.einsum_f32("bsd,dv->bsv", x, params["lm_head"])


# ---------------------------------------------------------------------------
# decode (one token against caches)
# ---------------------------------------------------------------------------

def _init_layer_cache(cfg: ArchConfig, spec: LayerSpec, batch: int,
                      seq: int, dtype: torch.dtype, device, lead=()) -> dict:
    if spec.kind == "attn":
        return {"attn": layers.gqa_cache_init(cfg, batch, seq, dtype, device,
                                              lead)}
    return {"ssm": mamba.ssm_cache_init(cfg, batch, dtype, device, lead)}


def init_caches(cfg: ArchConfig, batch: int, seq: int,
                dtype: torch.dtype | None = None, device=None) -> dict:
    """Cache tree: per stage, leaves stacked along ``n_units`` (the JAX
    package's names, shapes and dtypes: KV with an int32 ``index`` for
    attention layers, ``conv`` and float32 ``state`` for SSM layers), on
    ``device`` (``cuda`` unless the caller names another).  The MLA and
    enc-dec (``enc_out``) caches raise with the rest of their families
    (:func:`check_supported`)."""
    check_supported(cfg)
    device = resolve_device(device)
    dtype = dtype or torch_dtype(cfg.dtype)
    return {"stages": {
        f"stage_{i}": {f"sub_{j}": _init_layer_cache(
            cfg, spec, batch, seq, dtype, device, lead=(stage.n_units,))
            for j, spec in enumerate(stage.unit)}
        for i, stage in enumerate(build_stages(cfg))}}


def _decode_layer(p: dict, c: dict, cfg: ArchConfig, spec: LayerSpec,
                  x: torch.Tensor, positions: torch.Tensor,
                  routes: Optional[List[moe_lib.Route]] = None) -> torch.Tensor:
    """One layer of one-token decode; ``c`` (the layer's cache) is updated
    in place."""
    h = layers.rmsnorm(p["norm1"], x, cfg.norm_eps)
    if spec.kind == "attn":
        y, _ = layers.gqa_decode(p["attn"], cfg, h, c["attn"], positions)
    else:
        y, _ = mamba.ssm_decode(p["ssm"], cfg, h, c["ssm"])
    x = x + y
    if spec.ffn == "dense":
        h = layers.rmsnorm(p["norm2"], x, cfg.norm_eps)
        x = x + layers.mlp_forward(p["mlp"], h)
    elif spec.ffn == "moe":
        h = layers.rmsnorm(p["norm2"], x, cfg.norm_eps)
        x = x + moe_lib.moe_forward(p["moe"], cfg, h, routes)
    return x


def decode_step(cfg: ArchConfig, params: dict, caches: dict, batch: dict,
                *, routes: Optional[List[moe_lib.Route]] = None
                ) -> Tuple[torch.Tensor, dict]:
    """One-token decode. batch: {"tokens": [B,1], "index": the cache fill
    (an int or a 0-d int tensor)}.  Returns (float32 logits [B,1,V],
    caches): the caches are the same tensors, updated in place.  Where
    ``routes`` is a list, each MoE layer appends its routing to it."""
    check_supported(cfg)
    x = embed_inputs(cfg, params, batch)
    bsz = x.shape[0]
    index = batch["index"]
    # a Python int becomes a device scalar by a fill, not a blocking copy
    index = index.to(device=x.device, dtype=torch.int32) \
        if isinstance(index, torch.Tensor) else \
        torch.full((), int(index), dtype=torch.int32, device=x.device)
    positions = index.reshape(1, 1).expand(bsz, 1)
    x = _add_positions(cfg, x, positions)
    for i, stage in enumerate(build_stages(cfg)):
        units_p = _unstack(params["stages"][f"stage_{i}"], stage.n_units)
        units_c = _unstack(caches["stages"][f"stage_{i}"], stage.n_units)
        for unit_p, unit_c in zip(units_p, units_c):
            for j, spec in enumerate(stage.unit):
                x = _decode_layer(unit_p[f"sub_{j}"], unit_c[f"sub_{j}"],
                                  cfg, spec, x, positions, routes)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(cfg, params, x), caches
