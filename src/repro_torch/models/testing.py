"""Reduced-config helpers shared by smoke tests, examples and benchmarks."""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ArchConfig, MLAConfig, MoEConfig, SSMConfig


def reduced(cfg: ArchConfig, *, n_layers: int | None = None) -> ArchConfig:
    """Shrink a config to CPU-smoke size while keeping its *family structure*
    (hybrid pattern unit, MoE routing, MLA, qk-norm, enc-dec, frontend)."""
    kw: dict = {
        "d_model": 64,
        "d_ff": 128 if cfg.d_ff else 0,
        "vocab_size": 503,          # deliberately not a multiple of the pad
        "vocab_pad_multiple": 32,
        "head_dim": 16,
        "dtype": "float32",
    }
    if cfg.hybrid_pattern:
        unit = len(cfg.hybrid_pattern)
        kw["n_layers"] = n_layers or 2 * unit
        kw["n_heads"], kw["n_kv_heads"] = 4, 2
    elif cfg.family == "ssm":
        kw["n_layers"] = n_layers or 4
        kw["n_heads"] = kw["n_kv_heads"] = 8   # d_inner/head_dim = 128/16
    else:
        kw["n_layers"] = n_layers or 4
        kw["n_heads"], kw["n_kv_heads"] = 4, 2
    if cfg.enc_dec:
        kw["n_encoder_layers"] = 2
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                              qk_nope_head_dim=16, qk_rope_head_dim=8,
                              v_head_dim=16)
        kw["head_dim"] = 0
    if cfg.moe is not None:
        m = cfg.moe
        nd = min(m.n_dense_layers, 1)
        # capacity_factor 8 => effectively no token dropping, so reduced-config
        # prefill and decode agree exactly (dropping depends on T=B*S and is
        # exercised separately in test_moe.py).
        kw["moe"] = MoEConfig(n_experts=4, top_k=min(m.top_k, 2),
                              d_ff_expert=64,
                              n_shared_experts=min(m.n_shared_experts, 1),
                              every_k_layers=m.every_k_layers,
                              n_dense_layers=nd,
                              capacity_factor=8.0)
        if cfg.hybrid_pattern:
            kw["moe"] = dataclasses.replace(kw["moe"], n_dense_layers=0)
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=16, head_dim=16, expand=2,
                              chunk_size=8, n_groups=cfg.ssm.n_groups
                              if cfg.ssm.n_groups <= 2 else 2,
                              conv_width=4)
    if cfg.rope_type == "mrope":
        kw["mrope_sections"] = (4, 2, 2)   # head_dim/2 = 8
    return cfg.replace(**kw)
