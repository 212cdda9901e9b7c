"""jamba-1.5-large-398b — hybrid Mamba+attention MoE.

[arXiv:2403.19887; hf] 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2, attn:mamba 1:7 interleave.

Repeating unit of 8 layers: [attn, ssm x7]; MoE FFN on every 2nd layer
(others dense). Mamba layers use our Mamba-2 SSD formulation (see
DESIGN.md §8 — Jamba ships Mamba-1; same state-space family). Chunk size
128 keeps the intra-chunk SSD working set VMEM-friendly at d_inner=16384.
"""
from repro_torch.models.config import ArchConfig, MoEConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    hybrid_pattern=("attn",) + ("ssm",) * 7,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576, every_k_layers=2),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk_size=128,
                  n_groups=8, conv_width=4),
    source="arXiv:2403.19887",
))
