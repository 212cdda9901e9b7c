"""qwen3-1.7b — dense decoder LM with qk-norm.

[hf:Qwen/Qwen3-8B family; hf] 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936. head_dim=128, per-head RMSNorm on q and k, tied embeddings.
"""
from repro_torch.models.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-1.7B",
))
