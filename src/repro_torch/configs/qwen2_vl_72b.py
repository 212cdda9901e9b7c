"""qwen2-vl-72b — VLM backbone with M-RoPE.

[arXiv:2409.12191; hf] 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064. Vision frontend is a STUB: input_specs() provides
precomputed patch/text embeddings [B, S, d_model] plus positions_thw
[B, S, 3] (temporal/height/width M-RoPE ids). head_dim=128;
mrope_sections (16,24,24) over head_dim/2=64.
"""
from repro_torch.models.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    rope_type="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    frontend="vision",
    source="arXiv:2409.12191",
))
