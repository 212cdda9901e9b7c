"""mamba2-780m — SSD (state-space duality), attention-free.

[arXiv:2405.21060; unverified] 48L d_model=1536 d_ff=0 vocab=50280,
ssm_state=128. Mamba-2 defaults: expand=2 (d_inner=3072), head_dim=64
(48 SSD heads), 1 group, conv width 4, tied embeddings (GPT-NeoX tokenizer).
"""
from repro_torch.models.config import ArchConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=48,            # SSD heads (d_inner / head_dim)
    n_kv_heads=48,
    d_ff=0,
    vocab_size=50280,
    rope_type="none",
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk_size=256,
                  n_groups=1, conv_width=4),
    source="arXiv:2405.21060",
))
