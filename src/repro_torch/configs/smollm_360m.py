"""smollm-360m — llama-arch small dense LM.

[hf:HuggingFaceTB/SmolLM-135M; hf] 32L d_model=960 15H (GQA kv=5)
d_ff=2560 vocab=49152. head_dim = 64. Tied embeddings.
15 heads is not divisible by the 16-way model axis — exercises the
sequence-parallel sharding fallback.
"""
from repro_torch.models.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    tie_embeddings=True,
    rope_theta=10_000.0,
    source="hf:HuggingFaceTB/SmolLM-360M",
))
