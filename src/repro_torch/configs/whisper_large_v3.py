"""whisper-large-v3 — encoder-decoder audio backbone.

[arXiv:2212.04356; unverified] 32L d_model=1280 20H (kv=20) d_ff=5120
vocab=51866. Conv frontend is a STUB: input_specs() provides precomputed
frame embeddings [B, S, d_model] for the encoder. Sinusoidal positions
(rope_type="none"); decoder has cross-attention over encoder output.
20 heads not divisible by 16 — exercises the seq-parallel fallback.
"""
from repro_torch.models.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    n_encoder_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    rope_type="none",
    enc_dec=True,
    frontend="audio",
    source="arXiv:2212.04356",
))
