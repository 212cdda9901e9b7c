"""mistral-nemo-12b — dense decoder LM, 128k context.

[hf:mistralai/Mistral-Nemo-Base-2407; hf] 40L d_model=5120 32H (GQA kv=8)
d_ff=14336 vocab=131072. Explicit head_dim=128 (not d_model/n_heads);
rope theta 1e6 for long context.
"""
from repro_torch.models.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1_000_000.0,
    source="hf:mistralai/Mistral-Nemo-Base-2407",
))
