"""deepseek-v3-671b — MLA + 256-expert top-8 MoE + MTP.

[arXiv:2412.19437; hf] 61L d_model=7168 128H d_ff=2048 (routed expert
hidden), vocab=129280, MoE 1 shared + 256 routed top-8, first 3 layers
dense (d_ff 18432), MLA (q_lora 1536, kv_lora 512, nope 128, rope 64,
v 128), multi-token-prediction head. Decode caches the *compressed*
latent (c_kv 512 + k_rope 64 per token per layer).
"""
from repro_torch.models.config import ArchConfig, MLAConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,            # dense-prefix layers
    vocab_size=129280,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048,
                  n_shared_experts=1, n_dense_layers=3,
                  capacity_factor=1.25),
    mtp=True,
    source="arXiv:2412.19437",
))
