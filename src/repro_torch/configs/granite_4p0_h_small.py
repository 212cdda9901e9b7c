"""granite-4.0-h-small — hybrid Mamba-2 + NoPE GQA, an MoE on every layer.

[hf:ibm-granite/granite-4.0-h-small config.json] 40L d_model=4096, a
period of 10 layers: five Mamba-2, one attention (indices 5, 15, 25, 35),
four Mamba-2.  Attention: GQA 32H kv=8 head_dim=128 with no positional
encoding (``position_embedding_type: nope``).  Mamba-2: 128 heads of 64
(expand 2), d_state 128, 1 group, conv 4 with bias, chunk 256.  Every
layer's feed-forward is an MoE of 72 SwiGLU experts of width 768, top 10
(softmax over the ten chosen logits, which the port's renormalised top-k
of the full softmax equals), plus one shared SwiGLU expert of width 1536
(the port's ``n_shared_experts=2`` experts of 768, as one MLP).  Vocab
100,352, tied.  Four scalars: embeddings x 12, attention scale 1/128,
each sublayer's output x 0.22 before its residual add, logits / 16.

Routing is dropless in the published model: capacity_factor = 72 / 10
makes the port's capacity at least the token count, so no assignment
drops.  The router leaf is float32 (the port's MoE), where the published
one is bfloat16.  This architecture is the port's own: the JAX package
does not register it.
"""
from repro_torch.models.config import ArchConfig, MoEConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=0,
    vocab_size=100352,
    rope_type="nope",
    tie_embeddings=True,
    norm_eps=1e-5,
    hybrid_pattern=("ssm",) * 5 + ("attn",) + ("ssm",) * 4,
    moe=MoEConfig(n_experts=72, top_k=10, d_ff_expert=768,
                  n_shared_experts=2, every_k_layers=1,
                  capacity_factor=7.2),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk_size=256,
                  n_groups=1, conv_width=4),
    embedding_multiplier=12.0,
    attention_multiplier=0.0078125,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    source="https://huggingface.co/ibm-granite/granite-4.0-h-small",
))
