"""Architecture configuration system (a copy of the JAX package's).

One frozen dataclass describes every architecture; the LM in ``lm.py``
interprets it.  Configs are pure data.  The port's ``lm.py`` runs every
architecture the JAX package runs: GQA (optional qk-norm, RoPE, M-RoPE or
sinusoidal positions) and MLA attention, Mamba-2/SSD layers, SwiGLU and
MoE feed-forwards, hybrid stacks, the encoder-decoder with
cross-attention, precomputed input embeddings (the stubbed audio and
vision frontends) and the MTP block.  ``configs`` registers all ten
architectures.

The port has fields of its own, which the JAX package lacks: the four
scalars of Granite 4.0's residual and attention paths
(``embedding_multiplier``, ``attention_multiplier``,
``residual_multiplier``, ``logits_scaling``) and the ``rope_type`` value
``"nope"`` (attention with no positional encoding at all).  At their
neutral defaults the model computes what it computed without them, so
the ten shared architectures keep the JAX package's numbers.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2/V3)."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 16
    top_k: int = 2
    d_ff_expert: int = 0          # expert hidden size (0 -> use cfg.d_ff)
    n_shared_experts: int = 0     # always-on shared experts (DeepSeek)
    capacity_factor: float = 1.25
    every_k_layers: int = 1       # MoE on layers where (idx % every_k == k-1)
    n_dense_layers: int = 0       # first N layers stay dense (DeepSeek: 3)
    router_dtype: str = "float32"


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD parameters."""
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk_size: int = 256
    n_groups: int = 1
    conv_width: int = 4


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | ssm | hybrid | moe | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    qk_norm: bool = False
    # standard | mrope | none (sinusoidal absolute positions added to the
    # embeddings) | nope (no positions: attention is order-blind but causal)
    rope_type: str = "standard"
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # t/h/w split of head_dim/2
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # Hybrid interleave: repeating unit of layer kinds, e.g. ("attn",) + ("ssm",)*7.
    hybrid_pattern: Optional[Tuple[str, ...]] = None
    enc_dec: bool = False         # whisper: encoder + decoder w/ cross-attention
    n_encoder_layers: int = 0     # enc-dec only (0 -> n_layers)
    frontend: Optional[str] = None  # "audio" | "vision" | None (stub modality)
    mtp: bool = False             # multi-token-prediction extra block (DeepSeek-V3)
    dtype: str = "bfloat16"
    # Embedding tables are padded up to a multiple of this so the vocab dim is
    # always TP-shardable; the loss/sampler mask positions >= vocab_size.
    vocab_pad_multiple: int = 256
    # Source provenance, for the config files' docstrings.
    source: str = ""
    # ---- the port's own fields (Granite 4.0); neutral by default ----
    embedding_multiplier: float = 1.0   # x = multiplier * embed[token]
    attention_multiplier: float = 0.0   # softmax scale; 0 -> 1/sqrt(head_dim)
    residual_multiplier: float = 1.0    # x += multiplier * sublayer(x)
    logits_scaling: float = 1.0         # logits = unembed(x) / scaling

    # ---- derived ----
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (SSM/hybrid families)."""
        return self.family in ("ssm", "hybrid")

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kind sequence, length n_layers (decoder side for enc-dec)."""
        if self.hybrid_pattern:
            unit = self.hybrid_pattern
            reps = self.n_layers // len(unit)
            assert reps * len(unit) == self.n_layers, (
                f"{self.name}: n_layers={self.n_layers} not a multiple of "
                f"hybrid unit {len(unit)}")
            return unit * reps
        if self.family == "ssm":
            return ("ssm",) * self.n_layers
        return ("attn",) * self.n_layers

    def replace(self, **kw) -> "ArchConfig":
        """A copy with ``kw`` changed.  Values as JSON gives them are taken
        too: a dict for ``mla`` / ``moe`` / ``ssm`` becomes its dataclass,
        a list for ``hybrid_pattern`` / ``mrope_sections`` a tuple."""
        for k, sub in _NESTED.items():
            if isinstance(kw.get(k), dict):
                kw[k] = sub(**kw[k])
        for k in _TUPLES:
            if isinstance(kw.get(k), list):
                kw[k] = tuple(kw[k])
        return dataclasses.replace(self, **kw)

    @property
    def attn_scale(self) -> Optional[float]:
        """The configured softmax scale; None where it is the default
        1/sqrt(head_dim), so the default path runs unchanged."""
        return self.attention_multiplier or None

    # ---- parameter counting (for 6ND roofline terms) ----
    def param_counts(self) -> dict:
        """Analytic parameter counts: {'total': N, 'active': N_active}.

        ``active`` counts MoE experts at top_k (+shared) instead of n_experts,
        which is what 6*N_active*D model-FLOPs uses.
        """
        d, hd = self.d_model, self.resolved_head_dim
        nq, nkv = self.n_heads, self.n_kv_heads
        total = active = 0

        def attn_params() -> int:
            if self.mla is not None:
                m = self.mla
                qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
                p = d * m.q_lora_rank + m.q_lora_rank * nq * qk_hd        # q down/up
                p += d * (m.kv_lora_rank + m.qk_rope_head_dim)             # kv down
                p += m.kv_lora_rank * nq * (m.qk_nope_head_dim + m.v_head_dim)
                p += nq * m.v_head_dim * d                                 # o proj
                return p
            return d * nq * hd + 2 * d * nkv * hd + nq * hd * d

        def mlp_params(ff: int) -> int:
            return 3 * d * ff                                              # gate,up,down

        def ssm_params() -> int:
            s = self.ssm or SSMConfig()
            d_in = s.expand * d
            nh = d_in // s.head_dim
            p = d * (2 * d_in + 2 * s.n_groups * s.d_state + nh)           # in_proj
            p += s.conv_width * (d_in + 2 * s.n_groups * s.d_state)        # conv
            p += 2 * nh                                                    # A_log, D
            p += d_in * d                                                  # out_proj
            return p

        kinds = self.layer_kinds
        moe = self.moe
        for i, kind in enumerate(kinds):
            if kind == "attn":
                total += attn_params(); active += attn_params()
            else:
                total += ssm_params(); active += ssm_params()
            # per-layer FFN (attn layers in hybrids also carry FFN; ssm layers in
            # pure-ssm archs do not).
            if self.family == "ssm":
                continue
            if moe is not None and i >= moe.n_dense_layers and \
                    (i % moe.every_k_layers == moe.every_k_layers - 1):
                ff = moe.d_ff_expert or self.d_ff
                total += moe.n_experts * mlp_params(ff)
                active += moe.top_k * mlp_params(ff)
                total += moe.n_shared_experts * mlp_params(ff)
                active += moe.n_shared_experts * mlp_params(ff)
                total += d * moe.n_experts                                  # router
                active += d * moe.n_experts
            else:
                total += mlp_params(self.d_ff); active += mlp_params(self.d_ff)
        # norms (2/layer + final)
        total += (2 * len(kinds) + 1) * d; active += (2 * len(kinds) + 1) * d
        # embeddings (+ untied head)
        emb = self.vocab_size * d
        total += emb; active += emb
        if not self.tie_embeddings:
            total += emb; active += emb
        if self.enc_dec:
            n_enc = self.n_encoder_layers or self.n_layers
            enc = n_enc * (attn_params() + mlp_params(self.d_ff) + 2 * d)
            # decoder cross-attention blocks
            dec_x = len(kinds) * (attn_params() + d)
            total += enc + dec_x; active += enc + dec_x
        return {"total": total, "active": active}


_NESTED = {"mla": MLAConfig, "moe": MoEConfig, "ssm": SSMConfig}
_TUPLES = ("hybrid_pattern", "mrope_sections")
# the port's own fields and their neutral values (the JAX package has none)
PORT_ONLY_FIELDS = {"embedding_multiplier": 1.0, "attention_multiplier": 0.0,
                    "residual_multiplier": 1.0, "logits_scaling": 1.0}

_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    # configs package registers on import
    from repro_torch import configs as _  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list:
    from repro_torch import configs as _  # noqa: F401
    return sorted(_REGISTRY)
