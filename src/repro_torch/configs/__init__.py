"""Architecture configs (copies of the JAX package's).  Importing this
package registers all ten: the dense GQA decoders (``smollm-360m``,
``qwen3-1.7b``, ``mistral-nemo-12b``, ``stablelm-12b``), Mamba-2/SSD
(``mamba2-780m``), the MoE decoder (``phi3.5-moe-42b-a6.6b``), the hybrid
attention + SSM + MoE stack (``jamba-1.5-large-398b``), MLA + MoE + MTP
(``deepseek-v3-671b``), the encoder-decoder (``whisper-large-v3``) and
M-RoPE over precomputed embeddings (``qwen2-vl-72b``).  It also
registers the port's own ``granite-4.0-h-small`` (``PORT_ONLY_IDS``),
which the JAX package lacks; ``ARCH_IDS`` stays the JAX package's ten.

``shapes`` holds the dry run's input shapes and abstract (``meta``) input
specs.  The JAX package's ``configs/xla_flags.py`` configures XLA alone
(host device counts, GPU backend flags) and has no counterpart here:
torch runs no XLA."""
from repro_torch.configs import (  # noqa: F401
    mamba2_780m,
    stablelm_12b,
    smollm_360m,
    mistral_nemo_12b,
    qwen3_1p7b,
    jamba_1p5_large_398b,
    whisper_large_v3,
    phi35_moe_42b,
    deepseek_v3_671b,
    qwen2_vl_72b,
    granite_4p0_h_small,
)
from repro_torch.configs.shapes import SHAPES, cells, input_specs  # noqa: F401

ARCH_IDS = [
    "mamba2-780m", "stablelm-12b", "smollm-360m", "mistral-nemo-12b",
    "qwen3-1.7b", "jamba-1.5-large-398b", "whisper-large-v3",
    "phi3.5-moe-42b-a6.6b", "deepseek-v3-671b", "qwen2-vl-72b",
]

# architectures the port registers and the JAX package does not
PORT_ONLY_IDS = ["granite-4.0-h-small"]
