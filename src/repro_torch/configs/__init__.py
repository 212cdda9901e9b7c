"""Architecture configs the port can run.  Importing this package registers
them: the dense GQA decoders (``smollm-360m``, ``qwen3-1.7b``), Mamba-2/SSD
(``mamba2-780m``), the MoE decoder (``phi3.5-moe-42b-a6.6b``) and the
hybrid attention + SSM + MoE stack (``jamba-1.5-large-398b``).  The JAX
package's other architectures (MLA with MTP, enc-dec, M-RoPE with the
vision frontend, and the remaining dense configs) are not ported yet."""
from repro_torch.configs import (  # noqa: F401
    jamba_1p5_large_398b,
    mamba2_780m,
    phi35_moe_42b,
    qwen3_1p7b,
    smollm_360m,
)
