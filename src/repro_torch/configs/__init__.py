"""Architecture configs the port can run.  Importing this package registers
them: the dense GQA decoders.  The JAX package's other architectures (MoE,
Mamba, MLA, enc-dec, M-RoPE, frontends, MTP) are not ported yet."""
from repro_torch.configs import qwen3_1p7b, smollm_360m  # noqa: F401
