"""GQA flash attention, forward only (prefill): the CUDA kernel
(``csrc/flash_attention.cu``, a tensor-core route and an FMA route) for
CUDA tensors, the plain torch version for CPU tensors."""
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_cuda,
                                                     flash_attention_plain,
                                                     flash_route)

__all__ = ["flash_attention", "flash_attention_cuda",
           "flash_attention_plain", "flash_route"]
