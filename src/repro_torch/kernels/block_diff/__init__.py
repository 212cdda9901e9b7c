"""Exact per-chunk compare of two buffers: the CUDA kernel
(``csrc/block_diff.cu``) for CUDA tensors, the plain torch version for CPU
tensors."""
from repro_torch.kernels.block_diff.ops import (block_diff, block_diff_cuda,
                                                block_diff_plain,
                                                dirty_chunks)

__all__ = ["block_diff", "block_diff_cuda", "block_diff_plain",
           "dirty_chunks"]
