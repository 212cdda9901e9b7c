"""Per-chunk detection hashing: the CUDA kernel (``csrc/chunk_hash.cu``)
for CUDA tensors, the plain torch version for CPU tensors."""
from repro_torch.kernels.chunk_hash.ops import (chunk_hash, chunk_hash_cuda,
                                                chunk_hash_u64)

__all__ = ["chunk_hash", "chunk_hash_cuda", "chunk_hash_u64"]
