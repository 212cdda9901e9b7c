"""Chunk store keys (BLAKE2b-128) of a tensor's chunks: the CUDA kernel
(``csrc/chunk_key.cu``) for CUDA tensors, the plain numpy version for CPU
tensors."""
from repro_torch.kernels.chunk_key.ops import (chunk_key_cuda,
                                               chunk_key_digests,
                                               chunk_key_digests_np,
                                               hex_keys)

__all__ = ["chunk_key_cuda", "chunk_key_digests", "chunk_key_digests_np",
           "hex_keys"]
