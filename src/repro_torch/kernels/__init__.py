"""Hand-written CUDA kernels of the port (sources in ``csrc/``), each with
its plain PyTorch version beside it in the same module.

- ``chunk_hash``    — per-chunk detection hashing.
- ``delta_pack``    — fused hash + diff + ordered compaction of dirty chunks.
- ``delta_codec``   — bit-plane encode of the compacted rows (+ the host
                      codec, ``delta_codec.host``).
- ``patch_scatter`` — in-place landing of fetched chunks at checkout.

A wrapper launches its kernel for a CUDA tensor (or raises) and runs the
plain version for a CPU tensor.  Nothing here builds or imports CUDA code
at import time: ``_lib`` compiles on the first launch.
"""
