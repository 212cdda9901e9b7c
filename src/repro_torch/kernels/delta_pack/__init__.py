"""Fused on-device delta pipeline: hash + diff + ordered dirty-chunk
compaction in one pass over the tensor (``csrc/delta_pack.cu``), with its
plain torch version for CPU tensors."""
from repro_torch.kernels.delta_pack.ops import (DeltaPack,  # noqa: F401
                                                delta_pack, delta_pack_cuda,
                                                delta_pack_plain)
