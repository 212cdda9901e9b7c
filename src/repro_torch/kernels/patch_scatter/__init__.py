"""Fused checkout scatter: land every fetched chunk of a co-variable in the
live tensor in one pass (``csrc/patch_scatter.cu``), with its plain torch
version for CPU tensors."""
