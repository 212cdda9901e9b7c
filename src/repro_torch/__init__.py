"""Kishu on PyTorch and CUDA — the port of ``repro`` (JAX on a TPU).

The same incremental commit/checkout system over torch tensors: manifests,
chunk keys, KZC1 frames and txn docs are byte-identical to the JAX
package's, so a store written by either package checks out in the other.
The main path's four TPU kernels are hand-written CUDA kernels for Hopper
(``csrc/``), each with a plain torch version for CPU tensors.

This package imports torch and never jax, and nothing of ``repro``: it
keeps its own copies of the host-only modules.

Reference tests red on the tree this port started from, never to be used
as oracles: ``test_patch_scatter.py::test_scatter_roundtrip_wide_dtypes``
(uint64/int64/float64 — 8-byte scatters are held against
``delta.patch_numpy_base`` instead), ``test_txn_crash.py::
test_two_writer_crash_sweep[sqlite]``, and the two multi-device tests of
``test_distribution.py``.
"""
