"""The port's exact per-chunk compare held against the JAX package.

``block_diff_plain`` (what a CPU tensor runs, and what the CUDA kernel is
held against on the card) against ``repro.kernels.block_diff.block_diff``
with the Pallas kernel in interpret mode, and the port's
``delta.exact_dirty_indices`` against the JAX package's, over the dtypes
and sizes of ``test_kernels_block_diff.py`` — flags must be exactly equal.
"""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import delta as jdelta  # noqa: E402
from repro.kernels.block_diff import block_diff as jblock_diff  # noqa: E402

from repro_torch.core import delta as tdelta  # noqa: E402
from repro_torch.interop import array_to_tensor  # noqa: E402
from repro_torch.kernels.block_diff.ops import (block_diff,  # noqa: E402
                                                block_diff_plain,
                                                dirty_chunks)

CB = 1 << 12
DTYPES = ["float32", "float16", "bfloat16", "int8", "uint8"]
SIZES = [16, 1024, 4096, 10000]


def _pair(dtype, n, flips, seed=0):
    rng = np.random.default_rng(seed)
    np_dt = jnp.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
    if dtype in ("int8", "uint8"):
        a = rng.integers(0, 100, n).astype(np_dt)
    else:
        a = rng.standard_normal(n).astype(np_dt)
    b = a.copy()
    for pos in flips:
        b[pos % n] = b[pos % n] + np.asarray(1, np_dt)
    return a, b


def _u8(a):
    return array_to_tensor(a, "cpu").reshape(-1).view(torch.uint8)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("flips", [(), (0,), (3, 2047, 9999)])
def test_plain_matches_pallas_interpret(dtype, n, flips):
    a, b = _pair(dtype, n, flips)
    want = np.asarray(jblock_diff(jnp.asarray(a), jnp.asarray(b), CB,
                                  backend="pallas", interpret=True))
    got = block_diff_plain(_u8(a), _u8(b), CB).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("flips", [(), (1,), (5, 4000, 8191)])
def test_exact_dirty_indices_matches_jax(dtype, n, flips):
    a, b = _pair(dtype, n, flips, seed=1)
    want = jdelta.exact_dirty_indices(jnp.asarray(a), jnp.asarray(b), CB)
    ta, tb = array_to_tensor(a, "cpu"), array_to_tensor(b, "cpu")
    assert tdelta.exact_dirty_indices(ta, tb, CB) == want
    # numpy operands take the host byte compare, as in the JAX package
    assert tdelta.exact_dirty_indices(a, b, CB) == want
    assert tdelta.exact_dirty_indices(ta, b, CB) == want


@pytest.mark.parametrize("cb", [3, 1000, 3000, 4098, 12292])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "uint8"])
def test_any_chunk_size_matches_jax(cb, dtype):
    """A chunk size that is no power of two still goes through block_diff
    (never a host compare of tensors); the JAX package answers such sizes
    with its host byte compare, and both agree."""
    a, b = _pair(dtype, 10000, (0, 2999, 5001, 9999), seed=2)
    want = jdelta.exact_dirty_indices(jnp.asarray(a), jnp.asarray(b), cb)
    assert want
    ta, tb = array_to_tensor(a, "cpu"), array_to_tensor(b, "cpu")
    assert dirty_chunks(ta, tb, cb).tolist() == want
    assert tdelta.exact_dirty_indices(ta, tb, cb) == want


@pytest.mark.parametrize("n,pos", [(1, 0), (1023, 1022), (1025, 1024),
                                   (20000, 19999), (20000, 12345)])
def test_single_flip_in_the_right_chunk(n, pos):
    a = np.zeros(n, np.float32)
    b = a.copy()
    b[pos] = 1.0
    got = block_diff(torch.from_numpy(a), torch.from_numpy(b), CB).numpy()
    assert got[(pos * 4) // CB] == 1 and got.sum() == 1
    assert dirty_chunks(torch.from_numpy(a), torch.from_numpy(b),
                        CB).tolist() == [(pos * 4) // CB]


def test_ragged_tail_compares_true_bytes_only():
    """A ragged last chunk: the bytes past the end compare equal, as the
    JAX package's zero padding on both sides does."""
    a = np.arange(3 * 1024 + 3, dtype=np.uint8)
    b = a.copy()
    b[-1] ^= 1
    got = block_diff_plain(_u8(a), _u8(b), 1024)
    assert got.tolist() == [0, 0, 0, 1]
    assert block_diff_plain(_u8(a), _u8(a.copy()), 1024).tolist() \
        == [0, 0, 0, 0]


def test_multi_chunk_and_shapes():
    a = torch.zeros((4, CB // 4))              # 4 chunks of CB bytes
    b = a.clone()
    b[0, 0] = 1
    b[-1, -1] = 1
    assert block_diff(a, b, CB).tolist() == [1, 0, 0, 1]
    # byte length decides, not shape: the same bytes viewed flat
    assert block_diff(a.reshape(-1), b, CB).tolist() == [1, 0, 0, 1]


def test_empty_and_mismatched():
    e = torch.zeros(0)
    assert block_diff(e, e.clone(), CB).numel() == 0
    assert tdelta.exact_dirty_indices(e, e.clone(), CB) == []
    with pytest.raises(ValueError):
        block_diff(torch.zeros(4), torch.zeros(5), CB)
    for cb in (0, -4096):                       # no chunk size to split by
        with pytest.raises(ValueError):
            block_diff(torch.zeros(4), torch.zeros(4), cb)
    with pytest.raises(ValueError):
        tdelta.exact_dirty_indices(np.zeros(4), np.zeros(5), CB)


def test_non_contiguous_compares_logical_bytes():
    a = torch.arange(2048, dtype=torch.float32).reshape(32, 64)
    b = a.clone()
    b[5, 7] = -1
    at, bt = a.t(), b.t()                      # C-order image of the views
    want = jdelta.exact_dirty_indices(jnp.asarray(at.numpy()),
                                      jnp.asarray(bt.numpy()), 1024)
    assert tdelta.exact_dirty_indices(at, bt, 1024) == want


def test_no_kernel_for_other_devices():
    x = torch.zeros(4096, device="meta")
    with pytest.raises((ValueError, NotImplementedError, RuntimeError)):
        block_diff(x, x, CB)
    with pytest.raises(ValueError):
        block_diff(torch.zeros(1024), x, CB)
