"""The port's flash attention (``repro_torch.kernels.flash_attention``) on the
CPU, held against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages.  The
CPU path is the plain torch version (``flash_attention_plain``); the CUDA
kernel itself is held against that plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).  Tolerances are the JAX
tests' own (``tests/test_kernels_flash_attention.py``): float32 atol 3e-5 /
rtol 1e-4 (summation order), bf16 3e-2 (one bf16 rounding of the output).
"""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402

from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels.flash_attention import (flash_attention,  # noqa: E402
                                                 flash_attention_plain)
from repro_torch.models.layers import attention_core  # noqa: E402

F32 = dict(atol=3e-5, rtol=1e-4)
BF16 = dict(atol=3e-2, rtol=3e-2)

# B, S, Hq, Hkv, hd, causal: the five CASES of the JAX kernel test, plus a
# ragged S that the JAX kernel's block split would refuse
CASES = [
    (2, 128, 4, 2, 64, True),
    (1, 256, 8, 8, 32, True),
    (2, 64, 6, 2, 16, False),
    (1, 512, 2, 1, 128, True),
    (1, 64, 15, 5, 64, True),
    (2, 37, 6, 3, 16, True),
    (1, 37, 4, 1, 32, False),
]


def _qkv(b, s, hq, hkv, hd, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, hq, hd), dtype=np.float32)
    k = rng.standard_normal((b, s, hkv, hd), dtype=np.float32)
    v = rng.standard_normal((b, s, hkv, hd), dtype=np.float32)
    return [x.astype(dtype) for x in (q, k, v)]


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, dtype=np.float32)).to(dtype)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_matches_jax_reference_f32(case):
    b, s, hq, hkv, hd, causal = case
    q, k, v = _qkv(b, s, hq, hkv, hd, seed=sum(case))
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, backend="ref")
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal)
    assert got.shape == (b, s, hq, hd) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_matches_jax_reference_bf16(case):
    b, s, hq, hkv, hd, causal = case
    q, k, v = _qkv(b, s, hq, hkv, hd, seed=7 + sum(case))
    bf = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    want = jflash(*bf, causal=causal, backend="ref")
    # the same bf16 values cross to torch
    got = flash_attention(*[_t(np.asarray(x, np.float32), torch.bfloat16)
                            for x in bf], causal=causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16)


@pytest.mark.parametrize("case", [(2, 64, 4, 2, 16, 32, 32, True),
                                  (1, 64, 6, 2, 16, 64, 32, False)],
                         ids=str)
def test_plain_matches_jax_kernel_interpreted(case):
    """The Pallas kernel itself, in interpret mode on the CPU."""
    b, s, hq, hkv, hd, bq, bk, causal = case
    q, k, v = _qkv(b, s, hq, hkv, hd, seed=3)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, block_q=bq, block_k=bk, interpret=True)
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv", [(4, 2), (15, 5), (3, 3)])
def test_plain_matches_attention_core_f32(causal, hq, hkv):
    q, k, v = (_t(x) for x in _qkv(2, 40, hq, hkv, 16, seed=hq))
    np.testing.assert_allclose(
        flash_attention(q, k, v, causal=causal).numpy(),
        attention_core(q, k, v, causal=causal).numpy(), **F32)


def test_first_row_attends_only_itself():
    """Causal row 0 is v[0] exactly (the JAX kernel test's edge case)."""
    q, k, v = (_t(x) for x in _qkv(1, 64, 1, 1, 16, seed=2))
    out = flash_attention(q, k, v, causal=True)
    assert torch.equal(out[0, 0, 0], v[0, 0, 0])
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    assert torch.equal(flash_attention(qb, kb, vb)[0, 0, 0], vb[0, 0, 0])


def test_requires_grad_raises_under_grad():
    q, k, v = (_t(x) for x in _qkv(1, 8, 2, 1, 16, seed=4))
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_attention(q, k, v)
    with torch.no_grad():
        out = flash_attention(q, k, v)
    assert not out.requires_grad
    torch.testing.assert_close(out, flash_attention(q.detach(), k, v))


def test_cpu_dispatch_never_touches_the_kernel_library(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("the CPU path reached the kernel library")

    for name in ("call", "_lib", "build_all", "note_launch"):
        monkeypatch.setattr(_lib, name, refuse)
    q, k, v = (_t(x) for x in _qkv(2, 19, 4, 2, 16, seed=5))
    out = flash_attention(q, k, v)
    torch.testing.assert_close(out, flash_attention_plain(q, k, v))


@pytest.mark.parametrize("shapes", [
    ((1, 8, 4, 16), (1, 8, 3, 16), (1, 8, 3, 16)),     # 4 % 3 != 0
    ((1, 8, 4, 16), (1, 9, 2, 16), (1, 9, 2, 16)),     # S differs
    ((1, 8, 4, 16), (1, 8, 2, 16), (1, 8, 2, 8)),      # k and v differ
    ((8, 4, 16), (8, 2, 16), (8, 2, 16)),              # not 4-d
], ids=str)
def test_bad_shapes_raise(shapes):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError):
        flash_attention(q, k, v)


def test_device_without_a_kernel_raises():
    q = torch.zeros((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported devices"):
        flash_attention(q, q, q)
