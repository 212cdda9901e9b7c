"""The port's flash attention (``repro_torch.kernels.flash_attention``) on the
CPU, held against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages.  The
CPU path is the plain torch version (``flash_attention_plain``); the CUDA
kernel itself is held against that plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).  Tolerances are the JAX
tests' own (``tests/test_kernels_flash_attention.py``): float32 atol 3e-5 /
rtol 1e-4 (summation order), bf16 3e-2 (one bf16 rounding of the output).
The tensor-core route's arithmetic (p split into two bf16 halves for P.V)
is emulated in plain torch and held to the card's bf16 tolerance.
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
                                                 flash_attention_plain,
                                                 flash_route)
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


# ---------------------------------------------------------------------------
# the tensor-core route: which operands take it, and its P.V arithmetic
# ---------------------------------------------------------------------------

# the card's bf16 tolerance of a kernel against the plain version
# (tests/test_torch_cuda.py FLASH_TOL, chip_smoke.py)
CARD_BF16 = dict(atol=1e-5, rtol=2 ** -7)


@pytest.mark.parametrize("shape", [(2, 8, 4, 2, 16), (2, 8, 4, 2, 32),
                                   (2, 8, 4, 2, 64), (2, 8, 4, 2, 128),
                                   (2, 8, 4, 2, 256), (8, 512, 15, 5, 64),
                                   (8, 512, 16, 8, 128)], ids=str)
def test_route_is_tc_for_contiguous_bf16(shape):
    """Contiguous bf16 takes the tensor-core route at every head dim up to
    256 and at the prefill shapes (SmolLM-360M, qwen3-1.7b); float32 the
    fma route."""
    b, s, hq, hkv, hd = shape
    q = torch.zeros((b, s, hq, hd), dtype=torch.bfloat16)
    k = torch.zeros((b, s, hkv, hd), dtype=torch.bfloat16)
    assert flash_route(q, k, k) == "tc"
    assert flash_route(q.float(), k.float(), k.float()) == "fma"


def test_route_is_fma_where_tma_cannot_address():
    """A dim stride of 2, a dtype mix, or a base off 16 bytes: fma."""
    q = torch.zeros((2, 8, 4, 64), dtype=torch.bfloat16)
    wide = torch.zeros((2, 8, 2, 128), dtype=torch.bfloat16)
    k = wide[..., ::2]
    assert k.stride(3) == 2 and flash_route(q, k, k) == "fma"
    assert flash_route(q, q[:, :, :2].float(), q[:, :, :2]) == "fma"
    flat = torch.zeros(2 * 8 * 4 * 64 + 1, dtype=torch.bfloat16)
    off = flat[1:].view(2, 8, 4, 64)                    # base + 2 bytes
    assert flash_route(off, q, q) == "fma"
    fused = torch.zeros((2, 8, 8, 64), dtype=torch.bfloat16)
    qs, ks, vs = fused.split([4, 2, 2], dim=2)           # views, in place
    assert not qs.is_contiguous() and flash_route(qs, ks, vs) == "tc"


def _emulate_tc(q, k, v, causal, split=True):
    """The tensor-core route's arithmetic in plain torch: tiles of 64 keys,
    scores in log2 units, online softmax in float32, and P.V on p rounded
    to bf16, once (``split=False``) or as hi + lo halves (``split=True``),
    with float32 accumulation.  q, k, v bf16 [B,S,H,hd] (GQA repeated)."""
    _, s, hq, hd = q.shape
    n_rep = hq // k.shape[2]
    k = torch.repeat_interleave(k, n_rep, dim=2).float()
    v = torch.repeat_interleave(v, n_rep, dim=2).float()
    qf = q.float()
    scale2 = np.float32(1 / np.sqrt(hd)) * np.float32(np.log2(np.e))
    m = torch.full((q.shape[0], hq, s, 1), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros((q.shape[0], hq, s, hd))
    rows = torch.arange(s)[:, None]
    for k0 in range(0, s, 64):
        kt, vt = k[:, k0:k0 + 64], v[:, k0:k0 + 64]
        raw = torch.einsum("bqhd,bkhd->bhqk", qf, kt)
        valid = torch.ones((s, kt.shape[1]), dtype=torch.bool)
        if causal:
            valid = torch.arange(k0, k0 + kt.shape[1])[None, :] <= rows
        raw = raw.masked_fill(~valid, -1e30)
        m_new = torch.maximum(m, raw.amax(-1, keepdim=True) * scale2)
        corr = torch.exp2(m - m_new)
        p = torch.exp2(raw * scale2 - m_new).masked_fill(~valid, 0.0)
        l = corr * l + p.sum(-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        pv = torch.einsum("bhqk,bkhd->bhqd", hi, vt)
        if split:
            lo = (p - hi).to(torch.bfloat16).float()
            pv = pv + torch.einsum("bhqk,bkhd->bhqd", lo, vt)
        acc = corr * acc + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


def _bf16_case(causal):
    q, k, v = _qkv(2, 130, 6, 2, 64, seed=11 + causal)
    bf = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    want = jflash(*bf, causal=causal, backend="ref")
    tq, tk, tv = (_t(np.asarray(x, np.float32), torch.bfloat16) for x in bf)
    return tq, tk, tv, np.asarray(want, np.float32)


@pytest.mark.parametrize("causal", [True, False])
def test_tc_split_pv_meets_the_card_tolerance(causal):
    """p = hi + lo (two bf16 halves) keeps P.V within the card's bf16
    tolerance of the JAX reference."""
    q, k, v, want = _bf16_case(causal)
    got = _emulate_tc(q, k, v, causal)
    np.testing.assert_allclose(got.float().numpy(), want, **CARD_BF16)
    if causal:                      # row 0 attends only itself
        assert torch.equal(got[:, 0], torch.repeat_interleave(v[:, 0], 3, 1))


@pytest.mark.parametrize("causal", [True, False])
def test_one_bf16_rounding_of_p_misses_the_card_tolerance(causal):
    """Why the split exists: p rounded once to bf16 (2^-9 relative) moves
    outputs near zero by more than atol 1e-5 + rtol 2^-7."""
    q, k, v, want = _bf16_case(causal)
    got = _emulate_tc(q, k, v, causal, split=False).float().numpy()
    bad = np.abs(got - want) > CARD_BF16["atol"] + CARD_BF16["rtol"] * \
        np.abs(want)
    assert bad.any()
