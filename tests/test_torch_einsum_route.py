"""The port's einsum route: every equation that ``einsum_f32`` is called
with in ``src/repro_torch`` decomposes into one batched matrix product
whose result equals ``torch.einsum``.

``einsum_plan`` is a plain function on shapes and ``einsum_via`` takes the
matrix product as an argument, so the decomposition is held here on float32
CPU tensors with ``torch.bmm`` injected; the card runs the same plan with
``bmm``/``mm`` at ``out_dtype=float32`` (``tests/test_torch_cuda.py``).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.models import layers
from repro_torch.models.layers import einsum_f32, einsum_plan, einsum_via

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
_CALL = re.compile(r"einsum_f32\(\s*\"([a-z,]+->[a-z]+)\"")


def port_equations():
    eqs = set()
    for path in SRC.rglob("*.py"):
        eqs.update(_CALL.findall(path.read_text()))
    return sorted(eqs)


EQUATIONS = port_equations()
TWO_OPERAND = [e for e in EQUATIONS if e.split("->")[0].count(",") == 1]


def _operands(eq, seed=0, dtype=torch.float32):
    """Seeded numpy operands, each label 1-5 wide (a 1 tests the merges
    of unit dims)."""
    rng = np.random.default_rng(seed)
    labels = sorted(set(eq.replace(",", "").replace("->", "")))
    size = {c: int(rng.integers(1, 6)) for c in labels}
    ins = eq.split("->")[0].split(",")
    return [torch.from_numpy(rng.standard_normal(
        [size[c] for c in t]).astype(np.float32)).to(dtype) for t in ins]


def test_the_port_uses_the_expected_equations():
    # 17 two-operand equations and the two three-operand SSD products
    assert len(TWO_OPERAND) == 17, TWO_OPERAND
    assert set(EQUATIONS) - set(TWO_OPERAND) == {
        "bclh,bclhn,bclhp->bchpn", "bclh,bclhn,bchpn->bclhp"}


@pytest.mark.parametrize("eq", TWO_OPERAND)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decomposition_equals_einsum(eq, seed):
    a, b = _operands(eq, seed)
    calls = []

    def matmul(x, y):
        assert x.dim() == y.dim() == 3 and x.shape[2] == y.shape[1]
        calls.append((tuple(x.shape), tuple(y.shape)))
        return torch.bmm(x, y)

    got = einsum_via(eq, a, b, matmul)
    want = torch.einsum(eq, a, b)
    assert len(calls) == 1
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("eq", EQUATIONS)
def test_einsum_f32_on_the_cpu_is_the_upcast(eq):
    """CPU tensors keep the upcast: bit-equal to ``torch.einsum`` of the
    float32 operands, float32 out."""
    ops = _operands(eq, 3, torch.bfloat16)
    got = einsum_f32(eq, *ops)
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.einsum(eq, *[o.float() for o in ops]))


def test_plan_of_a_weight_product_makes_no_copy():
    """``bsd,dhk->bshk`` (a q/k/v projection): the weight [d,h,k] reshapes
    to [1,d,h*k] in place and the activation to [1,b*s,d]."""
    pl = einsum_plan("bsd,dhk->bshk", (2, 3, 8), (8, 4, 5))
    assert pl.perm_a == (0, 1, 2) and pl.a3 == (1, 6, 8)
    assert pl.perm_b == (0, 1, 2) and pl.b3 == (1, 8, 20)
    w = torch.randn(8, 4, 5)
    assert w.permute(pl.perm_b).reshape(pl.b3).data_ptr() == w.data_ptr()
    pl = einsum_plan("ecd,edf->ecf", (4, 3, 8), (4, 8, 6))
    assert pl.a3 == (4, 3, 8) and pl.b3 == (4, 8, 6)


@pytest.mark.parametrize("eq,sa,sb", [
    ("ab,bc->a", (2, 3), (3, 4)),        # c summed out of one operand
    ("aa,ab->b", (2, 2), (2, 3)),        # repeated label
    ("ab,bc->ac", (2, 3), (4, 5)),       # size mismatch
])
def test_plan_rejects(eq, sa, sb):
    with pytest.raises(ValueError):
        einsum_plan(eq, sa, sb)


def test_backward_matches_the_upcast_path(monkeypatch):
    """The route's autograd function, its float32-accumulating product
    stood in by an upcast ``bmm`` (the CPU has no ``mm.dtype``): gradients
    of a bf16 dense layer against the upcast einsum's.  The float32
    cotangent is split exactly into three bf16 parts, so each gradient
    element is the upcast path's or one bf16 rounding step from it (2**-7
    relative, plus float32 summation noise of 2**-16 of the largest where
    a sum cancels), and fewer than 1% differ at all.  Rounding the
    cotangent to bf16 instead (one part) moves more than 10% of them."""
    monkeypatch.setattr(layers, "_mm_f32",
                        lambda x, y: torch.bmm(x.float(), y.float()))
    gen = torch.Generator().manual_seed(0)
    x0 = torch.randn(4, 16, 256, generator=gen).to(torch.bfloat16)
    w0 = (torch.randn(256, 512, generator=gen) / 16).to(torch.bfloat16)
    split = layers._split_bf16

    def grads(route):
        x = x0.clone().requires_grad_(True)
        w = w0.clone().requires_grad_(True)
        if route:
            y = einsum_via("bsd,df->bsf", x, w, layers._mm_f32_autograd)
        else:
            y = torch.einsum("bsd,df->bsf", x.float(), w.float())
        (y.square().sum() * 0.5).backward()
        assert x.grad.dtype == w.grad.dtype == torch.bfloat16
        return x.grad.float(), w.grad.float()
    want = grads(False)
    for got, up in zip(grads(True), want):
        d = (got - up).abs()
        tol = 2.0 ** -7 * up.abs() + 2.0 ** -16 * up.abs().max()
        assert bool(d.le(tol).all())
        assert float(d.gt(0).float().mean()) < 0.01
    monkeypatch.setattr(layers, "_split_bf16", lambda x: split(x)[:1])
    for got, up in zip(grads(True), want):
        assert float((got != up).float().mean()) > 0.1


def test_split_bf16_is_exact():
    """Three bf16 parts hold every float32 exactly (24 significant bits),
    over the whole exponent range the products meet."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(4096, generator=gen) \
        * torch.exp2(torch.randint(-60, 60, (4096,), generator=gen).float())
    parts = layers._split_bf16(x)
    assert all(p.dtype == torch.bfloat16 for p in parts)
    total = parts[0].float() + parts[1].float() + parts[2].float()
    assert torch.equal(total, x)
