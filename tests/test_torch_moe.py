"""The port's MoE layer held against the JAX package's on the CPU, at
reduced ``phi3.5-moe-42b-a6.6b`` (4 experts, top-2) and the reduced
shared-expert variant.

Parameters cross from the JAX package's initialiser as raw bytes; inputs
are made from numpy seeds.  The router's choices, the capacity and the
dispatch (``dest``, ``valid``) are bit-equal; float32 outputs atol 1e-5 /
rtol 1e-4 (the two frameworks sum products in different orders); the aux
loss rtol 1e-6.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402
from repro.models.config import MoEConfig as JMoE  # noqa: E402
from repro.models.config import get_config as jget  # noqa: E402
from repro.models.testing import reduced as jreduced  # noqa: E402

from repro_torch.core.serialize import dtype_name  # noqa: E402
from repro_torch.interop import to_torch  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.config import MoEConfig as TMoE  # noqa: E402
from repro_torch.models.config import get_config as tget  # noqa: E402
from repro_torch.models.testing import reduced as treduced  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-4)
ARCH = "phi3.5-moe-42b-a6.6b"


def _cfgs(**moe_kw):
    jc, tc = jreduced(jget(ARCH)), treduced(tget(ARCH))
    if moe_kw:
        jc = jc.replace(moe=dataclasses.replace(jc.moe, **moe_kw))
        tc = tc.replace(moe=dataclasses.replace(tc.moe, **moe_kw))
    return jc, tc


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _params(jc, seed=0):
    jp = jmoe.moe_init(jax.random.key(seed), jc, jnp.float32)
    return jp, to_torch(jax.tree.map(np.asarray, jp), "cpu")


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


@pytest.mark.parametrize("n_tokens,n_experts,top_k,cf", [
    (1, 16, 2, 1.25), (8, 16, 2, 1.25), (1024, 16, 2, 1.25),
    (4096, 16, 2, 1.25), (24, 4, 2, 0.5), (100, 256, 8, 1.0)])
def test_capacity(n_tokens, n_experts, top_k, cf):
    kw = dict(n_experts=n_experts, top_k=top_k, capacity_factor=cf)
    assert tmoe.capacity(n_tokens, TMoE(**kw)) == \
        jmoe.capacity(n_tokens, JMoE(**kw))


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_init_layout(shared, dtype):
    jc, tc = _cfgs(n_shared_experts=shared)
    want = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.key(0), jc,
                                                  jnp.dtype(dtype)))
    got = tmoe.moe_init(torch.Generator().manual_seed(0), tc,
                        getattr(torch, dtype), lead=(2,))

    def flat(t, p=""):
        out = {}
        for k, v in t.items():
            n = f"{p}/{k}" if p else k
            out.update(flat(v, n) if isinstance(v, dict) else {n: v})
        return out
    want, got = flat(want), flat(got)
    assert sorted(got) == sorted(want)
    assert ("shared/w_gate" in got) == bool(shared)
    for name, w in want.items():
        assert tuple(got[name].shape) == (2, *w.shape), name
        assert dtype_name(got[name].dtype) == str(w.dtype), name
    assert got["router"].dtype == torch.float32


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_route_matches_jax(seed):
    jc, tc = _cfgs()
    jp, tp = _params(jc, seed)
    x = _x((40, jc.d_model), seed + 10)
    jpb, jeb = jmoe.route(jp["router"], jnp.asarray(x), jc.moe)
    tpb, teb = tmoe.route(tp["router"], torch.from_numpy(x), tc.moe)
    assert teb.dtype == torch.int32 and tpb.dtype == torch.float32
    assert np.array_equal(teb.numpy(), np.asarray(jeb))
    np.testing.assert_allclose(tpb.numpy(), np.asarray(jpb), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("n_experts,cap", [(4, 8), (4, 3), (8, 1), (3, 40)])
def test_dispatch_indices_bit_equal(n_experts, cap):
    """A skewed assignment (expert 0 takes half) so that some experts
    overflow: the same slots, the same drops, the drop slot E*cap."""
    rng = np.random.default_rng(cap)
    top_e = np.where(rng.random((30, 2)) < 0.5, 0,
                     rng.integers(0, n_experts, (30, 2))).astype(np.int32)
    jd, jv = jmoe.dispatch_indices(jnp.asarray(top_e), n_experts, cap)
    td, tv = tmoe.dispatch_indices(torch.from_numpy(top_e), n_experts, cap)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert int((~tv).sum()) == int((td == n_experts * cap).sum())
    kept = td[tv].numpy()
    assert len(set(kept.tolist())) == len(kept)          # distinct slots


def test_drops_depend_on_routing_order_alone():
    """A stable sort by expert: among the assignments to one expert, the
    earliest (token-major, then k) keep the slots."""
    top_e = torch.tensor([[1, 0], [1, 2], [1, 0], [1, 3]], dtype=torch.int32)
    dest, valid = tmoe.dispatch_indices(top_e, 4, 2)
    assert valid.tolist() == [True, True, True, True, False, True, False,
                              True]
    assert dest.tolist() == [2, 0, 3, 4, 8, 1, 8, 6]


@pytest.mark.parametrize("cf,shared", [(8.0, 0), (0.5, 0), (0.25, 0),
                                       (0.5, 1)])
def test_moe_forward_matches_jax(cf, shared):
    """capacity_factor 8 drops nothing; 0.5 and 0.25 force drops."""
    jc, tc = _cfgs(capacity_factor=cf, n_shared_experts=shared)
    jp, tp = _params(jc, seed=3)
    x = _x((2, 12, jc.d_model), 4)
    want = jmoe.moe_forward(jp, jc, jnp.asarray(x))
    routes = []
    got = tmoe.moe_forward(tp, tc, torch.from_numpy(x), routes)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    t = 24
    cap = jmoe.capacity(t, jc.moe)
    _, top_e = jmoe.route(jp["router"], jnp.asarray(x.reshape(t, -1)), jc.moe)
    _, valid = jmoe.dispatch_indices(top_e, jc.moe.n_experts, cap)
    (experts, kept), = routes
    assert experts.dtype == torch.int32 and kept.dtype == torch.bool
    assert np.array_equal(experts.numpy(),
                          np.asarray(top_e).reshape(2, 12, 2))
    assert np.array_equal(kept.numpy(), np.asarray(valid).reshape(2, 12, 2))
    assert (int((~kept).sum()) > 0) == (cf < 1)


def test_moe_forward_bf16():
    jc, tc = _cfgs()
    jp = jmoe.moe_init(jax.random.key(5), jc, jnp.bfloat16)
    tp = to_torch(jax.tree.map(np.asarray, jp), "cpu")
    x = _x((2, 8, jc.d_model), 6)
    want = jmoe.moe_forward(jp, jc, jnp.asarray(x, jnp.bfloat16))
    got = tmoe.moe_forward(tp, tc, torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), atol=3e-2, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_aux_load_balance_loss(seed):
    jc, tc = _cfgs()
    jp, tp = _params(jc, seed)
    x = _x((64, jc.d_model), seed + 20)
    want = jmoe.aux_load_balance_loss(jp["router"], jnp.asarray(x), jc.moe)
    got = tmoe.aux_load_balance_loss(tp["router"], torch.from_numpy(x),
                                     tc.moe)
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_moe_gradients_match_jax():
    """The layer differentiates as the JAX package's does (router and
    expert weights), drops included."""
    jc, tc = _cfgs(capacity_factor=0.5)
    jp, tp = _params(jc, seed=7)
    x = _x((2, 12, jc.d_model), 8)
    jg = jax.grad(lambda p: (jmoe.moe_forward(p, jc, jnp.asarray(x)) ** 2)
                  .sum())(jp)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    (tmoe.moe_forward(leaves, tc, torch.from_numpy(x)) ** 2).sum().backward()
    for name in ("w_gate", "w_up", "w_down"):
        np.testing.assert_allclose(_np(leaves[name].grad), _np(jg[name]),
                                   atol=1e-5, rtol=1e-3, err_msg=name)
