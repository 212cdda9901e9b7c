"""The port's decode step as the graphed server calls it, on the CPU, held
against the eager step and the JAX package's teacher-forced decode.

- ``layers.rope_table`` (the RoPE frequencies copied to the device once)
  gives ``apply_rope`` output bit-identical to frequencies built per call;
- ``lm.decode_step`` with a static 0-d int32 index tensor (what the CUDA
  graph reads) equals the Python-int path bit for bit, and the JAX decode
  within the serving tests' float32 tolerance (logits atol 1e-4 / rtol
  1e-4, cache K/V atol 1e-5 / rtol 1e-4: the two frameworks sum products
  in different orders);
- ``GraphedDecodeStep`` on CPU tensors runs the eager step: its tokens,
  logits and caches equal ``make_decode_step``'s bit for bit, and it never
  captures.

The CUDA graph itself is held against the eager step on the card
(``test_torch_cuda.py``).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.models import lm as jlm  # noqa: E402
from repro.models.config import get_config as jget  # noqa: E402
from repro.models.testing import reduced as jreduced  # noqa: E402
from repro_torch.interop import to_numpy, to_torch  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.config import get_config as tget  # noqa: E402
from repro_torch.models.testing import reduced as treduced  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

ARCHS = ["smollm-360m", "qwen3-1.7b"]
LOGITS = dict(atol=1e-4, rtol=1e-4)
KV = dict(atol=1e-5, rtol=1e-4)


def _cfgs(arch, **kw):
    return jreduced(jget(arch)).replace(**kw), \
        treduced(tget(arch)).replace(**kw)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _rope_per_call(x, positions, theta):
    """``apply_rope`` as it was, building the frequencies on every call."""
    hd = x.shape[-1]
    freqs = torch.tensor(tlayers.rope_frequencies(hd, theta),
                         dtype=torch.float32, device=x.device)
    ang = positions[..., None].float() * freqs
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,theta", [(64, 10000.0), (128, 1e6), (16, 500.0)])
def test_rope_table_is_bit_identical(dtype, hd, theta):
    g = torch.Generator().manual_seed(hd)
    x = torch.randn((3, 7, 4, hd), generator=g).to(dtype)
    pos = torch.randint(0, 4096, (3, 7), generator=g, dtype=torch.int32)
    table = tlayers.rope_table(hd, theta, x.device)
    assert table.dtype == torch.float32 and table.shape == (hd // 2,)
    assert torch.equal(table, torch.tensor(
        tlayers.rope_frequencies(hd, theta), dtype=torch.float32))
    assert tlayers.rope_table(hd, theta, x.device) is table   # made once
    got = tlayers.apply_rope(x, pos, theta)
    want = _rope_per_call(x, pos, theta)
    assert got.dtype == dtype and torch.equal(got, want)


def _caches_equal(a, b):
    return all(torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


@pytest.mark.parametrize("arch", ARCHS)
def test_static_index_tensor_matches_int_and_jax(arch):
    jc, tc = _cfgs(arch)
    jp = jlm.init_params(jc, jax.random.key(0))
    tp = to_torch(jax.tree.map(np.asarray, jp), "cpu")
    toks = _tokens(jc, 2, 9, seed=2)
    jcache = jlm.init_caches(jc, 2, 12)
    c_int = tlm.init_caches(tc, 2, 12, device="cpu")
    c_static = tlm.init_caches(tc, 2, 12, device="cpu")
    index = torch.zeros((), dtype=torch.int32)         # the graph's buffer
    for t in range(9):
        tok = torch.from_numpy(toks[:, t:t + 1].copy())
        jl, jcache = jlm.decode_step(
            jc, jp, jcache, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                             "index": jnp.asarray(t, jnp.int32)})
        with torch.no_grad():
            l_int, _ = tlm.decode_step(tc, tp, c_int,
                                       {"tokens": tok, "index": t})
            index.fill_(t)
            l_static, _ = tlm.decode_step(tc, tp, c_static,
                                          {"tokens": tok, "index": index})
        assert torch.equal(l_static, l_int), t
        assert _caches_equal(c_static, c_int), t
        np.testing.assert_allclose(l_static.float().numpy(),
                                   np.asarray(jl, np.float32), **LOGITS)
    want = jax.tree.map(np.asarray, jcache)
    got = to_numpy(c_static)
    for w, g in zip(jax.tree.leaves(want), tree_leaves(got)):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == np.int32:                          # index leaves
            assert g.tobytes() == w.tobytes()
        else:
            np.testing.assert_allclose(g, w, **KV)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graphed_step_on_the_cpu_is_the_eager_step(dtype):
    _, tc = _cfgs("smollm-360m", dtype=dtype)
    tp = tlm.init_params(tc, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(tc, 3, 6, seed=4))
    eager = tstep.make_decode_step(tc)
    graphed = tstep.GraphedDecodeStep(tc)
    ce, cl, cg = (tlm.init_caches(tc, 3, 10, device="cpu")
                  for _ in range(3))
    tok = toks[:, :1]
    for t in range(9):
        batch = {"tokens": tok, "index": t}
        ne, ce2 = eager(tp, ce, batch)
        with torch.no_grad():
            want, _ = tlm.decode_step(tc, tp, cl, batch)
        if t % 2:
            ng, cg2 = graphed(tp, cg, batch)
        else:
            lg, ng, cg2 = graphed.with_logits(tp, cg, batch)
            assert lg.dtype == torch.float32 and torch.equal(lg, want), t
        assert ce2 is ce and cg2 is cg                  # updated in place
        assert ng.dtype == torch.int32 and tuple(ng.shape) == (3, 1)
        assert torch.equal(ng, ne), t
        assert _caches_equal(cg, ce) and _caches_equal(cg, cl), t
        tok = toks[:, t + 1:t + 2] if t + 1 < 6 else ne
    assert graphed.captures == 0 and graphed.capture_s == 0.0
