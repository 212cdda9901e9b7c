"""The port's Mamba-2/SSD layer held against the JAX package's, function by
function, on the CPU: reduced ``mamba2-780m`` (1 group) and reduced
``jamba-1.5-large-398b`` (2 groups), chunk 8.

Parameters come from the JAX package's initialiser and cross as raw bytes
(``interop.to_torch``); inputs are made from numpy seeds.  float32
tolerance: atol 5e-5 / rtol 1e-4, the JAX package's own SSD test's (the
chunked and sequential forms, and the two frameworks, sum in different
orders); the conv within 1e-6, the head broadcast bit-equal.  bf16:
atol 3e-2, since bf16 rounds each cast to 8 bits of mantissa.  Gradients:
atol 1e-4 / rtol 1e-3 (a backward pass sums more terms).
"""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.models import mamba as jm  # noqa: E402
from repro.models.config import get_config as jget  # noqa: E402
from repro.models.testing import reduced as jreduced  # noqa: E402

from repro_torch.core.serialize import dtype_name  # noqa: E402
from repro_torch.interop import to_torch  # noqa: E402
from repro_torch.models import mamba as tm  # noqa: E402
from repro_torch.models.config import get_config as tget  # noqa: E402
from repro_torch.models.testing import reduced as treduced  # noqa: E402

ARCHS = ["mamba2-780m", "jamba-1.5-large-398b"]
TOL = dict(atol=5e-5, rtol=1e-4)
GRAD = dict(atol=1e-4, rtol=1e-3)


def _cfgs(arch, **kw):
    return jreduced(jget(arch)).replace(**kw), \
        treduced(tget(arch)).replace(**kw)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


def _ssd_inputs(b, s, h, p, n, seed, dt_scale=1.0):
    """x, dt (post-softplus), a (negative), B, C, D as float32 numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    dt = np.log1p(np.exp(f(b, s, h))) * dt_scale
    return (f(b, s, h, p), dt.astype(np.float32),
            -np.exp(f(h) * 0.5), f(b, s, h, n) * 0.5, f(b, s, h, n) * 0.5,
            f(h))


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


def _t(arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _layer(arch, seed=0, dtype=jnp.float32):
    jc, tc = _cfgs(arch)
    jp = jm.ssm_init(jax.random.key(seed), jc, dtype)
    return jc, tc, jp, to_torch(jax.tree.map(np.asarray, jp), "cpu")


# ---------------------------------------------------------------------------
# init, conv, head broadcast
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_init_layout(arch, dtype):
    jc, tc = _cfgs(arch, dtype=dtype)
    want = jax.tree.map(np.asarray, jm.ssm_init(jax.random.key(0), jc,
                                                jnp.dtype(dtype)))
    got = tm.ssm_init(torch.Generator().manual_seed(0), tc,
                      getattr(torch, dtype), lead=(3,))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]["scale"] if name == "norm" else got[name]
        w = w["scale"] if name == "norm" else w
        assert tuple(g.shape) == (3, *w.shape), name
        assert dtype_name(g.dtype) == str(w.dtype), name
    for name in ("dt_bias", "A_log", "D"):
        assert got[name].dtype == torch.float32
        assert np.array_equal(_np(got[name][0]), want[name]), name
    assert tm._dims(tc)[1:] == jm._dims(jc)[1:]


@pytest.mark.parametrize("width,dtype", [(4, np.float32), (2, np.float32),
                                         (4, "bfloat16")])
def test_causal_conv(width, dtype):
    rng = np.random.default_rng(width)
    u = rng.standard_normal((2, 11, 24)).astype(np.float32)
    w = (rng.standard_normal((width, 24)) * 0.3).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    if dtype == "bfloat16":
        want = jm.causal_conv(*(jnp.asarray(a, jnp.bfloat16)
                                for a in (w, b, u)))
        got = tm.causal_conv(*(torch.from_numpy(a).bfloat16()
                               for a in (w, b, u)))
        assert got.dtype == torch.bfloat16
        _close(got, want, atol=3e-2, rtol=0)
    else:
        want = jm.causal_conv(jnp.asarray(w), jnp.asarray(b), jnp.asarray(u))
        got = tm.causal_conv(*_t([w, b, u]))
        _close(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("heads,groups", [(8, 1), (8, 2), (6, 3)])
def test_groups_to_heads_bit_equal(heads, groups):
    t = np.random.default_rng(0).standard_normal(
        (2, 5, groups * 4)).astype(np.float32)
    want = np.asarray(jm._groups_to_heads(jnp.asarray(t), heads, groups))
    got = tm._groups_to_heads(torch.from_numpy(t), heads, groups).numpy()
    assert got.shape == want.shape == (2, 5, heads, 4)
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# the SSD core
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [8, 16, 32, 64])
def test_ssd_chunked_matches_jax_and_the_recurrence(chunk):
    arrs = _ssd_inputs(2, 64, 4, 8, 16, seed=chunk)
    yj, sj = jm.ssd_chunked(*_j(arrs), chunk)
    yt, st = tm.ssd_chunked(*_t(arrs), chunk)
    assert yt.dtype == torch.float32 and st.dtype == torch.float32
    _close(yt, yj)
    _close(st, sj)
    yr, sr = tm.ssd_reference(*_t(arrs))
    _close(yt, yr)
    _close(st, sr)
    yjr, sjr = jm.ssd_reference(*_j(arrs))
    _close(yr, yjr)
    _close(sr, sjr)


def test_ssd_initial_state_threading():
    arrs = _ssd_inputs(1, 32, 2, 4, 8, seed=3)
    x, dt, a, b, c, d = _t(arrs)
    y_full, s_full = tm.ssd_chunked(x, dt, a, b, c, d, 8)
    y1, s1 = tm.ssd_chunked(x[:, :16], dt[:, :16], a, b[:, :16], c[:, :16],
                            d, 8)
    y2, s2 = tm.ssd_chunked(x[:, 16:], dt[:, 16:], a, b[:, 16:], c[:, 16:],
                            d, 8, initial_state=s1)
    _close(torch.cat([y1, y2], 1), y_full)
    _close(s2, s_full)
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        tm.ssd_chunked(x[:, :12], dt[:, :12], a, b[:, :12], c[:, :12], d, 8)


def test_ssd_decode_step_matches_jax():
    rng = np.random.default_rng(4)
    state = rng.standard_normal((2, 4, 8, 16)).astype(np.float32)
    x, dt, a, b, c, d = _ssd_inputs(2, 1, 4, 8, 16, seed=5)
    step = [state, x[:, 0], dt[:, 0], a, b[:, 0], c[:, 0], d]
    yj, sj = jm.ssd_decode_step(*_j(step))
    ts = _t(step)
    yt, st = tm.ssd_decode_step(*ts)
    _close(yt, yj, atol=1e-5, rtol=1e-5)
    _close(st, sj, atol=1e-5, rtol=1e-5)
    assert torch.equal(ts[0], torch.from_numpy(state))  # state not written


def test_ssd_gradient_finite_where_the_reference_overflows():
    """At mamba2-780m's chunk (256) with the cumulative decay of a chunk
    past 88, the JAX package's ``exp`` before the mask overflows and its
    gradient w.r.t. ``dt`` is not finite; the port masks first, and its
    gradient is finite.  Both forwards agree."""
    arrs = _ssd_inputs(1, 256, 2, 4, 8, seed=6, dt_scale=2.0)
    assert float((arrs[1] * -arrs[2]).sum(1).min()) > 88.0
    jx, jdt, ja, jb, jc, jd = _j(arrs)
    jgrad = jax.grad(lambda t: jm.ssd_chunked(jx, t, ja, jb, jc, jd,
                                              256)[0].sum())(jdt)
    assert not bool(jnp.isfinite(jgrad).all())
    x, dt, a, b, c, d = _t(arrs)
    dt.requires_grad_(True)
    y, _ = tm.ssd_chunked(x, dt, a, b, c, d, 256)
    y.sum().backward()
    assert bool(torch.isfinite(dt.grad).all())
    _close(y, jm.ssd_chunked(jx, jdt, ja, jb, jc, jd, 256)[0], atol=1e-4,
           rtol=1e-4)


@pytest.mark.parametrize("wrt", [1, 3, 0])
def test_ssd_gradient_matches_jax_at_chunk_8(wrt):
    """w.r.t. dt, B and x: where the reference is finite, the gradients
    agree."""
    arrs = _ssd_inputs(2, 32, 3, 4, 8, seed=7)
    js = _j(arrs)

    def jloss(t):
        args = list(js)
        args[wrt] = t
        return (jm.ssd_chunked(*args, 8)[0] ** 2).sum()
    want = jax.grad(jloss)(js[wrt])
    ts = _t(arrs)
    ts[wrt].requires_grad_(True)
    (tm.ssd_chunked(*ts, 8)[0] ** 2).sum().backward()
    _close(ts[wrt].grad, want, **GRAD)


# ---------------------------------------------------------------------------
# the layer: full sequence and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_forward_matches_jax(arch):
    jc, tc, jp, tp = _layer(arch)
    x = np.random.default_rng(8).standard_normal(
        (2, 16, jc.d_model)).astype(np.float32)
    _close(tm.ssm_forward(tp, tc, torch.from_numpy(x)),
           jm.ssm_forward(jp, jc, jnp.asarray(x)))


def test_ssm_forward_bf16():
    jc, tc = _cfgs("mamba2-780m", dtype="bfloat16")
    jp = jm.ssm_init(jax.random.key(1), jc, jnp.bfloat16)
    tp = to_torch(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(9).standard_normal(
        (2, 16, jc.d_model)).astype(np.float32)
    got = tm.ssm_forward(tp, tc, torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    _close(got, jm.ssm_forward(jp, jc, jnp.asarray(x, jnp.bfloat16)),
           atol=3e-2, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_decode_matches_jax_in_place(arch):
    """Ten decode steps: outputs and both cache leaves against the JAX
    package's; the port's cache tensors keep their storage (the step
    writes them in place) and the state stays float32."""
    jc, tc, jp, tp = _layer(arch, seed=2)
    xs = np.random.default_rng(10).standard_normal(
        (10, 2, 1, jc.d_model)).astype(np.float32)
    jcache = jm.ssm_cache_init(jc, 2, jnp.float32)
    tcache = tm.ssm_cache_init(tc, 2, torch.float32, "cpu")
    ptrs = {k: v.data_ptr() for k, v in tcache.items()}
    for x in xs:
        yj, jcache = jm.ssm_decode(jp, jc, jnp.asarray(x), jcache)
        yt, out = tm.ssm_decode(tp, tc, torch.from_numpy(x), tcache)
        assert out is tcache
        _close(yt, yj)
    assert {k: v.data_ptr() for k, v in tcache.items()} == ptrs
    assert tcache["state"].dtype == torch.float32
    for k in ("conv", "state"):
        assert tuple(tcache[k].shape) == jcache[k].shape
        _close(tcache[k], jcache[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_forward_equals_its_decode_loop(arch):
    """The chunked prefill and the recurrent decode of the port agree
    step by step (the JAX package's consistency, float32)."""
    _, tc, _, tp = _layer(arch, seed=3)
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (2, 16, tc.d_model)).astype(np.float32))
    full = tm.ssm_forward(tp, tc, x)
    cache = tm.ssm_cache_init(tc, 2, torch.float32, "cpu")
    steps = [tm.ssm_decode(tp, tc, x[:, t:t + 1], cache)[0]
             for t in range(16)]
    _close(torch.cat(steps, 1), full)


def test_mamba2_780m_full_size_shapes():
    """The published widths, and the serving cell's cache bytes at batch
    8: state [48, 8, 48, 64, 128] float32 and conv [48, 8, 3, 3328] bf16
    (on the meta device: nothing is allocated)."""
    cfg = tget("mamba2-780m")
    s, d_in, n_heads, conv_ch = tm._dims(cfg)
    assert (cfg.n_layers, cfg.d_model, d_in, n_heads, s.head_dim,
            s.d_state, conv_ch, s.chunk_size) == \
        (48, 1536, 3072, 48, 64, 128, 3328, 256)
    assert cfg.rope_type == "none" and cfg.tie_embeddings
    sub = tm.ssm_cache_init(cfg, 8, torch.bfloat16, "meta", lead=(48,))
    assert tuple(sub["state"].shape) == (48, 8, 48, 64, 128)
    assert sub["state"].nbytes == 603_979_776
    assert tuple(sub["conv"].shape) == (48, 8, 3, 3328)
    assert sub["conv"].dtype == torch.bfloat16
    assert sub["conv"].nbytes == 7_667_712
    assert abs(cfg.param_counts()["total"] - 780e6) < 10e6
