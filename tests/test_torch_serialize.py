"""Leaf serialization of the port held against the JAX package: for the same
state, leaf bytes and metas are identical (the ``"bfloat16"`` dtype string
and the ``"jax": true`` device-leaf flag included), view specs read the same,
and a JAX-written PRNG key leaf loads as its key-data tensor."""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import serialize as jser  # noqa: E402
from repro_torch.core import serialize as tser  # noqa: E402
from repro_torch.interop import array_to_tensor  # noqa: E402

DEVICE_DTYPES = ["float32", "bfloat16", "float16", "int32", "uint32", "int16",
                 "uint16", "int8", "uint8", "bool", "float8_e4m3fn",
                 "float8_e5m2", "complex64"]


def _array(dtype, shape=(3, 11), seed=0):
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    if dtype == "bool":
        return (rng.random(n) < 0.5).reshape(shape)
    if dtype.startswith(("int", "uint")):
        return rng.integers(0, 100, n).astype(dtype).reshape(shape)
    if dtype == "complex64":
        return (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
            .astype(np.complex64).reshape(shape)
    return rng.standard_normal(n).astype(jnp.dtype(dtype)).reshape(shape)


@pytest.mark.parametrize("dtype", DEVICE_DTYPES)
@pytest.mark.parametrize("shape", [(3, 11), (7,), ()])
def test_device_leaf_bytes_and_meta_match(dtype, shape):
    a = _array(dtype, shape)
    jb, jm = jser.leaf_to_bytes(jnp.asarray(a))
    t = array_to_tensor(a, "cpu")
    tb, tm = tser.leaf_to_bytes(t)
    assert tb == jb and tm == jm
    assert tm["jax"] is True and tm["dtype"] == dtype
    assert tser.leaf_nbytes(t) == jser.leaf_nbytes(jnp.asarray(a))
    back = tser.leaf_from_bytes(jb, jm, device=torch.device("cpu"))
    assert isinstance(back, torch.Tensor) and back._base is None
    assert tser.leaf_to_bytes(back) == (jb, jm)


@pytest.mark.parametrize("dtype", ["float32", "int64", "float64", "uint64",
                                   "bool"])
def test_host_leaf_matches(dtype):
    a = _array(dtype)
    assert tser.leaf_to_bytes(a) == jser.leaf_to_bytes(a)
    b, m = tser.leaf_to_bytes(a)
    assert m["jax"] is False
    back = tser.leaf_from_bytes(b, m, device=torch.device("cpu"))
    assert isinstance(back, np.ndarray) and back.tobytes() == a.tobytes()


def test_object_and_opaque_leaves():
    for obj in (3, 2.5, "x", (1, "a"), {"k": [1, 2]}):
        assert tser.leaf_to_bytes(obj) == jser.leaf_to_bytes(obj)
        b, m = tser.leaf_to_bytes(obj)
        assert tser.leaf_from_bytes(b, m) == obj
    with pytest.raises(tser.SerializationError):
        tser.leaf_to_bytes(tser.OpaqueLeaf(payload=1))


def test_jax_prng_leaf_loads_as_key_data():
    key = jax.random.key(42)
    data, meta = jser.leaf_to_bytes(key)
    assert meta["kind"] == "prng"
    t = tser.leaf_from_bytes(data, meta, device=torch.device("cpu"))
    want = np.asarray(jax.random.key_data(key))
    assert isinstance(t, torch.Tensor)
    assert tser.dtype_name(t.dtype) == str(want.dtype)
    assert t.view(torch.int32).numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("index", [
    (slice(2, 5), slice(None, None, 2)), (slice(None), 3), (4,),
    (slice(1, 9, 3), slice(1, 7))])
def test_view_spec_matches_numpy(index):
    base_np = np.arange(80, dtype=np.float32).reshape(10, 8)
    base_t = torch.arange(80, dtype=torch.float32).reshape(10, 8).clone()
    v_np, v_t = base_np[index], base_t[index]
    spec_t = tser.view_spec(v_t, tser.base_of(v_t))
    assert tser.base_of(v_t) is base_t
    assert spec_t == jser.view_spec(v_np, jser.base_of(v_np))
    rebuilt = tser.view_from_base(base_t, spec_t)
    assert torch.equal(rebuilt, v_t)
    assert rebuilt.data_ptr() == v_t.data_ptr()


def test_alias_key_follows_storage():
    a = torch.zeros(100)
    v = a[10:20]
    d = a.detach()                      # same storage, no _base
    other = torch.zeros(100)
    assert tser.alias_key(tser.base_of(v)) == tser.alias_key(a)
    assert tser.alias_key(d) == tser.alias_key(a)
    assert tser.alias_key(other) != tser.alias_key(a)
    e1, e2 = torch.zeros(0), torch.zeros(0)
    assert tser.alias_key(e1) != tser.alias_key(e2)


def test_unsupported_dtype_name_raises():
    with pytest.raises(tser.SerializationError):
        tser.torch_dtype("not_a_dtype")
