"""Leaf serialization for session states — torch tensors and numpy arrays.

Exact, dtype-preserving byte views — no pickle for arrays, so roundtrips are
bit-exact by construction (the paper's "silent pickling errors" class cannot
occur for arrays; it is *simulated* via :class:`OpaqueLeaf` to exercise
fallback recomputation, mirroring generators/locks/remote handles in §5.1).

A leaf is one of:
  - ``torch.Tensor`` / ``np.ndarray`` -> raw bytes + (dtype, shape) meta
  - small python objects              -> pickled (scalars, tuples, strs)
  - ``OpaqueLeaf``                    -> SerializationError (unserializable)

Manifests are byte-identical to the ones the JAX package writes:

  - dtype strings are numpy's names (``"float32"``, ``"bfloat16"``,
    ``"float8_e4m3fn"`` …), built from this module's own torch<->name table
    so no ``ml_dtypes`` is needed to write or read a bf16/fp8 tensor;
  - the meta key ``"jax": true`` keeps its meaning "device-array leaf:
    restore onto the session's device".  A torch tensor writes it, a numpy
    array writes ``false`` and restores as numpy — the same split the JAX
    package makes between ``jax.Array`` and ``np.ndarray``;
  - a ``"prng"`` leaf (a JAX typed key) loads as its raw key-data tensor.
    This package never writes one.

Aliasing follows storage: the *base* of a tensor is its ``_base`` (the
tensor it is a view of) or itself, and its alias key is the storage's
``data_ptr`` — two tensors over one storage are one co-variable, whatever
their Python identity (DESIGN.md §2's numpy-view semantics).
"""
from __future__ import annotations

import pickle
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch


class SerializationError(Exception):
    """Raised when a leaf cannot be serialized (paper §5.1: skip storage,
    fall back to recomputation at checkout)."""


class ChunkMissingError(Exception):
    """A chunk referenced by a manifest is absent/corrupt in the store."""


@dataclass
class OpaqueLeaf:
    """Simulates an unserializable object (generator, lock, GPU ipc handle).

    Carries a payload so fallback recomputation can be *verified* to rebuild
    the correct value; serialization of the leaf itself always fails.
    """
    payload: Any = None
    note: str = "unserializable"

    def __reduce__(self):
        raise SerializationError(f"OpaqueLeaf({self.note}) cannot be pickled")

    def __eq__(self, other):
        return isinstance(other, OpaqueLeaf) and other.payload == self.payload \
            and other.note == self.note


_DTYPE_NAMES: Dict[torch.dtype, str] = {
    torch.bool: "bool",
    torch.uint8: "uint8", torch.int8: "int8",
    torch.uint16: "uint16", torch.int16: "int16",
    torch.uint32: "uint32", torch.int32: "int32",
    torch.uint64: "uint64", torch.int64: "int64",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.float32: "float32", torch.float64: "float64",
    torch.complex64: "complex64", torch.complex128: "complex128",
    torch.float8_e4m3fn: "float8_e4m3fn", torch.float8_e5m2: "float8_e5m2",
}
_TORCH_DTYPES: Dict[str, torch.dtype] = {v: k for k, v in _DTYPE_NAMES.items()}


def dtype_name(dtype: Any) -> str:
    """numpy's name for a torch or numpy dtype (the manifest string)."""
    if isinstance(dtype, torch.dtype):
        try:
            return _DTYPE_NAMES[dtype]
        except KeyError:
            raise SerializationError(f"unsupported torch dtype {dtype}") \
                from None
    return str(np.dtype(dtype))


def torch_dtype(name: str) -> torch.dtype:
    """Inverse of :func:`dtype_name` for the dtypes torch has."""
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise SerializationError(f"no torch dtype for {name!r}") from None


def is_array_leaf(x: Any) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def base_of(x: Any) -> Any:
    """Ultimate base buffer of a (possibly viewed) array leaf."""
    if isinstance(x, np.ndarray):
        while isinstance(x.base, np.ndarray):
            x = x.base
        return x
    if isinstance(x, torch.Tensor) and x._base is not None:
        return x._base
    return x


def alias_key(base: Any) -> int:
    """Identity of a base buffer: the storage address for a tensor (views
    and storage-sharing tensors agree on it), ``id()`` otherwise.  An empty
    storage has no address, so it falls back to ``id()`` too."""
    if isinstance(base, torch.Tensor):
        st = base.untyped_storage()
        if st.nbytes() > 0:
            return int(st.data_ptr())
    return id(base)


def view_spec(x: Any, base: Any) -> Optional[dict]:
    """(offset, shape, strides, dtype) of x relative to base, or None if
    x *is* the base.  Offsets and strides are in bytes, as numpy's are, so
    a spec reads the same in both packages."""
    if x is base:
        return None
    if isinstance(x, torch.Tensor):
        if not isinstance(base, torch.Tensor):
            raise SerializationError("tensor view of a non-tensor base")
        item = x.element_size()
        return {"offset": int(x.data_ptr() - base.data_ptr()),
                "shape": list(x.shape),
                "strides": [int(s) * item for s in x.stride()],
                "dtype": dtype_name(x.dtype)}
    if not (isinstance(x, np.ndarray) and isinstance(base, np.ndarray)):
        raise SerializationError("view spec needs array leaves")
    off = x.__array_interface__["data"][0] - base.__array_interface__["data"][0]
    return {"offset": int(off), "shape": list(x.shape),
            "strides": list(x.strides), "dtype": str(x.dtype)}


def leaf_meta(x: Any) -> dict:
    if isinstance(x, torch.Tensor):
        return {"kind": "array", "dtype": dtype_name(x.dtype),
                "shape": list(x.shape), "jax": True}
    if isinstance(x, np.ndarray):
        dt = np.dtype(x.dtype)
        meta = {"kind": "array", "dtype": str(dt),
                "shape": list(x.shape), "jax": False}
        if dt.fields:                       # structured dtype: store descr
            meta["dtype_descr"] = [list(d) for d in dt.descr]
        return meta
    return {"kind": "object", "type": type(x).__name__}


def tensor_bytes_u8(t: torch.Tensor) -> torch.Tensor:
    """The C-order byte image of a tensor as a flat uint8 tensor on its own
    device (a view when ``t`` is contiguous, else one compacting copy)."""
    return t.reshape(-1).contiguous().view(torch.uint8)


def tensor_to_bytes(t: torch.Tensor) -> bytes:
    return tensor_bytes_u8(t).cpu().numpy().tobytes()


def leaf_to_bytes(x: Any) -> Tuple[bytes, dict]:
    """Serialize a *base* leaf. Raises SerializationError for opaque leaves."""
    meta = leaf_meta(x)
    if isinstance(x, torch.Tensor):
        return tensor_to_bytes(x), meta
    if meta["kind"] == "array":
        arr = x if x.flags["C_CONTIGUOUS"] else np.ascontiguousarray(x)
        return arr.tobytes(), meta
    if isinstance(x, OpaqueLeaf):
        raise SerializationError(f"OpaqueLeaf({x.note})")
    try:
        return pickle.dumps(x), meta
    except Exception as e:  # noqa: BLE001 — any pickling failure is EAFP
        raise SerializationError(str(e)) from e


def tensor_from_bytes(data, dtype: str, shape,
                      device: Union[str, torch.device]) -> torch.Tensor:
    """Rebuild a tensor from its byte image (bytes or a uint8 numpy array).
    The result owns its storage (no ``_base``), so it is its own alias base
    with exactly this dtype and shape; the bytes are copied in raw, so
    bf16/fp8 never pass through numpy."""
    out = torch.empty(list(shape), dtype=torch_dtype(dtype), device=device)
    raw = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) \
        else data.reshape(-1).view(np.uint8)
    if raw.size:
        tensor_bytes_u8(out).copy_(torch.from_numpy(raw.copy()))
    return out


def leaf_from_bytes(data: bytes, meta: dict, *,
                    device: Optional[torch.device] = None) -> Any:
    """Inverse of :func:`leaf_to_bytes`.  Device-array leaves (``"jax":
    true``, and JAX key data) become tensors on ``device``; with
    ``device=None`` they stay numpy, like every host array."""
    if meta["kind"] == "prng":
        if device is not None:
            return tensor_from_bytes(data, meta["dtype"], meta["shape"],
                                     device)
        return np.frombuffer(data, dtype=np.dtype(meta["dtype"])) \
            .reshape(meta["shape"]).copy()
    if meta["kind"] == "array":
        if meta.get("jax") and device is not None \
                and not meta.get("dtype_descr"):
            return tensor_from_bytes(data, meta["dtype"], meta["shape"],
                                     device)
        if meta.get("dtype_descr"):
            dt = np.dtype([tuple(d) for d in meta["dtype_descr"]])
        else:
            dt = np.dtype(meta["dtype"])
        return np.frombuffer(data, dtype=dt).reshape(meta["shape"]).copy()
    return pickle.loads(data)


def view_from_base(base: Any, spec: dict) -> Any:
    """Reconstruct a strided view into ``base`` (shared-reference restore)."""
    if isinstance(base, torch.Tensor):
        dt = torch_dtype(spec["dtype"])
        flat = tensor_bytes_u8(base)
        item = torch.empty((), dtype=dt).element_size()
        off, strides = int(spec["offset"]), [int(s) for s in spec["strides"]]
        if off % item or any(s % item for s in strides):
            raise SerializationError(
                f"view spec not aligned to {spec['dtype']}")
        typed = flat[: flat.numel() // item * item].view(dt)
        return torch.as_strided(typed, tuple(spec["shape"]),
                                tuple(s // item for s in strides),
                                off // item)
    flat = base.reshape(-1).view(np.uint8)
    dt = np.dtype(spec["dtype"])
    return np.lib.stride_tricks.as_strided(
        flat[spec["offset"]:].view(dt),
        shape=tuple(spec["shape"]), strides=tuple(spec["strides"]))


def leaf_nbytes(x: Any) -> int:
    if isinstance(x, torch.Tensor):
        return int(x.numel()) * x.element_size()
    if isinstance(x, np.ndarray):
        return int(np.dtype(x.dtype).itemsize
                   * int(np.prod(x.shape, dtype=np.int64)))
    try:
        return len(pickle.dumps(x))
    except Exception:  # noqa: BLE001
        return 0
