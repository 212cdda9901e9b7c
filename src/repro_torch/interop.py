"""Carry a session state between the two packages.

The JAX package's state becomes a tree of numpy arrays through
``np.asarray``; :func:`to_torch` turns such a tree into torch tensors on a
device and :func:`to_numpy` turns tensors back, so both packages can
commit the same state.  The device is ``cuda`` unless the caller names
another, as for ``KishuSession``: with no card and no explicit ``"cpu"``
the call raises.  Dtypes numpy spells through ``ml_dtypes`` (bf16, fp8)
cross as raw bytes, never through a numpy cast.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from repro_torch.core.serialize import dtype_name, tensor_from_bytes
from repro_torch.core.session import resolve_device

Device = Union[str, torch.device]


def array_to_tensor(a: np.ndarray, device: Optional[Device] = None
                    ) -> torch.Tensor:
    """One numpy array -> a tensor with the same dtype, shape and bytes,
    owning its storage (no hidden ``_base`` to become its alias base)."""
    return tensor_from_bytes(np.ascontiguousarray(a), str(a.dtype), a.shape,
                             resolve_device(device))


def tensor_to_array(t: torch.Tensor) -> np.ndarray:
    """One tensor -> a numpy array with the same dtype, shape and bytes
    (a bf16/fp8 tensor needs ``ml_dtypes`` for numpy to name its dtype)."""
    raw = t.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy()
    return raw.view(np.dtype(dtype_name(t.dtype))).reshape(tuple(t.shape))


def to_torch(tree: Any, device: Optional[Device] = None) -> Any:
    """Nested dicts/lists of numpy arrays -> the same structure of tensors
    on ``device`` (``cuda`` by default); other leaves pass through."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    if isinstance(tree, np.ndarray):
        return array_to_tensor(tree, device)
    return tree


def to_numpy(tree: Any) -> Any:
    """Inverse of :func:`to_torch`."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tensor_to_array(tree)
    return tree
