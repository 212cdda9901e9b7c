"""Carry a session state between the two packages.

The JAX package's state becomes a tree of numpy arrays through
``np.asarray``; :func:`to_torch` turns such a tree into torch tensors on a
device and :func:`to_numpy` turns tensors back, so both packages can
commit the same state.  :func:`train_state_to_torch` does so for the JAX
package's TrainState, so the port's trainer can start from exactly the
JAX package's initialised parameters; :func:`to_torch` carries a JAX
cache tree (``lm.init_caches`` or ``decode_step`` output, int32
``index`` leaves included) to the port's layout the same way.  The device is ``cuda`` unless the caller names
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


_TRAIN_STATE_KEYS = {"params", "opt", "step", "rng"}
_OPT_KEYS = {"mu", "nu", "count"}


def train_state_to_torch(state: Any, device: Optional[Device] = None
                         ) -> Any:
    """The JAX package's TrainState as a nested dict of numpy arrays
    (``np.asarray`` of every leaf of ``repro.train.step.init_train_state``
    or of a trained state) -> the port's TrainState on ``device``.

    Leaf names, the stacked ``[n_units]`` axis, shapes and dtypes are kept,
    and every leaf crosses as its raw bytes (bf16 through ``ml_dtypes`` as
    ``torch.bfloat16``, ``rng`` as uint32), so the port then computes from
    exactly the same state."""
    if not isinstance(state, dict) or set(state) != _TRAIN_STATE_KEYS \
            or not isinstance(state["opt"], dict) \
            or set(state["opt"]) != _OPT_KEYS:
        raise ValueError("not a TrainState: want keys params/opt/step/rng "
                         "with opt = mu/nu/count")
    out = to_torch(state, device)
    bad = [k for k in ("step", "rng") if not isinstance(out[k],
                                                        torch.Tensor)]
    if bad:
        raise ValueError(f"TrainState leaves {bad} are not arrays")
    return out
