"""Use-time layouts for layers whose sharding the rules alone leave open:
the port of the JAX package's ``sharding/context.py``.

The MoE expert products with pod-sharded weights have two resolutions:
reduce the [E, capacity, d_ff] outputs across ranks, or gather the
weights (ZeRO-style) first.  ``moe_weight_gather`` installs layouts that
``models.moe.moe_forward`` applies to the expert weights at use time —
a ``redistribute`` to the dispatch layout (expert dim over data, ff over
model, d_model whole) — while the *persistent* weights stay pod-sharded;
with ``moe_dispatch_shard`` the dispatch buffers are constrained to
expert-sharded layouts too.

A layout is ``(mesh, placements)``.  :func:`constrain` applies one: a
DTensor is redistributed to it, a plain tensor passes unchanged, so the
single-device path does exactly what it does without a context.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.sharding.rules import Spec

Layout = Tuple[Any, tuple]            # (DeviceMesh, placements)

_MOE_WEIGHT_LAYOUTS: contextvars.ContextVar = contextvars.ContextVar(
    "moe_weight_layouts", default=None)


def constrain(x: torch.Tensor, layout: Optional[Layout]) -> torch.Tensor:
    """``x`` redistributed to ``layout`` when it is a DTensor; else ``x``
    (the JAX package's ``with_sharding_constraint``)."""
    if layout is None or not isinstance(x, DTensor):
        return x
    mesh, placements = layout
    if tuple(x.placements) == tuple(placements) and x.device_mesh == mesh:
        return x
    return x.redistribute(mesh, placements)


def get_moe_weight_shardings() -> Optional[Tuple[Optional[Layout], ...]]:
    """(w_gate, w_up, w_down, dispatch buffer, hidden) layouts inside a
    :func:`moe_weight_gather` context, else ``None``."""
    return _MOE_WEIGHT_LAYOUTS.get()


@contextlib.contextmanager
def moe_weight_gather(rules):
    """Within this context ``moe_forward`` redistributes the expert weights
    to the dispatch layout (expert dim over data, ff over model, d_model
    replicated) before the expert products (``expert_fsdp_pod``); with
    ``moe_dispatch_shard`` the dispatch buffer and the hidden [E, cap, f]
    activations are constrained to expert-sharded layouts."""
    gather = getattr(rules, "expert_fsdp_pod", False)
    dispatch = getattr(rules, "moe_dispatch_shard", False)
    if not gather and not dispatch:
        yield
        return
    e, m = rules.data_axis, rules.model_axis

    def lay(spec):
        return (rules.mesh, rules.placements(spec))
    # moe_forward sees the per-unit slice [E, d, f] (the stacked n_units
    # dim is consumed by the loop over units)
    gate_up = lay(Spec(e, None, m)) if gather else None
    down = lay(Spec(e, m, None)) if gather else None
    buf = lay(Spec(e, None, None)) if dispatch else None
    hid = lay(Spec(e, None, m)) if dispatch else None
    token = _MOE_WEIGHT_LAYOUTS.set((gate_up, gate_up, down, buf, hid))
    try:
        yield
    finally:
        _MOE_WEIGHT_LAYOUTS.reset(token)
