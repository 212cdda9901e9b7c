"""The benchmark's weights: every leaf of a reference family's layout
drawn from the run's seed on the run's device, one call a stacked leaf,
in the dtype it is served in.  The same tensors go to the program and to
the reference."""
from __future__ import annotations

import math

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def _draw(shape, init: tuple, gen: torch.Generator) -> torch.Tensor:
    out = torch.empty(shape, dtype=torch.float32, device=gen.device)
    kind = init[0]
    if kind == "normal":
        return out.normal_(0.0, init[1], generator=gen)
    if kind == "uniform":
        return out.uniform_(init[1], init[2], generator=gen)
    if kind == "fan_in":
        bound = 1.0 / math.sqrt(init[1])
        return out.uniform_(-bound, bound, generator=gen)
    if kind == "const":
        return out.fill_(init[1])
    if kind == "a_log":                  # A uniform in [lo, hi]
        return out.uniform_(init[1], init[2], generator=gen).log_()
    if kind == "dt_bias":                # softplus^-1 of a log-uniform dt
        lo, hi = math.log(init[1]), math.log(init[2])
        dt = out.uniform_(lo, hi, generator=gen).exp_()
        return dt + torch.log(-torch.expm1(-dt))
    raise ValueError(f"unknown initialiser {init!r}")


def make(layout: dict, seed: int, device) -> dict:
    """The parameter tree of ``layout`` (name -> (shape, dtype, init),
    ``/``-separated names), drawn in name order from one generator."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    tree: dict = {}
    for name in sorted(layout):
        shape, dtype, init = layout[name]
        leaf = _draw(tuple(shape), tuple(init), gen).to(_DTYPES[dtype])
        node = tree
        *parents, last = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree
