"""AdamW over trees of tensors (the port of the JAX package's
``optim/adamw.py``).

The update math is float32 whatever the parameter and moment dtypes;
``moment_dtype="bfloat16"`` halves optimizer memory.  Unlike the JAX
package's functional update, :func:`adamw_update` writes the new
parameters and moments into the given tensors in place (one leaf at a
time, so no second copy of the state is ever held): a parameter keeps its
identity, and with it a tied alias and the Kishu co-variable it belongs
to.  Scalars (the learning rate, the bias corrections) are float32 tensors,
as the JAX package's are float32 arrays.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List

import torch
from torch.distributed.tensor import DTensor

from repro_torch.core.serialize import torch_dtype


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """Leaves in sorted-key order (the order JAX flattens a dict)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def _zeros_like(p: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Zeros of ``p``'s shape in ``dt``; a DTensor's moments inherit its
    mesh and placements (the JAX package's moments inherit the parameter
    sharding through the same tree paths)."""
    if isinstance(p, DTensor):
        return torch.zeros_like(p, dtype=dt)
    return torch.zeros(p.shape, dtype=dt, device=p.device)


def adamw_init(params: Any, cfg: AdamWConfig) -> Dict[str, Any]:
    dt = torch_dtype(cfg.moment_dtype)
    zeros = lambda p: _zeros_like(p, dt)
    leaves = [x.to_local() if isinstance(x, DTensor) else x
              for x in tree_leaves(params)]
    device = leaves[0].device if leaves else None
    return {
        "mu": tree_map(zeros, params),
        "nu": tree_map(zeros, params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: Any) -> torch.Tensor:
    sq = [x.float().square().sum() for x in tree_leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum())


@torch.no_grad()
def adamw_update(grads: Any, opt_state: Dict[str, Any], params: Any,
                 cfg: AdamWConfig, lr=None) -> Dict[str, torch.Tensor]:
    """One AdamW step, in place on ``params`` and ``opt_state`` (the
    moments and ``count``).  ``lr`` may change from step to step (a Kishu
    hparam leaf); it defaults to ``cfg.lr``.  Every leaf with ``ndim >= 2``
    is decayed — with stacked units that includes the per-layer norm
    scales ``[n_units, d]`` but not ``final_norm/scale``.  Returns the
    metrics: ``{"grad_norm": ...}`` of the unclipped gradients."""
    count = opt_state["count"]
    device = count.device
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    lr = f32(cfg.lr if lr is None else lr)
    count.add_(1)
    t = count.float()
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0) \
        if cfg.grad_clip > 0 else f32(1.0)
    if isinstance(clip, DTensor):   # the blocks below are local shards
        clip = clip.full_tensor()
    bc1 = 1 - torch.pow(f32(cfg.b1), t)
    bc2 = 1 - torch.pow(f32(cfg.b2), t)
    decay = 1 - lr * cfg.weight_decay

    def upd_block(g, mu, nu, p, decayed: bool):
        g32 = g.float() * clip
        mu32 = mu.float() * cfg.b1 + g32 * (1 - cfg.b1)
        nu32 = nu.float() * cfg.b2 + g32.square() * (1 - cfg.b2)
        step = (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + cfg.eps)
        p32 = p.float()
        if decayed:
            p32 = p32 * decay
        p.copy_(p32 - lr * step)
        mu.copy_(mu32)
        nu.copy_(nu32)

    def upd(g, mu, nu, p):
        decayed = p.ndim >= 2   # decay matrices only (norms/scalars exempt)
        for block in _blocks(g, mu, nu, p):
            upd_block(*block, decayed)

    tree_map(upd, grads, opt_state["mu"], opt_state["nu"], params)
    return {"grad_norm": gnorm}


# elements a step of the update takes at once: its float32 temporaries
# (about eight of them) stay near 2 GiB however large the leaf
UPDATE_BLOCK = 1 << 26


def _blocks(g, mu, nu, p):
    """``(g, mu, nu, p)`` cut into matching flat blocks of at most
    :data:`UPDATE_BLOCK` elements, for an elementwise update that writes
    ``mu``, ``nu`` and ``p`` in place.  DTensors of one placement (the
    gradient is redistributed to its parameter's, the moments share it)
    give their local shards, on which an elementwise op is what DTensor
    would run.  The JAX package's update is fused by XLA and holds no
    float32 copy of a leaf; the blocks bound the port's.  A leaf that is
    not contiguous, or DTensors placed unalike, go whole."""
    xs = (g, mu, nu, p)
    if all(isinstance(x, DTensor) for x in xs) and len(
            {(x.device_mesh, tuple(x.placements)) for x in xs}) == 1:
        xs = tuple(x.to_local() for x in xs)
    n = xs[3].numel()
    if n <= UPDATE_BLOCK or any(isinstance(x, DTensor) for x in xs) \
            or not all(x.is_contiguous() for x in xs[1:]):
        return [xs]
    flat = (xs[0].reshape(-1),) + tuple(x.view(-1) for x in xs[1:])
    return [tuple(x[lo:lo + UPDATE_BLOCK] for x in flat)
            for lo in range(0, n, UPDATE_BLOCK)]
