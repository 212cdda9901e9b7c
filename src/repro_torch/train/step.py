"""Step functions of the port (the JAX package's ``train/step.py``): loss,
gradients by autograd and the in-place AdamW step; prefill; and one-token
decode.

``train_step`` consumes a TrainState dict — exactly the tree the Kishu
session flattens into its namespace (params, AdamW moments, step, rng) —
and updates its tensors in place, so each keeps its identity (and the
tied embedding its alias) from one step to the next.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.core.session import resolve_device
from repro_torch.models import lm
from repro_torch.models.config import ArchConfig
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     tree_leaves, tree_map)

TrainState = Dict[str, Any]     # {"params", "opt", "step", "rng"}


def init_train_state(cfg: ArchConfig, seed: int, opt_cfg: AdamWConfig,
                     device: Union[str, torch.device, None] = None
                     ) -> TrainState:
    """A fresh state on ``device`` (``cuda`` unless the caller names
    another), parameters drawn from a ``torch.Generator`` seeded with
    ``seed``.  ``rng`` is the JAX package's ``key_data(key(0))``: two
    uint32 zeros, only ever stored and moved."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    params = lm.init_params(cfg, gen)
    return {
        "params": params,
        "opt": adamw_init(params, opt_cfg),
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "rng": torch.zeros((2,), dtype=torch.uint32, device=device),
    }


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  true_vocab: int) -> torch.Tensor:
    """Mean token cross-entropy; columns >= true_vocab are masked padding
    columns of the padded embedding table (set to -1e30)."""
    v = logits.shape[-1]
    if true_vocab < v:
        mask = torch.arange(v, device=logits.device) >= true_vocab
        logits = logits.masked_fill(mask, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (logz - gold).mean()


def make_loss_fn(cfg: ArchConfig, *, moe_aux_coef: float = 0.01):
    def loss_fn(params, batch):
        logits, aux = lm.forward(cfg, params, batch, training=True,
                                 return_aux=True)
        loss = cross_entropy(logits, batch["labels"], cfg.vocab_size)
        total = loss + moe_aux_coef * aux["moe_aux"]
        return total, {"loss": loss, "moe_aux": aux["moe_aux"]}
    return loss_fn


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, *,
                    microbatches: int = 1, moe_aux_coef: float = 0.01):
    """Returns ``train_step(state, batch, lr=None) -> (state, metrics)``;
    the returned state is ``state``, updated in place."""
    if microbatches != 1:
        raise NotImplementedError(
            "microbatches > 1 (gradient accumulation) is not ported to "
            "repro_torch yet (ROADMAP Queue A 10)")
    loss_fn = make_loss_fn(cfg, moe_aux_coef=moe_aux_coef)

    def grads_of(params, batch):
        # detached leaves share the state's storage: autograd sees fresh
        # leaves, the state's tensors stay plain (no requires_grad)
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            total, aux = loss_fn(leaves, batch)
            flat = tree_leaves(leaves)
            gflat = torch.autograd.grad(total, flat)
        by_id = {id(x): g for x, g in zip(flat, gflat)}
        return total.detach(), aux, tree_map(lambda x: by_id[id(x)], leaves)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   lr: Optional[float] = None
                   ) -> Tuple[TrainState, Dict[str, Any]]:
        total, aux, grads = grads_of(state["params"], batch)
        om = adamw_update(grads, state["opt"], state["params"], opt_cfg, lr)
        state["step"].add_(1)
        metrics = {"total_loss": total,
                   **{k: v.detach() for k, v in aux.items()}, **om,
                   "step": state["step"].clone()}
        return state, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig):
    """``prefill_step(params, batch) -> logits [B,S,V]`` (float32,
    sampling-ready): the inference forward under ``no_grad``, whose
    attention is the flash kernel on the card."""
    def prefill_step(params, batch):
        with torch.no_grad():
            return lm.forward(cfg, params, batch, training=False)
    return prefill_step


def make_decode_step(cfg: ArchConfig):
    """``serve_step(params, caches, batch) -> (next_token [B,1] int32,
    caches)``: greedy decode of one token; the caches are updated in
    place."""
    def serve_step(params, caches, batch):
        with torch.no_grad():
            logits, caches = lm.decode_step(cfg, params, caches, batch)
            nxt = logits[..., :cfg.vocab_size].argmax(dim=-1)
        return nxt.to(torch.int32), caches
    return serve_step
