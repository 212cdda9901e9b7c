"""Step functions of the port (the JAX package's ``train/step.py``): loss,
gradients by autograd and the in-place AdamW step; prefill; and one-token
decode.

``train_step`` consumes a TrainState dict — exactly the tree the Kishu
session flattens into its namespace (params, AdamW moments, step, rng) —
and updates its tensors in place, so each keeps its identity (and the
tied embedding its alias) from one step to the next.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import obs
from repro_torch.core.namespace import flatten_tree, unflatten_tree
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


def spmd(tree: Any):
    """The context a step over ``tree`` runs in: DTensor's implicit
    replication (plain tensors the step makes — positions, masks, RoPE
    tables, scalars — act as replicated) when a leaf is a DTensor, else
    nothing."""
    if any(isinstance(x, DTensor) for x in tree_leaves(tree)):
        return implicit_replication()
    return contextlib.nullcontext()


def _whole_last_dim(x: torch.Tensor) -> torch.Tensor:
    """A DTensor sharded on its last dim (vocab-sharded logits)
    redistributed with that dim whole; anything else as it is."""
    if not isinstance(x, DTensor):
        return x
    last = x.ndim - 1
    pl = [Replicate() if isinstance(q, Shard) and q.dim in (-1, last) else q
          for q in x.placements]
    return x.redistribute(x.device_mesh, pl)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  true_vocab: int) -> torch.Tensor:
    """Mean token cross-entropy; columns >= true_vocab are masked padding
    columns of the padded embedding table (set to -1e30).  Vocab-sharded
    DTensor logits are gathered along the vocab first (the gold-logit
    ``gather`` needs the whole row)."""
    logits = _whole_last_dim(logits)
    v = logits.shape[-1]
    if true_vocab < v:
        mask = torch.arange(v, device=logits.device) >= true_vocab
        logits = logits.masked_fill(mask, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (logz - gold).mean()


def make_loss_fn(cfg: ArchConfig, *, moe_aux_coef: float = 0.01,
                 mtp_coef: float = 0.1, hidden_sharding=None):
    """``loss_fn(params, batch) -> (total, {"loss", "moe_aux"})``: the
    token cross-entropy, plus ``moe_aux_coef`` times the MoE aux loss, plus
    for an MTP model ``mtp_coef`` times the t+2 cross-entropy (labels
    shifted by one more, the last repeated), as in the JAX package."""
    def loss_fn(params, batch):
        logits, aux = lm.forward(cfg, params, batch, training=True,
                                 return_aux=True,
                                 hidden_sharding=hidden_sharding)
        loss = cross_entropy(logits, batch["labels"], cfg.vocab_size)
        total = loss + moe_aux_coef * aux["moe_aux"]
        if "mtp_logits" in aux:
            lbl = batch["labels"]
            lbl2 = torch.cat([lbl[:, 1:], lbl[:, -1:]], dim=1)
            total = total + mtp_coef * cross_entropy(
                aux["mtp_logits"], lbl2, cfg.vocab_size)
        return total, {"loss": loss, "moe_aux": aux["moe_aux"]}
    return loss_fn


def loss_and_grads(loss_fn, params, batch
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any,
                              List[str]]:
    """``(total, aux, grads, unused)``: ``loss_fn(params, batch)`` and the
    gradient of ``total`` for every leaf of ``params``, each on its
    parameter's placements.  A leaf the loss does not reach (``embed``
    when the batch carries a frontend's ``embeds`` and the unembedding is
    untied) gets zeros of its own shape and dtype (a DTensor's on its mesh
    and placements), the gradient ``jax.grad`` gives it; ``unused`` names
    those leaves by path."""
    # detached leaves share the state's storage: autograd sees fresh
    # leaves, the state's tensors stay plain (no requires_grad)
    flat = {k: p.detach().requires_grad_(True)
            for k, p in flatten_tree(params).items()}
    with torch.enable_grad():
        total, aux = loss_fn(unflatten_tree(flat), batch)
        gflat = torch.autograd.grad(total, list(flat.values()),
                                    allow_unused=True)
    grads, unused = {}, []
    for (k, x), g in zip(flat.items(), gflat):
        if g is None:
            unused.append(k)
            g = torch.zeros_like(x)
        elif isinstance(x, DTensor):
            g = g.redistribute(x.device_mesh, x.placements)
        grads[k] = g
    return total.detach(), {k: v.detach() for k, v in aux.items()}, \
        unflatten_tree(grads), unused


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, *,
                    microbatches: int = 1, moe_aux_coef: float = 0.01,
                    hidden_sharding=None):
    """Returns ``train_step(state, batch, lr=None) -> (state, metrics)``;
    the returned state is ``state``, updated in place.

    ``microbatches > 1`` accumulates gradients as the JAX package does: the
    batch splits on its leading axis (which it must divide), float32
    gradients are summed over the microbatches in order, and the gradients,
    ``total`` and the aux metrics are scaled by ``1/microbatches`` before
    the one AdamW update.  An MTP model's t+2 loss is part of ``total``
    in each microbatch, as the MoE aux loss is.

    A state of DTensors (placements from ``sharding.ShardingRules``) runs
    as one SPMD program over their mesh: the batch's DTensors shard the
    tokens, each gradient is redistributed to its parameter's placements
    before the update, and the moments keep them.  ``hidden_sharding``
    (a ``(mesh, placements)`` layout) constrains the residual stream
    (:func:`lm.forward`); it is a no-op on plain tensors."""
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    loss_fn = make_loss_fn(cfg, moe_aux_coef=moe_aux_coef,
                           hidden_sharding=hidden_sharding)

    def grads_of(params, batch):
        return loss_and_grads(loss_fn, params, batch)[:3]

    def accumulated(params, batch):
        if microbatches == 1:
            return grads_of(params, batch)
        b = next(iter(batch.values())).shape[0]
        if any(v.shape[0] != b for v in batch.values()) \
                or b % microbatches:
            raise ValueError(f"batch of {b} does not split into "
                             f"{microbatches} microbatches")
        parts = {k: v.chunk(microbatches) for k, v in batch.items()}
        total = aux = gacc = None
        for i in range(microbatches):
            tot, ax, g = grads_of(params, {k: v[i] for k, v in parts.items()})
            if gacc is None:
                total, aux, gacc = tot, ax, tree_map(lambda x: x.float(), g)
            else:
                total = total + tot
                aux = {k: aux[k] + ax[k] for k in aux}
                gacc = tree_map(lambda a, x: a + x.float(), gacc, g)
        scale = 1.0 / microbatches
        return total * scale, {k: v * scale for k, v in aux.items()}, \
            tree_map(lambda g: g * scale, gacc)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   lr: Optional[float] = None
                   ) -> Tuple[TrainState, Dict[str, Any]]:
        with spmd(state["params"]):
            total, aux, grads = accumulated(state["params"], batch)
            om = adamw_update(grads, state["opt"], state["params"], opt_cfg,
                              lr)
        state["step"].add_(1)
        metrics = {"total_loss": total, **aux, **om,
                   "step": state["step"].clone()}
        return state, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig, hidden_sharding=None):
    """``prefill_step(params, batch) -> logits [B,S,V]`` (float32,
    sampling-ready): the inference forward under ``no_grad``, whose
    attention is the flash kernel on the card.  The batch passes through
    whole: ``tokens`` or ``embeds``, ``positions_thw`` (M-RoPE) and
    ``enc_embeds`` (enc-dec, encoded in the same call).
    DTensor params run it as one SPMD program (the flash kernel on each
    rank's local batch and heads); ``hidden_sharding``: as in
    :func:`make_train_step`."""
    def prefill_step(params, batch):
        with torch.no_grad(), spmd(params):
            return lm.forward(cfg, params, batch, training=False,
                              hidden_sharding=hidden_sharding)
    return prefill_step


def _greedy_step(cfg: ArchConfig, params, caches, batch):
    """(float32 logits [B,1,V], next token [B,1] int32): ``lm.decode_step``
    and the greedy pick over the true vocabulary; caches updated in
    place."""
    with torch.no_grad(), spmd({"params": params, "caches": caches}):
        logits, _ = lm.decode_step(cfg, params, caches, batch)
        nxt = _whole_last_dim(logits)[..., :cfg.vocab_size] \
            .argmax(dim=-1).to(torch.int32)
    return logits, nxt


def make_decode_step(cfg: ArchConfig):
    """``serve_step(params, caches, batch) -> (next_token [B,1] int32,
    caches)``: greedy decode of one token; the caches are updated in
    place.  DTensor params and caches (``ShardingRules`` and
    ``sharding.rules.shard_caches``) run it as one SPMD program
    (:func:`spmd`): each rank writes and attends over its own sequence
    shard of the caches, and the next token is a batch-sharded
    DTensor."""
    def serve_step(params, caches, batch):
        return _greedy_step(cfg, params, caches, batch)[1], caches
    return serve_step


# the batch's inputs a graphed step reads from static buffers: token ids,
# or the precomputed embeddings of a frontend model
_GRAPH_INPUTS = ("tokens", "embeds")


def _local(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; a plain tensor as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


def _layout(x: torch.Tensor):
    """A DTensor's mesh and placements; None for a plain tensor."""
    return (x.device_mesh, tuple(x.placements)) \
        if isinstance(x, DTensor) else None


def _like(x: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """``local`` as a DTensor of ``x``'s mesh, placements, shape and
    strides where ``x`` is a DTensor; else ``local`` itself."""
    if not isinstance(x, DTensor):
        return local
    return DTensor.from_local(local, x.device_mesh, list(x.placements),
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def _settled(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its local shard's pending collective waited on, so that
    a captured step ends with every collective joined to the stream."""
    local = _local(x)
    if isinstance(local, funcol.AsyncCollectiveTensor):
        return _like(x, local.wait())
    return x


class GraphedDecodeStep:
    """The greedy decode step replayed from a CUDA graph: the port's
    counterpart of the JAX package's ``jax.jit(make_decode_step(cfg))``,
    plain or sharded (``jax.jit(..., in_shardings=...)``).

    ``step(params, caches, batch)`` returns ``(next_token, caches)`` as
    :func:`make_decode_step`'s step does; :meth:`with_logits` also returns
    the float32 logits.  On CPU tensors the eager step runs.  On CUDA the
    step (about 20,000 eager calls at SmolLM-360M) is captured once into a
    CUDA graph and replayed:

    - the graph reads a static ``[B,1]`` int32 token buffer (or, where the
      batch carries ``embeds`` — the vision frontend's decode — a static
      ``[B,1,d]`` buffer in their dtype) and a static 0-d int32 index,
      filled (``copy_`` / ``fill_``) before each replay, so no value of the
      batch is frozen into it;
    - it reads the parameters and reads and writes the caches at the
      addresses it was captured with, so it is keyed on the data pointer,
      shape, dtype and strides of every parameter and cache leaf (an
      enc-dec model's ``enc_out`` among them) and on the inputs' names,
      shapes and dtypes.  A new
      leaf — a checkout that loads a cache leaf in full builds a new tensor
      — captures again; a replay against storage that is no longer the live
      leaf would answer wrongly without an error;
    - its outputs are cloned, since the next replay overwrites them;
    - capture runs under ``no_grad`` after a warm-up on a side stream over
      copies of the caches (the step writes its caches in place, so the
      warm-up must not touch the live ones), into a private memory pool per
      graph; the step has no host sync.

    DTensor params and caches (``ShardingRules``, ``shard_caches``) are
    captured the same way, on their local shards: the key holds each
    leaf's local shard and its mesh and placements, the static token
    buffer is a DTensor on the batch's placements and the index a
    replicated one, and the graph holds the step's collectives (each
    attention layer's three all-reduces, the logits' gather) as NCCL
    launches; the warm-up sets up the communicator, which a capture
    cannot.  Every collective is waited on inside the capture.

    A failed capture or replay raises: on CUDA the eager step never runs
    in the graph's place.  ``captures`` counts captures and ``capture_s``
    their seconds, apart from the replayed steps."""

    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        self.captures = 0
        self.capture_s = 0.0
        self._key = None
        self._graph = None
        self._inputs = self._index = self._logits = self._next = None

    def __call__(self, params, caches, batch):
        _, nxt = self._run(params, caches, batch, logits=False)
        return nxt, caches

    def with_logits(self, params, caches, batch):
        """``(logits [B,1,V] float32, next_token [B,1] int32, caches)``."""
        logits, nxt = self._run(params, caches, batch, logits=True)
        return logits, nxt, caches

    def _run(self, params, caches, batch, *, logits: bool):
        leaves = tree_leaves(params) + tree_leaves(caches)
        inputs = {k: batch[k] for k in _GRAPH_INPUTS if k in batch}
        if not _local(next(iter(inputs.values()))).is_cuda:
            return _greedy_step(self.cfg, params, caches, batch)
        key = tuple((k, tuple(v.shape), v.dtype, _layout(v))
                    for k, v in inputs.items()) \
            + tuple((_local(t).data_ptr(), tuple(_local(t).shape), t.dtype,
                     _local(t).stride(), _layout(t)) for t in leaves)
        if key != self._key:
            self._capture(params, caches, inputs, leaves, key)
        for k, v in inputs.items():
            _local(self._inputs[k]).copy_(_local(v))
        index = batch["index"]
        if isinstance(index, torch.Tensor):
            _local(self._index).copy_(_local(index))
        else:
            _local(self._index).fill_(int(index))
        self._graph.replay()
        return (self._clone(self._logits) if logits else None,
                self._clone(self._next))

    @staticmethod
    def _clone(x: torch.Tensor) -> torch.Tensor:
        return _like(x, _local(x).clone())

    def _capture(self, params, caches, inputs, leaves, key) -> None:
        t0 = time.perf_counter()
        with obs.span("capture"):
            # drop the old graph and its outputs, so its pool can be freed
            self._key = self._graph = self._logits = self._next = None
            dev = _local(next(iter(inputs.values()))).device
            self._inputs = {k: _like(v, torch.empty(
                tuple(_local(v).shape),
                dtype=torch.int32 if k == "tokens" else v.dtype,
                device=dev).copy_(_local(v))) for k, v in inputs.items()}
            index = torch.zeros((), dtype=torch.int32, device=dev)
            sharded = [t for t in (*inputs.values(), *leaves)
                       if isinstance(t, DTensor)]
            if sharded:                     # replicated over the step's mesh
                mesh = sharded[0].device_mesh
                index = DTensor.from_local(index, mesh,
                                           [Replicate()] * mesh.ndim,
                                           run_check=False)
            self._index = index
            static = {**self._inputs, "index": self._index}
            main = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(device=dev)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                scratch = tree_map(torch.clone, caches)
                outs = _greedy_step(self.cfg, params, scratch, static)
                for x in outs:
                    _settled(x)
                del scratch, outs
            main.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            # thread_local: the session's pool threads may touch the card (a
            # pinned copy, an allocation) while a cell captures, and NCCL's
            # watchdog polls its events
            with torch.no_grad(), torch.cuda.graph(
                    graph, capture_error_mode="thread_local"):
                self._logits, self._next = (
                    _settled(x) for x in _greedy_step(self.cfg, params, caches,
                                                      static))
            self._graph, self._key = graph, key
            self.captures += 1
        self.capture_s += time.perf_counter() - t0
