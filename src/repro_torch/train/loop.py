"""ManagedTrainingSession — the training loop with Kishu attached (the port
of the JAX package's ``train/loop.py``).

Every user-visible operation (train phase, eval, hparam change, data swap)
is a *command* — the notebook-cell analogue.  After each command Kishu
detects the co-variable delta and writes an incremental checkpoint; any past
phase boundary can be checked out (undo a bad LR, fork a branch per data
mixture, roll back a loss spike) because only diverged co-variables are
reloaded.

Namespace layout (flat names), the same as the JAX package's, so the two
packages write the same stores and each resumes the other's:
  state/params/...       model parameters (one leaf per tensor)
  state/params/lm_head   ALIAS of state/params/embed for tied archs — a real
                         shared reference the checkpointer must preserve
  state/opt/...          AdamW moments and count
  state/step, state/rng
  hparams/lr             dynamic learning rate (a Python float)
  data/seed, data/step   versioned data-iterator state (Python ints)
  metrics/...            eval outputs (Python floats)

The tensors live on the session's device (``cuda`` unless the caller
passes ``device="cpu"``) and a train phase updates them in place.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from repro_torch.core import KishuSession
from repro_torch.core.chunkstore import ChunkStore
from repro_torch.core.covariable import group_covariables
from repro_torch.data.pipeline import DataState, TokenPipeline
from repro_torch.models.config import ArchConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import step as step_lib


class ManagedTrainingSession:
    """Public entry point: attach -> train/eval/set_lr/swap_data ->
    checkout."""

    def __init__(self, cfg: ArchConfig, opt_cfg: AdamWConfig,
                 store: ChunkStore, *, global_batch: int = 8,
                 seq_len: int = 64, chunk_bytes: int = 1 << 16,
                 async_write: bool = False,
                 device: Union[str, torch.device, None] = None):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.kishu = KishuSession(store, chunk_bytes=chunk_bytes,
                                  async_write=async_write, device=device)
        self.device = self.kishu.device
        self.pipeline = TokenPipeline(cfg.vocab_size, global_batch, seq_len)
        self._step = step_lib.make_train_step(cfg, opt_cfg)
        self._loss = step_lib.make_loss_fn(cfg)
        self._register_commands()

    # ------------------------------------------------------------------
    # namespace <-> train state
    # ------------------------------------------------------------------
    def _read_state(self, ns) -> Dict[str, Any]:
        state = ns.get_tree("state")
        if self.cfg.tie_embeddings:
            state["params"].pop("lm_head", None)   # alias, not a model input
        return state

    def _write_state(self, ns, state: Dict[str, Any]) -> None:
        ns.set_tree("state", dict(state))
        if self.cfg.tie_embeddings:
            # restore the shared reference: lm_head IS embed
            ns["state/params/lm_head"] = ns["state/params/embed"]

    def _batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items()}

    # ------------------------------------------------------------------
    # commands (the "cells")
    # ------------------------------------------------------------------
    def _register_commands(self) -> None:
        cfg, opt_cfg = self.cfg, self.opt_cfg

        def init_model(ns, seed: int):
            state = step_lib.init_train_state(cfg, seed, opt_cfg,
                                              self.device)
            self._write_state(ns, state)
            ns["hparams/lr"] = float(opt_cfg.lr)
            ns["data/seed"] = int(seed)
            ns["data/step"] = 0

        def train_phase(ns, steps: int):
            state = self._read_state(ns)
            lr = float(ns["hparams/lr"])
            dstate = DataState(ns["data/seed"], ns["data/step"])
            metrics = None
            for _ in range(steps):
                batch, dstate = self.pipeline.next_batch(dstate)
                state, metrics = self._step(state, self._batch(batch), lr)
            self._write_state(ns, state)
            ns["data/step"] = int(dstate.step)
            if metrics is not None:
                ns["metrics/last_loss"] = float(metrics["loss"])

        def eval_phase(ns, batches: int = 1, seed: int = 777):
            state = self._read_state(ns)
            pipe = TokenPipeline(cfg.vocab_size,
                                 self.pipeline.global_batch,
                                 self.pipeline.seq)
            ds = DataState(seed, 0)
            losses = []
            with torch.no_grad():
                for _ in range(batches):
                    batch, ds = pipe.next_batch(ds)
                    loss, _ = self._loss(state["params"], self._batch(batch))
                    losses.append(float(loss))
            ns["metrics/eval_loss"] = float(np.mean(losses))

        def set_lr(ns, lr: float):
            ns["hparams/lr"] = float(lr)

        def swap_data(ns, seed: int):
            ns["data/seed"] = int(seed)
            ns["data/step"] = 0

        for name, fn in [("init_model", init_model),
                         ("train_phase", train_phase),
                         ("eval_phase", eval_phase),
                         ("set_lr", set_lr), ("swap_data", swap_data)]:
            self.kishu.register(name, fn)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def attach(self, seed: int = 0) -> str:
        return self.kishu.run("init_model", seed=seed,
                              _message="init model")

    def train(self, steps: int) -> str:
        return self.kishu.run("train_phase", steps=steps,
                              _message=f"train {steps} steps")

    def evaluate(self, batches: int = 1) -> str:
        return self.kishu.run("eval_phase", batches=batches,
                              _message="eval")

    def set_lr(self, lr: float) -> str:
        return self.kishu.run("set_lr", lr=lr, _message=f"lr={lr}")

    def swap_data(self, seed: int) -> str:
        return self.kishu.run("swap_data", seed=seed,
                              _message=f"data seed={seed}")

    def checkout(self, commit_id: str):
        return self.kishu.checkout(commit_id)

    @property
    def ns(self):
        return self.kishu.ns

    def eval_loss(self) -> float:
        return self.ns["metrics/eval_loss"]

    def log(self):
        return self.kishu.log()

    def close(self):
        self.kishu.close()


def resume(cfg: ArchConfig, opt_cfg: AdamWConfig, store: ChunkStore,
           **kw) -> ManagedTrainingSession:
    """Crash/elastic recovery: rebuild a session over an existing store
    (written by either package) and load HEAD in full, onto the session's
    device; later checkouts are incremental again."""
    sess = ManagedTrainingSession(cfg, opt_cfg, store, **kw)
    head = sess.kishu.graph.head
    if head and head != "c00000":
        sess.kishu.records, _ = sess.kishu.loader.materialize_state(
            sess.kishu.tracked, head)
        sess.kishu.covs = group_covariables(sess.kishu.records)
    return sess
