"""End-to-end training launcher with Kishu time-traveling attached, on a
CUDA card (or the CPU, when asked).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --steps 200 --phase-steps 20 --store dir:///tmp/kishu_run
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \
        --device cpu --steps 4 --phase-steps 2

The flags are those of ``python -m repro.launch.train``, plus ``--device``.
The launcher runs the production loop: phases as commands, incremental
checkpoints every phase, automatic rollback if a phase diverges (loss
spike), and resume-from-store on restart.  The registered architectures
are ``smollm-360m``, ``qwen3-1.7b``, ``mamba2-780m``,
``phi3.5-moe-42b-a6.6b`` and ``jamba-1.5-large-398b``.
"""
from __future__ import annotations

import argparse
import math
import time
from typing import Optional, Sequence

from repro_torch.core.chunkstore import open_store
from repro_torch.models.config import get_config
from repro_torch.models.testing import reduced as reduce_cfg
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import ManagedTrainingSession, resume


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config of the same family")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--phase-steps", type=int, default=10)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--store", default="memory://")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--spike-rollback", type=float, default=3.0,
                    help="rollback a phase if loss spikes by this factor")
    ap.add_argument("--async-write", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    opt_cfg = AdamWConfig(lr=args.lr)
    store = open_store(args.store)
    kw = dict(global_batch=args.global_batch, seq_len=args.seq_len,
              async_write=args.async_write, device=args.device)

    if args.resume:
        sess = resume(cfg, opt_cfg, store, **kw)
        print(f"resumed at {sess.kishu.head}")
    else:
        sess = ManagedTrainingSession(cfg, opt_cfg, store, **kw)
        sess.attach(seed=0)

    n_phases = math.ceil(args.steps / args.phase_steps)
    prev_loss = float("inf")
    good_commit = sess.kishu.head
    for phase in range(n_phases):
        t0 = time.monotonic()
        cid = sess.train(args.phase_steps)
        loss = sess.ns.get("metrics/last_loss", float("nan"))
        rs = sess.kishu.last_run
        print(f"phase {phase:3d} [{cid}] loss={loss:.4f} "
              f"({args.phase_steps} steps, {time.monotonic()-t0:.1f}s; "
              f"ckpt {rs.write.bytes_written/1e6:.2f}MB in {rs.write_s*1e3:.0f}ms, "
              f"detect {rs.detect_s*1e3:.0f}ms)", flush=True)
        if loss > prev_loss * args.spike_rollback:
            print(f"  loss spike ({loss:.3f} > {args.spike_rollback}x"
                  f" {prev_loss:.3f}) -> rollback to {good_commit}")
            st = sess.checkout(good_commit)
            print(f"  rolled back in {st.wall_s*1e3:.0f}ms "
                  f"(loaded {st.covs_loaded} covs, kept {st.covs_identical})")
            sess.set_lr(sess.ns["hparams/lr"] * 0.5)
        else:
            prev_loss = min(prev_loss, loss)
            good_commit = cid
    sess.evaluate(batches=2)
    print(f"final eval loss: {sess.eval_loss():.4f}")
    print("storage:", sess.kishu.storage_stats())
    sess.close()


if __name__ == "__main__":
    main()
