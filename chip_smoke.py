#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Kishu on one NVIDIA card, end to end.

    python3 chip_smoke.py          # from the repository root; one card, nvcc

Phase 0  builds the seven CUDA kernels from ``src/repro_torch/csrc`` (one
         nvcc per source, all started together) and prints the card's name
         and power limit.
Phase 1  holds every kernel against its plain torch version on the card at
         the main path's shapes (1 MiB chunks of a 49152 x 960 fp32 tensor,
         plus ragged bf16 / unaligned uint8 tensors) — results must be
         bit-identical — and times the kernel, the plain version, the
         least time the card could take (the bound), and the one PyTorch
         call that computes the same function where there is one
         (patch_scatter, block_diff).  flash_attention is held within a
         stated tolerance at Phase 5's prefill shape (bf16, 8 x 512, 15/5
         heads of 64, causal) and six more (float32, full attention, no
         GQA, head dim 128, ragged S, S 4096) on each of its routes (bf16:
         the tensor-core route "tc" and the FMA route; float32: FMA), and
         timed beside SDPA; Phase 7b's prefill shape (bf16, 8 x 128, 32/8
         heads of 128) is one of them, and so are Phase 7c's MLA prefill
         (8 x 128, 128 heads, q and k of 192, v of 128 zero-padded to
         192; SDPA also on the unpadded v), Phase 7d's encoder (8 x 1500,
         20 heads of 64) and decoder prefill (8 x 16), and stablelm-12b's
         head dim 160 (8 x 512, 32/8 heads).  Every kernel, index_copy_,
         the block_diff library call and SDPA are timed by device time
         (CUDA-graph replay, 5 rounds in turns; median and range), with
         the L2 warm and with it cold (a 128 MiB write before each call,
         its own time taken off), beside the host loop; chunk_hash,
         delta_pack (scan + gather), delta_codec and block_diff through
         their C entries, since their wrappers read a count or masks
         back.  delta_codec is also timed on random words, whose planes
         are all stored.  chunk_key (the store's BLAKE2b-128 chunk keys)
         is held against hashlib and timed at 612 and 1,200 chunks of 1
         MiB (Mamba-2's and Granite-4.0-H-Small's streamed state) beside
         hashlib on the pool's threads over the same bytes, its bound by
         operations and the time of one chain of compressions.
Phase 2  the main path: a ``KishuSession`` on a ``dir://`` store commits a
         SmolLM-360M-shaped fine-tuning state (fp32 params + AdamW m and v,
         870 tensors, 4.34 GB, random from a seeded CUDA generator), runs an
         AdamW step on layers 28-31 and re-initialises two vocabulary
         slices (rows 32768-37682 and 40000-44914), then checks out back
         and forward; every tensor must come back bit-identical.  The cycle
         re-init, checkout back, checkout forward then runs twice more
         (each from the AdamW-step commit, with a fresh seed), and all
         three are printed.  Kernel launch counts are read from this phase
         only.
Phase 3  the same small cells through a CUDA session and a CPU session (the
         plain versions) must write identical stores.
Phase 4  the trainer path: ``ManagedTrainingSession`` trains SmolLM-360M at
         full width and depth (bf16 params, fp32 AdamW moments, 3.62 GB,
         random from a seed) on a ``dir://`` store with 1 MiB chunks —
         attach, train, set_lr, train, evaluate, checkout back and forward,
         then a checkout of the first train commit's parent and train
         again (a replay, which must reproduce that commit), and
         ``resume`` in a fresh session — and verifies every checkout, the
         replay, the resume and the LR-only commit exactly with
         ``delta.exact_dirty_indices`` (the block_diff kernel).  Its
         launch counts are read from this phase, from attach to the resume's
         verification.
Phase 4b the checkout planner on Cell B: three trainer sessions over Phase
         4's store, with ``KISHU_PLANNER`` fetch, replay and auto in turn,
         each resume at the head and check out the first train commit; each
         checkout must equal Phase 4's snapshot of it under block_diff, its
         plan must equal its execution, and under replay the train phase
         must really be replayed (``covs_recomputed`` equal to
         ``covs_planned_replay``, above 0).  Each prints ``plan_est_s``
         beside the wall time and the head and tail of its plan's lines.
         Then the port's kishu CLI runs ``log``, ``plan``, ``verify``,
         ``fsck`` and ``topology`` in process on Phase 4's store.
Phase 5  Cell C, the serving path (examples/serve_batched.py on the card):
         SmolLM-360M at full width and depth (bf16, random from a seed);
         ``make_prefill_step`` on 8 x 512 prompt tokens (the flash kernel,
         once per layer), the teacher-forced decode loop fills 8 x 576-slot
         KV caches and its logits are held against the prefill's; the
         prefix is committed once (dir:// store, 16 KiB chunks), and four
         generations of 64 tokens (flavors 1, 2, 3, then 1 again) each
         start from a checkout of the prefix that block_diff verifies
         exact; the repeated flavor must give the same tokens and caches.
         Both decode loops replay a CUDA graph of the step
         (``GraphedDecodeStep``); a fifth generation by the eager step,
         from the same checkout, must equal the graph's bit for bit.
         flash_attention's launch count is read from this phase, and all
         32 prefill launches must take the tc route.
Phase 6  Cell D, the storage fabric: Cell A's state cut to its first 8
         layers (1.51 GB) on ``fabric://rep(shard(dir://s0,dir://s1),
         dir://r)`` with 1 MiB chunks and the planner on auto: attach,
         finetune_top on layers 4-7, reinit_vocab_slice on rows
         32768-37682, checkout back and forward; then, with the chunk
         cache off, the replica ``r`` loses every chunk file before a
         checkout back, ``scrub --repair`` heals it, the shard ``s1`` loses
         every chunk file before a checkout forward (read-repaired from
         ``r``), a second ``scrub --repair`` heals the rest and a last
         ``scrub`` must find no problem.  Every checkout must be exact
         under block_diff; launch counts are read from this phase.  The
         CLI verbs of Phase 4b then run on this fabric.
Phase 7  Cell E, Mamba-2/SSD serving: mamba2-780m at full width and depth
         (48 layers, d_model 1536, 48 SSD heads of 64, d_state 128, chunk
         256, bf16, random from a seed), Phase 5's flow: chunked-SSD
         prefill of 8 x 512 tokens, the decode loop (a CUDA graph of the
         recurrence) fills the caches — state [48, 8, 48, 64, 128] float32
         (603,979,776 bytes) and conv [48, 8, 3, 3328] bf16 — and is held
         against the prefill's logits; the prefix is committed in 1 MiB
         chunks, and four rollbacks (flavors 1, 2, 3, 1) and one by the
         eager step each restore a state that every decode step rewrote
         in full, verified exact by block_diff; the graph's generations
         equal the eager step's bit for bit.  Each rollback's wall time,
         bytes loaded, patch or full load, and each recapture are
         recorded.
Phase 7b Cell F, MoE serving: phi3.5-moe-42b-a6.6b at full width (d_model
         4096, 32/8 heads of 128, 16 experts top-2 of d_ff 6400, vocab
         32064, capacity factor 1.25), cut to its first 2 of 32 layers;
         Phase 5's flow at batch 8, a 128-token prompt, 32 generated
         tokens, 16 KiB chunks, two rollbacks (flavors 1, 2) and one by
         the eager step.  Prefill and decode logits are held at the
         positions where both compute the same function: no MoE layer
         dropped an assignment there or routed it otherwise than decode,
         nor at an earlier position of the sequence where an attention
         layer follows that MoE layer (``routing_mask_of``).
Phase 7c Cell G, MLA + MoE serving: deepseek-v3-671b at full width (d_model
         7168, 128 MLA heads: q_lora 1536, kv_lora 512, qk 128 + 64, v
         128; 256 routed experts top-8 of d_ff 2048 plus one shared,
         capacity 1.25; vocab 129280; the MTP block carried), cut to its
         first 4 of 61 layers (3 dense-prefix, 1 MoE; 15.8 B params, 31.6
         GB); Cell F's flow and traffic, flavors 1, 2, 1.  The prefill
         sends MLA through the flash kernel with v zero-padded to the qk
         head dim; decode writes the compressed caches c_kv and k_rope
         (5.9 MB) in place.  Peak memory is recorded.
Phase 7d Cell H, enc-dec serving: whisper-large-v3 at full size (32
         encoder + 32 decoder layers, d_model 1280, 20 heads of 64), 1,500
         seeded encoder frames, a 16-token decoder prompt, 64 generated,
         flavors 1, 2, 1.  enc_out [8, 1500, 1280] is written once before
         the prefix commit; every rollback must keep its tensor and read
         none of its chunks from the store.

Phase 8  Distribution on the card: a one-rank NCCL group over a
         FileStore, SmolLM-360M at Cell B's full width cut to its first 8
         of 32 layers (125,845,440 bf16 params + float32 moments,
         1,258,454,416 bytes), params and moments DTensors under
         ShardingRules on a (1, 1) ("data", "model") CUDA mesh, in a
         KishuSession with ``group=WORLD``.  Two sharded train steps run
         as Kishu cells (hidden constraint on), each held against the plain
         single-device port step on the card (loss 1e-3, params 2e-2, and
         each leaf's change over the step within DELTA_TOL of the plain
         change's norm; bit-identity recorded); the trained state's chunk
         keys and stored bytes equal those of the same values committed
         as plain tensors;
         a reinit_vocab_slice cycle restores by patch checkout (block_diff
         finds no differing chunk); the commit restores elastically onto
         an 8-way Shard(0) layout, range by range (host_shard_ranges),
         each range reading exactly the chunks of chunks_for_range, and
         the reassembled tensor is exact; one compressed_psum over the
         NCCL group, whose int32 sum equals the local int8 gradient.
         Launches of the comparisons with plain tensors (the plain step
         and the plain commit) are not counted as the path's.
Phase 9  Cell J, decode on DTensor caches: Phase 8's model (SmolLM-360M,
         full width, first 8 of 32 layers, bf16) as DTensors under
         ShardingRules and its caches under ``shard_caches`` (K/V
         sharded on the sequence over "model") on a one-rank NCCL (1, 1)
         mesh, batch 8, 1,024-slot caches (83,886,080 bytes of K + V), a
         64-token prompt, 16 KiB chunks, a KishuSession over the group.
         The sharded prefill (flash on the local shards, all 8 launches
         on tc) gives the prompt's logits; the sharded decode step,
         captured once in a CUDA graph (``GraphedDecodeStep`` on DTensor
         leaves: its all-reduces and gathers are NCCL launches in the
         graph), fills the prompt teacher-forced within the bf16 logit
         bound; the prefix commit equals the plain commit of the same
         cache values (chunk keys, hashes, bytes); flavors 1, 2, 1 of 32
         tokens are each followed by a rollback to the prefix, timed and
         verified exact by block_diff on the local shards, which patches
         every cache leaf in place, so the phase captures once in all;
         the repeated flavor gives the same tokens and caches.  Teacher-
         forced from the prefix, the graphed sharded step must equal the
         eager sharded step on a copy of the caches bit for bit (logits
         and caches) and stay within the bf16 bound of the plain graphed
         step on plain copies; one eager sharded step under
         CommDebugMode must issue three all-reduces in each attention
         layer.  The phase must end within 120 s.
Phase 10 Cell K, training where the JAX package trains: (a)
         phi3.5-moe-42b-a6.6b at full width, its first layer of 32
         (1,564,553,216 params, bf16, float32 moments: 15.6 GB of state)
         under ShardingRules on Phase 8's one-rank NCCL mesh, two sharded
         train steps (batch 8 x 128) as Kishu cells on a MemoryStore,
         each held against the plain step on a plain copy (Phase 8's
         tolerances), the DTensor commit against the plain commit of the
         same values (chunk keys, hashes, logical bytes), a checkout back
         to the first step's commit, exact under block_diff; (b)
         qwen2-vl-72b at full width, its first layer of 80 (3,369,099,264
         params, bf16, bf16 moments: 20.2 GB), plain tensors, one train
         cell from seeded frontend ``embeds`` [8, 128, 8192] and
         ``positions_thw`` [8, 128, 3]: ``embed``'s gradient is zero (its
         moments stay zero) and its new value is the decay-only AdamW
         update, bit for bit; a rollback to the parent, exact under
         block_diff; the cell replayed from there commits the same chunk
         keys.  Launches are read from both parts, the comparisons' taken
         out.

Output: per-phase lines, one JSON line of kernels, the nvidia-smi line,
and last ``{"ok": true, "device": {...}}``.  The full record goes to
``build/chip_smoke.json`` (Phase 4b's plan estimates beside the wall
times, and every plan's lines).  Without a card, or outside the
repository, it exits non-zero before printing any result.

    python3 chip_smoke.py --only phase2,phase6 [--root DIR]

runs only the named phases (2, 6, the serving phases 5, 7, 7b, 7c,
7d and 9, the distribution phase 8 and the training phase 10, each on a
store of its own, and Phase 1's chunk_key row, ``phase1_chunk_key``),
taken from the ``chip_smoke.py`` and
``src/`` under ``DIR`` (default: this tree), and prints one line each of
wall times, decode ms a step and peak memory.  Two trees are compared by calling it in turns with each tree's
root.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CB = 1 << 20                         # the session's default chunk size
# H100 SXM datasheet rates the bounds are taken against: HBM3 bandwidth,
# and 32-bit integer issue (132 SMs x 64 INT32 lanes x 1.98 GHz boost)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# dense tensor-core bf16 and plain float32 peaks (H100 SXM datasheet)
BF16_FLOPS_PER_S = 989e12
FP32_FLOPS_PER_S = 67e12
HASH_OPS_PER_WORD = 18               # kernel's integer ops per hashed word
# least integer ops per word the codec's function needs: a 32 x 32 bit
# transpose in 5 butterfly stages, each a shift, an xor and an and per word
# (6 ops per swapped pair of words), plus an OR and an AND per plane word
# to classify planes as zero or ones
CODEC_OPS_PER_WORD = 5 * 3 + 2
# the chunk_key kernel's 32-bit ALU instructions a BLAKE2b compression: 12
# rounds of 8 G functions of 22 each (an add and its carry a 64-bit add, an
# xor a half, two funnel shifts a rotation), and the 16 of the feed-forward
KEY_OPS_PER_BLOCK = 12 * 8 * 22 + 16
# an SM sub-partition has 16 INT32 lanes, so a warp's ALU instruction holds
# them two cycles: one chain's least time is its instructions x 2 / clock
ALU_CYCLES_PER_WARP_OP = 2
SM_CLOCK_HZ = 1.98e9
# chunks of 1 MiB the streamed whole writes of the benchmark's cells key:
# Mamba-2 780M's state, Granite-4.0-H-Small's state and conv (about)
KEY_CHUNKS = (612, 1200)
# the buffer device_ms writes before each call of a cold-L2 time: over
# twice the H100's 50 MB L2
L2_FLUSH_BYTES = 128 << 20

# SmolLM-360M (hf:HuggingFaceTB/SmolLM-360M): 32 layers, d_model 960,
# 15 query / 5 key-value heads of 64, d_ff 2560, vocab 49152, tied embeddings
N_LAYERS, D_MODEL, N_HEADS, N_KV, HEAD_DIM, D_FF, VOCAB = \
    32, 960, 15, 5, 64, 2560, 49152
TOP_LAYERS = range(28, 32)           # finetune_top updates these
# kernels each path must launch: the commit -> checkout loop of Phase 2,
# and the trainer of Phase 4, whose dense steps dirty every chunk (so its
# commits take the full path, no codec, streamed and keyed on the card)
# and whose checkouts load in full (no scatter)
COMMIT_PATH_KERNELS = ("chunk_hash", "delta_pack", "delta_codec",
                       "patch_scatter", "chunk_key")
TRAINER_PATH_KERNELS = ("chunk_hash", "delta_pack", "block_diff",
                        "chunk_key")
# reinit_vocab_slice runs on two slices of 4915 rows: one that starts on a
# 4 MiB boundary (row 32768 = 120 MiB), whose zeroed moments the sampled
# codec probe accepts, and one that starts mid-chunk (row 40000), where the
# probe samples half-old rows and sends the whole slice raw
VOCAB_ROWS = (32768, 37683)
VOCAB_ROWS_MID = (40000, 44915)
# the serving cell (Phase 5): batch 8, a 512-token prompt, 64 generated
# tokens, caches committed in 16 KiB chunks (examples/serve_batched.py's)
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 8, 512, 64
SERVE_CHUNK = 1 << 14
SERVE_PATH_KERNELS = ("flash_attention", "chunk_hash", "delta_pack",
                      "patch_scatter", "block_diff")
# Cell E (Phase 7): mamba2-780m serving at Cell C's traffic (batch 8, a
# 512-token prompt, 64 generated); its state is rewritten in full by every
# decode step, so 1 MiB chunks (16 KiB would only multiply files); no
# attention, no flash; rollbacks load the state in full (every chunk
# differs), so patch_scatter launches only if one patches
SSM_BATCH, SSM_PROMPT, SSM_GEN = 8, 512, 64
SSM_CHUNK = 1 << 20
SSM_PATH_KERNELS = ("chunk_hash", "delta_pack", "block_diff", "chunk_key")
# Cell F (Phase 7b): phi3.5-moe-42b-a6.6b at full width, depth cut to 2
# of 32 layers (each layer's 16 experts are 2.52 GB in bf16)
MOE_LAYERS = 2
MOE_BATCH, MOE_PROMPT, MOE_GEN = 8, 128, 32
MOE_PATH_KERNELS = SERVE_PATH_KERNELS
# Cell G (Phase 7c): deepseek-v3-671b at full width, depth cut to its first
# 4 of 61 layers (the 3 dense-prefix layers and the first MoE layer, whose
# 256 experts alone are 23.0 GB in bf16); Cell F's traffic
MLA_LAYERS = 4
MLA_BATCH, MLA_PROMPT, MLA_GEN = 8, 128, 32
MLA_PARAMS = 15_797_352_448
MLA_PATH_KERNELS = SERVE_PATH_KERNELS
# Cell H (Phase 7d): whisper-large-v3 at full size; 1,500 encoder frames
# (whisper's 30 s window after its conv frontend, which the model stubs as
# precomputed frame embeddings), a 16-token decoder prompt, 64 generated
ENC_BATCH, ENC_FRAMES, ENC_PROMPT, ENC_GEN = 8, 1500, 16, 64
ENC_PARAMS = 2_020_682_240
ENC_PATH_KERNELS = SERVE_PATH_KERNELS
# the phases whose launch counts the kernels line reports, each read from
# its own run (counts set to 0 just before it)
PATHS = ("phase2", "phase4", "phase4b", "phase5", "phase6", "phase7",
         "phase7b", "phase7c", "phase7d", "phase8", "phase9", "phase10")
# Phase 8: SmolLM-360M at full width, its first 8 of 32 layers, as
# DTensors on a one-rank NCCL mesh; the kernels its Kishu path launches on
# DTensor co-variables
DIST_LAYERS = 8
DIST_BATCH, DIST_SEQ = 8, 128
DIST_PATH_KERNELS = ("chunk_hash", "delta_pack", "patch_scatter",
                     "block_diff")
ELASTIC_WAYS = 8
# a sharded train step's parameter change against the plain step's, as a
# share of the plain change's norm, leaf by leaf (a skipped update or a
# wrong gradient gives ~1)
DELTA_TOL = 0.1
# Phase 9 (Cell J): decode on DTensor caches — SmolLM-360M at full width,
# Phase 8's cut to its first 8 of 32 layers, bf16, params under
# ShardingRules and caches under shard_caches on a one-rank NCCL mesh;
# batch 8 with 1,024-slot caches (K + V: 83,886,080 bytes), a 64-token
# prompt (sized when the sharded step ran eagerly, kept so that the cell
# compares across PRs), 32 generated tokens a flavor, Cell C's 16 KiB
# chunks
SHARD_LAYERS = 8
SHARD_BATCH, SHARD_SLOTS, SHARD_PROMPT, SHARD_GEN = 8, 1024, 64, 32
SHARD_COMPARE = 16        # teacher-forced steps held against the eager
                          # sharded and the plain graphed step
SHARD_PATH_KERNELS = ("flash_attention", "chunk_hash", "delta_pack",
                      "patch_scatter", "block_diff")
PHASE9_LIMIT_S = 120.0
# Phase 10 (Cell K): training where the JAX package trains — phi3.5-moe at
# full width, its first layer of 32 (1.56 B params; 16 experts of d_ff
# 6400 are 1.26 B of them), sharded on a one-rank NCCL mesh, and
# qwen2-vl-72b at full width, its first layer of 80 (3.37 B params, the
# untied embed and lm_head 1.25 B each), from frontend embeddings; Phase
# 8's batch of 8 x 128; states of 15.6 GB and 20.2 GB, committed to a
# MemoryStore (a dir:// store writes about 0.34 GB/s on the card's
# machine, 45 s a commit here); the kernels of the trainer path, plus
# patch_scatter for the one-chunk step and count leaves a checkout patches
TRAIN_MOE_LAYERS, TRAIN_VLM_LAYERS = 1, 1
TRAIN_BATCH, TRAIN_SEQ = DIST_BATCH, DIST_SEQ
TRAIN_PATH_KERNELS = ("chunk_hash", "delta_pack", "patch_scatter",
                      "block_diff", "chunk_key")
# about 230 s on an H100 80GB HBM3 at 700 W: the dense commits of 15.6 GB
# of DTensor state and 20.2 GB of plain state take most of it
PHASE10_LIMIT_S = 300.0
# the phases ``--only`` runs alone: each takes (torch, dev, workdir)
TIMED_PHASES = ("phase2", "phase6", "phase5", "phase7", "phase7b",
                "phase7c", "phase7d", "phase8", "phase9", "phase10",
                "phase1_chunk_key")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def param_shapes(n_layers: int = N_LAYERS) -> dict:
    q, kv = N_HEADS * HEAD_DIM, N_KV * HEAD_DIM
    shapes = {"embed": (VOCAB, D_MODEL), "final_norm": (D_MODEL,)}
    for i in range(n_layers):
        p = f"layers/{i:02d}"
        shapes.update({
            f"{p}/attn_norm": (D_MODEL,), f"{p}/attn/q": (D_MODEL, q),
            f"{p}/attn/k": (D_MODEL, kv), f"{p}/attn/v": (D_MODEL, kv),
            f"{p}/attn/o": (q, D_MODEL), f"{p}/mlp_norm": (D_MODEL,),
            f"{p}/mlp/gate": (D_MODEL, D_FF), f"{p}/mlp/up": (D_MODEL, D_FF),
            f"{p}/mlp/down": (D_FF, D_MODEL)})
    return shapes


def top_names(layers=TOP_LAYERS) -> list:
    return [n for n in param_shapes(max(layers) + 1)
            if any(n.startswith(f"layers/{i:02d}/") for i in layers)]


# ---------------------------------------------------------------------------
# Phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------

def time_ms(torch, fn, iters: int, warmup: int = 1) -> float:
    """Mean ms per call by CUDA events over ``iters`` calls after warm-up
    (the calls' own host syncs, where a wrapper has one, are inside)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fns: dict, calls: int, rounds: int = 5,
              cold: bool = False) -> dict:
    """Device time per call of each function in ``fns`` (name -> fn): its
    ``calls`` calls are captured in one CUDA graph, and each graph's replay
    is timed with CUDA events, ``rounds`` times in turns (a, b, ..., b, a),
    so two samples a round.  The host's enqueue is outside the timed span.
    Returns name -> {median, min, max, samples} in ms per call.

    With ``cold``, each function is also captured with a write of
    L2_FLUSH_BYTES (over twice the L2) before each of its calls, a graph of
    the writes alone is timed in the same turns, and name -> "cold" holds
    the per-call difference of the two, sample by sample: the call's time
    when none of its data is in L2."""
    import statistics
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                        device="cuda") if cold else None

    def capture(body):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(calls):
                body()
        g.replay()
        return g

    graphs = {}
    for name, fn in fns.items():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()                      # warm-up off the capture
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graphs[name] = capture(fn)
        if cold:
            graphs[f"{name} cold"] = capture(
                lambda fn=fn: (flush.zero_(), fn()))
    if cold:
        graphs["flush"] = capture(flush.zero_)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    samples: dict = {name: [] for name in graphs}
    order = list(graphs)
    for _ in range(rounds):
        for name in order + order[::-1]:
            start.record()
            graphs[name].replay()
            end.record()
            end.synchronize()
            samples[name].append(start.elapsed_time(end) / calls)
    del graphs, flush
    torch.cuda.synchronize()

    def stats(v):
        return {"median": statistics.median(v), "min": min(v),
                "max": max(v), "samples": v}
    out = {name: stats(samples[name]) for name in fns}
    if cold:
        for name in fns:
            out[name]["cold"] = stats([a - b for a, b in zip(
                samples[f"{name} cold"], samples["flush"])])
    return out


def spread(d: dict) -> str:
    text = f"{d['median']:.4f} ms [{d['min']:.4f}-{d['max']:.4f}]"
    if "cold" in d:
        text += f", cold-L2 {spread(d['cold'])}"
    return text


def bound(nbytes: float, ops: float, ops_per_s: float = INT32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(torch, a, b) -> float:
    a, b = a.to(torch.int64), b.to(torch.int64)
    return float((a - b).abs().max()) if a.numel() else 0.0


def phase1(torch, dev) -> list:
    from repro_torch.core.hashing import MASK32, chunk_hashes_plain
    from repro_torch.kernels import _lib
    from repro_torch.kernels.block_diff.ops import (block_diff_cuda,
                                                    block_diff_plain)
    from repro_torch.kernels.chunk_hash.ops import chunk_hash_cuda
    from repro_torch.kernels.delta_codec import host as codec_host
    from repro_torch.kernels.delta_codec.ops import TILE_GROUPS as \
        CODEC_TILE_GROUPS
    from repro_torch.kernels.delta_codec.ops import (codec_encode_cuda,
                                                     codec_encode_plain,
                                                     i32_bits, u32_values)
    from repro_torch.kernels.delta_pack.ops import (delta_pack_cuda,
                                                    delta_pack_plain)
    from repro_torch.kernels.patch_scatter.ops import (patch_scatter_cuda,
                                                       patch_scatter_plain)

    g = torch.Generator(device=dev).manual_seed(1)
    lo, hi = VOCAB_ROWS
    emb = torch.empty((VOCAB, D_MODEL), device=dev).normal_(0, 0.02,
                                                            generator=g)
    u8 = emb.view(-1).view(torch.uint8)
    nbytes = u8.numel()
    n = nbytes // CB
    words = nbytes // 4
    rows_out = []

    # -- chunk_hash: the embedding, plus ragged / unaligned inputs
    k = chunk_hash_cuda(u8, CB)
    p = chunk_hashes_plain(u8, CB)
    check(torch.equal(k.to(torch.int64) & MASK32, p), "chunk_hash != plain")
    err = max_abs_err(torch, k.to(torch.int64) & MASK32, p)
    odd_bf16 = torch.empty(3_000_001, device=dev, dtype=torch.bfloat16) \
        .normal_(generator=g)
    raw = torch.randint(0, 256, (5_000_003,), device=dev, dtype=torch.uint8,
                        generator=g)[1:]                     # unaligned base
    for extra in (odd_bf16.view(torch.uint8), raw):
        check(torch.equal(chunk_hash_cuda(extra, CB).to(torch.int64)
                          & MASK32, chunk_hashes_plain(extra, CB)),
              "chunk_hash != plain on a ragged / unaligned input")
    b_ms, b_by = bound(nbytes + 8 * n, HASH_OPS_PER_WORD * words)
    # device time of the C entry alone, with the zeroing of its output that
    # the wrapper does (the kernel xors partial lanes into it)
    h_out = torch.zeros((n, 2), dtype=torch.int32, device=dev)
    h_splits = _lib.splits_for(n, CB)

    def hash_raw():
        h_out.zero_()
        _lib.call("kishu_chunk_hash", u8.data_ptr(), nbytes, CB, h_splits,
                  h_out.data_ptr(), _lib.stream_of(u8))
    dev_t = device_ms(torch, {"kernel": hash_raw}, 20, cold=True)
    check(torch.equal(h_out.to(torch.int64) & MASK32, p),
          "chunk_hash's C entry != plain after the timed replays")
    rows_out.append({
        "name": "chunk_hash", "route": "cuda",
        "source": "src/repro_torch/csrc/chunk_hash.cu",
        "replaces": "src/repro/kernels/chunk_hash/kernel.py:61",
        "max_abs_err": err, "ms": dev_t["kernel"]["median"],
        "host_ms": time_ms(torch, lambda: chunk_hash_cuda(u8, CB), 20),
        "device": dev_t,
        "plain_ms": time_ms(torch, lambda: chunk_hashes_plain(u8, CB), 2),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"fp32 [{VOCAB}, {D_MODEL}], {n} chunks of 1 MiB"})

    # -- delta_pack: the embedding after a vocabulary-slice re-init
    prev = p
    emb1 = emb.clone()
    emb1[lo:hi].normal_(0, 0.02, generator=g)
    u8b = emb1.view(-1).view(torch.uint8)
    prev32 = i32_bits(prev)
    kh, kd, kpos, kcount, kbuf = delta_pack_cuda(u8b, prev32, CB)
    ph, pd, ppos, pcount, pbuf = delta_pack_plain(u8b, prev, CB)
    check(kcount == pcount > 0, f"delta_pack count {kcount} vs {pcount}")
    outs = [(kh.to(torch.int64) & MASK32, ph), (kd, pd), (kpos, ppos),
            (kbuf, i32_bits(pbuf))]
    check(all(torch.equal(a.to(torch.int64), b.to(torch.int64))
              for a, b in outs), "delta_pack != plain")
    err = max(max_abs_err(torch, a, b) for a, b in outs)
    dirty_idx = torch.nonzero(kd).reshape(-1)
    b_ms, b_by = bound(nbytes + 8 * n + 16 * n + 4 + kcount * CB,
                       HASH_OPS_PER_WORD * words)
    # scan + gather, the gather sized by the count of the call above: the
    # wrapper's read-back of the count stays outside the timed graph
    p_hash = torch.zeros((n, 2), dtype=torch.int32, device=dev)
    p_dirty, p_pos = (torch.empty((n,), dtype=torch.int32, device=dev)
                      for _ in range(2))
    p_count = torch.empty((1,), dtype=torch.int32, device=dev)
    p_buf = torch.empty((kcount, CB // 4), dtype=torch.int32, device=dev)
    p_splits = _lib.splits_for(n, CB)

    def pack_raw():
        p_hash.zero_()
        _lib.call("kishu_delta_pack_scan", u8b.data_ptr(), nbytes, CB,
                  p_splits, prev32.data_ptr(), p_hash.data_ptr(),
                  p_dirty.data_ptr(), p_pos.data_ptr(), p_count.data_ptr(),
                  _lib.stream_of(u8b))
        _lib.call("kishu_delta_pack_gather", u8b.data_ptr(), nbytes, CB,
                  p_splits, p_pos.data_ptr(), p_buf.data_ptr(),
                  _lib.stream_of(u8b))
    dev_t = device_ms(torch, {"kernel": pack_raw}, 20, cold=True)
    check(int(p_count.item()) == kcount and torch.equal(p_hash, kh)
          and torch.equal(p_pos, kpos) and torch.equal(p_buf, kbuf),
          "delta_pack's C entries != the wrapper after the timed replays")
    rows_out.append({
        "name": "delta_pack", "route": "cuda",
        "source": "src/repro_torch/csrc/delta_pack.cu",
        "replaces": "src/repro/kernels/delta_pack/kernel.py:112",
        "max_abs_err": err, "ms": dev_t["kernel"]["median"],
        "host_ms": time_ms(torch, lambda: delta_pack_cuda(u8b, prev32, CB),
                           20),
        "device": dev_t,
        "plain_ms": time_ms(torch, lambda: delta_pack_plain(u8b, prev, CB),
                            2),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"fp32 [{VOCAB}, {D_MODEL}], {kcount} of {n} chunks dirty"})

    # -- delta_codec: the compacted rows of a zeroed AdamW-moment slice, and
    #    random words of the same shape, whose planes are all stored (the
    #    worst-case plane buffer fills)
    m0 = torch.empty((VOCAB, D_MODEL), device=dev).normal_(0, 1e-3,
                                                           generator=g)
    m1 = m0.clone()
    m1[lo:hi] = 0
    _, _, _, mcount, rows = delta_pack_cuda(
        m1.view(-1).view(torch.uint8),
        i32_bits(chunk_hashes_plain(m0.view(-1).view(torch.uint8), CB)), CB)
    rnd = torch.randint(-2**31, 2**31 - 1, tuple(rows.shape), device=dev,
                        dtype=torch.int32, generator=g)
    gw = 1024
    ng = rows.numel() // gw
    codec = {}
    errs = []
    for label, x in (("zeroed", rows), ("random", rnd)):
        km, kn, kp = codec_encode_cuda(x, gw)
        pm, pn, pp = codec_encode_plain(u32_values(x), gw)
        check(kn == pn > 0, f"codec {label}: stored planes {kn} vs {pn}")
        outs = [(km.to(torch.int64) & MASK32, pm.cpu()),
                (kp, i32_bits(pp))]
        check(all(torch.equal(a.to(torch.int64), b.to(torch.int64))
                  for a, b in outs), f"delta_codec != plain ({label})")
        errs += [max_abs_err(torch, a, b) for a, b in outs]
        codec[label] = (x, km, kn, kp)
    check(codec["random"][2] == ng * 32,
          f"random words stored {codec['random'][2]} of {ng * 32} planes")
    _, km, kn, kp = codec["zeroed"]
    masks = km.numpy().view("<u4")
    planes = kp.cpu().numpy().view("<u4")
    frames = codec_host.frames_from_encoded(masks, planes, (CB // 4) // gw,
                                            gw, [CB] * mcount)
    host_rows = rows.cpu().numpy()
    for r in (0, mcount - 1):              # a zeroed row and a mixed one
        want = codec_host.make_frame(
            codec_host.bitplane_compress(host_rows[r].tobytes(), gw), CB)
        check(frames[r] == want, f"device frame {r} != host bitplane frame")
    # the bound of each case: one read of the rows, one write of the masks
    # and of the planes that case stores
    rw = rows.numel()
    bounds = {label: bound(rw * 4 + 8 * ng + codec[label][2] * (gw // 8),
                           CODEC_OPS_PER_WORD * rw) for label in codec}
    # the C entry alone (its one launch) into buffers of the sizes the
    # wrapper allocates; the wrapper's read-back of the masks and the count
    # stays outside the timed graph
    c_bufs = {label: (torch.empty((2 * ng + 1,), dtype=torch.int32,
                                  device=dev),
                      torch.empty((ng * 32, gw // 32), dtype=torch.int32,
                                  device=dev),
                      torch.zeros((-(-ng // CODEC_TILE_GROUPS) + 1,),
                                  dtype=torch.int64, device=dev))
              for label in codec}

    def codec_raw(label):
        x = codec[label][0]
        out, c_planes, status = c_bufs[label]
        _lib.call("kishu_codec_encode", x.data_ptr(), ng, gw, out.data_ptr(),
                  out[2 * ng:].data_ptr(), c_planes.data_ptr(),
                  status.data_ptr(), status.numel(), _lib.stream_of(x))
    dev_t = device_ms(torch, {label: (lambda label=label: codec_raw(label))
                              for label in codec}, 20, cold=True)
    for label, (_, w_masks, w_n, w_planes) in codec.items():
        out, c_planes, _ = c_bufs[label]
        host_out = out.cpu()
        check(int(host_out[2 * ng]) == w_n
              and torch.equal(host_out[:2 * ng].view(ng, 2), w_masks)
              and torch.equal(c_planes[:w_n], w_planes),
              f"delta_codec's C entry != the wrapper after the timed "
              f"replays ({label})")
    b_ms, b_by = bounds["zeroed"]
    rows_out.append({
        "name": "delta_codec", "route": "cuda",
        "source": "src/repro_torch/csrc/delta_codec.cu",
        "replaces": "src/repro/kernels/delta_codec/kernel.py:105",
        "max_abs_err": max(errs), "ms": dev_t["zeroed"]["median"],
        "host_ms": time_ms(torch, lambda: codec_encode_cuda(rows, gw), 20),
        "device": {"kernel": dev_t["zeroed"]},
        "plain_ms": time_ms(torch,
                            lambda: codec_encode_plain(u32_values(rows), gw),
                            2),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "random": {"ms": dev_t["random"]["median"],
                   "cold_ms": dev_t["random"]["cold"]["median"],
                   "device": dev_t["random"],
                   "host_ms": time_ms(torch,
                                      lambda: codec_encode_cuda(rnd, gw), 20),
                   "bound_ms": bounds["random"][0],
                   "bound_by": bounds["random"][1],
                   "stored_planes": codec["random"][2]},
        "shape": f"{mcount} rows x 262144 words, {ng} groups, {kn} stored "
                 f"planes"})
    del codec, c_bufs, rnd

    # -- patch_scatter: the dirty chunks back into a live embedding
    idx = dirty_idx.to(torch.int32)
    idx_list = [int(i) for i in dirty_idx.cpu()]
    a, b = u8.clone(), u8.clone()
    patch_scatter_cuda(a, CB, idx, kbuf)
    patch_scatter_plain(b, CB, idx_list, kbuf)
    check(torch.equal(a, b) and torch.equal(a, u8b), "patch_scatter != plain")
    err = max_abs_err(torch, a, b)
    tail = torch.empty(2_000_003, device=dev, dtype=torch.bfloat16) \
        .normal_(generator=g)
    t_u8 = tail.view(torch.uint8)
    t_n = -(-t_u8.numel() // CB)
    t_idx = [0, t_n - 1]                     # includes the ragged last chunk
    t_rows = torch.randint(-2**31, 2**31 - 1, (2, CB // 4), device=dev,
                           dtype=torch.int32, generator=g)
    ta, tb = t_u8.clone(), t_u8.clone()
    patch_scatter_cuda(ta, CB, torch.tensor(t_idx, dtype=torch.int32,
                                            device=dev), t_rows)
    patch_scatter_plain(tb, CB, t_idx, t_rows)
    check(torch.equal(ta, tb), "patch_scatter != plain on a ragged tail")
    words_view = a.view(torch.int32).view(n, CB // 4)
    lib_idx = dirty_idx.to(torch.int64)
    words_view.index_copy_(0, lib_idx, kbuf)
    check(torch.equal(a, b), "index_copy_ disagrees with the scatter")
    k_rows = idx.numel()
    b_ms, b_by = bound(2 * k_rows * CB + 4 * k_rows, 0)
    scatter = lambda: patch_scatter_cuda(a, CB, idx, kbuf)      # noqa: E731
    copy = lambda: words_view.index_copy_(0, lib_idx, kbuf)    # noqa: E731
    dev_t = device_ms(torch, {"kernel": scatter, "library": copy}, 50,
                      cold=True)
    rows_out.append({
        "name": "patch_scatter", "route": "cuda",
        "source": "src/repro_torch/csrc/patch_scatter.cu",
        "replaces": "src/repro/kernels/patch_scatter/kernel.py:55",
        "max_abs_err": err,
        "ms": dev_t["kernel"]["median"],
        "plain_ms": time_ms(torch, lambda: patch_scatter_plain(
            b, CB, idx_list, kbuf), 10),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": dev_t["library"]["median"],
        "host_ms": time_ms(torch, scatter, 50),
        "host_library_ms": time_ms(torch, copy, 50),
        "device": dev_t,
        "shape": f"{k_rows} chunks of 1 MiB into fp32 [{VOCAB}, {D_MODEL}]"})
    check(torch.equal(a, b), "patch_scatter / index_copy_ replays changed "
                             "the bytes")
    # -- block_diff: the embedding before and after the slice re-init (the
    #    shape Phase 4 verifies), a stacked bf16 weight, ragged / unaligned
    kf = block_diff_cuda(u8, u8b, CB)
    pf = block_diff_plain(u8, u8b, CB)
    check(torch.equal(kf, pf) and int(kf.sum()) == kcount,
          f"block_diff != plain ({int(kf.sum())} vs {kcount} dirty)")
    errs = [max_abs_err(torch, kf, pf)]
    wq = torch.empty((N_LAYERS, D_MODEL, N_HEADS, HEAD_DIM), device=dev,
                     dtype=torch.bfloat16).normal_(generator=g)
    wq2 = wq.clone()
    wq2[5, 100, 3] += 1
    wq2[-1, -1, -1, -1] += 1
    odd2 = odd_bf16.clone()
    odd2[-1] += 1
    raw2 = raw.clone()
    raw2[::1_000_000] ^= 1
    for x, y in ((wq, wq2), (odd_bf16, odd2), (raw, raw2)):
        xu, yu = x.reshape(-1).view(torch.uint8), y.reshape(-1).view(
            torch.uint8)
        for cb in (1 << 16, CB):
            kx, px = block_diff_cuda(xu, yu, cb), block_diff_plain(xu, yu, cb)
            check(torch.equal(kx, px) and int(kx.sum()) > 0,
                  f"block_diff != plain on {tuple(x.shape)} {x.dtype}, "
                  f"{cb}-byte chunks")
            errs.append(max_abs_err(torch, kx, px))
    b_ms, b_by = bound(2 * nbytes + 4 * n, 2 * words)
    d_flags = torch.zeros((n,), dtype=torch.int32, device=dev)
    d_splits = _lib.splits_for(n, CB)

    def diff_raw():
        d_flags.zero_()
        _lib.call("kishu_block_diff", u8.data_ptr(), u8b.data_ptr(), nbytes,
                  CB, d_splits, d_flags.data_ptr(), _lib.stream_of(u8))
    diff_lib = lambda: (u8 != u8b).view(n, -1).any(1)          # noqa: E731
    dev_t = device_ms(torch, {"kernel": diff_raw, "library": diff_lib}, 50,
                      cold=True)
    check(torch.equal(d_flags, kf),
          "block_diff's C entry != the wrapper after the timed replays")
    rows_out.append({
        "name": "block_diff", "route": "cuda",
        "source": "src/repro_torch/csrc/block_diff.cu",
        "replaces": "src/repro/kernels/block_diff/kernel.py:31",
        "max_abs_err": max(errs), "ms": dev_t["kernel"]["median"],
        "host_ms": time_ms(torch, lambda: block_diff_cuda(u8, u8b, CB), 50),
        "plain_ms": time_ms(torch, lambda: block_diff_plain(u8, u8b, CB), 5),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": dev_t["library"]["median"],
        "host_library_ms": time_ms(torch, diff_lib, 20),
        "device": dev_t,
        "shape": f"fp32 [{VOCAB}, {D_MODEL}] vs its re-init, {kcount} of {n} "
                 f"chunks of 1 MiB differ"})
    for r in rows_out:
        r["cold_ms"] = r["device"]["kernel"]["cold"]["median"]
        times = (f"kernel device {spread(r['device']['kernel'])}, host "
                 f"loop {r['host_ms']:.4f} ms")
        if "library" in r["device"]:
            r["library_cold_ms"] = r["device"]["library"]["cold"]["median"]
            times += (f"; library device {spread(r['device']['library'])},"
                      f" host loop {r['host_library_ms']:.4f} ms")
        print(f"phase1 {r['name']}: bit-identical to plain; {r['shape']}; "
              f"{times}; plain {r['plain_ms']:.3f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
        if "random" in r:
            c = r["random"]
            print(f"phase1 {r['name']} random words: {c['stored_planes']} "
                  f"stored planes; kernel device {spread(c['device'])}, "
                  f"host loop {c['host_ms']:.4f} ms; bound "
                  f"{c['bound_ms']:.4f} ms ({c['bound_by']})", flush=True)
    return rows_out


def flash_cases(torch) -> list:
    """(label, B, S, Hq, Hkv, hd, dtype, causal, v_hd): Phase 5's prefill
    shape first, then Phase 7b's (phi3.5-moe: 32/8 heads of 128), float32,
    full attention, no GQA, qwen3-1.7b's head dim, a ragged S, a long S;
    Phase 7c's MLA prefill (deepseek-v3: 128 heads, q and k of 192, v of
    128 zero-padded to 192, as ``layers._mla_attend`` hands it over),
    Phase 7d's encoder (whisper: S 1500, not a multiple of the tile) and
    decoder prefill, stablelm-12b's head dim 160, and Phase 9's sharded
    prefill (S 64: one partial tile).  ``v_hd`` < hd zeroes v's last
    hd - v_hd columns."""
    bf, f32 = torch.bfloat16, torch.float32
    b, s, hq, hkv = SERVE_BATCH, SERVE_PROMPT, N_HEADS, N_KV
    return [("main", b, s, hq, hkv, HEAD_DIM, bf, True, HEAD_DIM),
            ("phi35_moe_prefill", MOE_BATCH, MOE_PROMPT, 32, 8, 128, bf,
             True, 128),
            ("float32", b, s, hq, hkv, HEAD_DIM, f32, True, HEAD_DIM),
            ("full", b, s, hq, hkv, HEAD_DIM, bf, False, HEAD_DIM),
            ("n_rep_1", b, s, hq, hq, HEAD_DIM, bf, True, HEAD_DIM),
            ("hd_128", b, s, 16, 8, 128, bf, True, 128),
            ("ragged", b, s + 5, hq, hkv, HEAD_DIM, bf, True, HEAD_DIM),
            ("long", 1, 4096, hq, hkv, HEAD_DIM, bf, True, HEAD_DIM),
            ("deepseek_mla_prefill", MLA_BATCH, MLA_PROMPT, 128, 128, 192,
             bf, True, 128),
            ("whisper_encoder", ENC_BATCH, ENC_FRAMES, 20, 20, 64, bf, True,
             64),
            ("whisper_decoder_prefill", ENC_BATCH, ENC_PROMPT, 20, 20, 64,
             bf, True, 64),
            ("stablelm_hd_160", 8, 512, 32, 8, 160, bf, True, 160),
            ("phase9_sharded_prefill", SHARD_BATCH, SHARD_PROMPT, hq, hkv,
             HEAD_DIM, bf, True, HEAD_DIM)]


def phase1_chunk_key(torch, dev, workdir=None) -> dict:
    """The chunk_key kernel against hashlib (``chunkstore.chunk_keys``, on
    the pool's threads) at each of KEY_CHUNKS chunks of 1 MiB, the last
    ragged: device time of the C entry warm and cold, the wrapper's host
    loop (with its read-back), hashlib's time over the same bytes on the
    host, the bound by operations and one chain's least time."""
    from repro_torch.core.chunkstore import chunk_keys
    from repro_torch.kernels import _lib
    from repro_torch.kernels.chunk_key.ops import (chunk_key_digests,
                                                   hex_keys)
    g = torch.Generator(device=dev).manual_seed(3)
    tail = 12345                         # the last chunk's bytes short
    u8 = torch.randint(0, 256, (max(KEY_CHUNKS) * CB - tail,), device=dev,
                       dtype=torch.uint8, generator=g)
    host = u8.cpu().numpy().tobytes()
    view = memoryview(host)
    sizes = {}
    for n in KEY_CHUNKS:
        x = u8[:n * CB - tail]
        nbytes = x.numel()
        before = _lib.launches()["chunk_key"]
        got = hex_keys(chunk_key_digests(x, CB))
        check(_lib.launches()["chunk_key"] == before + 1,
              "chunk_key: the wrapper did not launch once")
        chunks = [view[i * CB:min((i + 1) * CB, nbytes)] for i in range(n)]
        plain = []
        for _ in range(3):
            t0 = time.perf_counter()
            want = chunk_keys(chunks)
            plain.append((time.perf_counter() - t0) * 1e3)
        bad = sum(a != b for a, b in zip(got, want))
        check(bad == 0 and len(got) == n,
              f"chunk_key != hashlib in {bad} of {n} chunks")
        idx = torch.arange(n, dtype=torch.int64, device=dev)
        out = torch.empty((n, 16), dtype=torch.uint8, device=dev)

        def key_raw(x=x, idx=idx, out=out, n=n):
            _lib.call("kishu_chunk_key", x.data_ptr(), x.numel(), CB,
                      idx.data_ptr(), n, out.data_ptr(), _lib.stream_of(x))
        dev_t = device_ms(torch, {"kernel": key_raw}, 3, rounds=3,
                          cold=True)
        check(hex_keys(out.cpu().numpy()) == want,
              "chunk_key's C entry != hashlib after the timed replays")
        blocks = sum(-(-len(c) // 128) for c in chunks)
        b_ms, b_by = bound(nbytes + 24 * n, blocks * KEY_OPS_PER_BLOCK)
        sizes[n] = {
            "ms": dev_t["kernel"]["median"],
            "cold_ms": dev_t["kernel"]["cold"]["median"],
            "device": dev_t,
            "host_ms": time_ms(torch, lambda x=x: chunk_key_digests(x, CB),
                               3),
            "plain_ms": min(plain), "plain_samples": plain,
            "bound_ms": b_ms, "bound_by": b_by,
            "chain_ms": CB // 128 * KEY_OPS_PER_BLOCK
            * ALU_CYCLES_PER_WARP_OP / SM_CLOCK_HZ * 1e3,
            "shape": f"{n} chunks of 1 MiB, the last {CB - tail} bytes"}
        r = sizes[n]
        print(f"phase1 chunk_key: equals hashlib; {r['shape']}; kernel "
              f"device {spread(r['device']['kernel'])}, host loop "
              f"{r['host_ms']:.4f} ms; hashlib on the pool "
              f"{r['plain_ms']:.3f} ms; bound {b_ms:.4f} ms ({b_by}); one "
              f"chain {r['chain_ms']:.3f} ms", flush=True)
    del u8, host, view
    first = sizes[KEY_CHUNKS[0]]
    return {"name": "chunk_key", "route": "cuda",
            "source": "src/repro_torch/csrc/chunk_key.cu",
            "replaces": None, "max_abs_err": 0,
            "library_ms": None, **first,
            "sizes": {str(n): r for n, r in sizes.items()}}


def phase1_flash(torch, dev) -> dict:
    """The flash kernel against its plain version at each shape of
    :func:`flash_cases`, on each route that takes the inputs (bf16: the
    tensor-core route "tc" and the FMA route; float32: FMA only); device
    and host-loop times of each route and of SDPA, the plain version's
    time and the bound of each."""
    import torch.nn.functional as F
    from repro_torch.kernels import _lib
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_cuda,
                                                     flash_attention_plain,
                                                     flash_route)
    # tolerance against the plain version: float32 atol 1e-5 / rtol 1e-4
    # (summation order); bf16 atol 1e-5 / rtol 2**-7, one unit in the last
    # place: both compute one float32 value up to summation order, and its
    # one rounding to bf16 may land on neighbouring values
    tol = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-5, 2 ** -7)}
    g = torch.Generator(device=dev).manual_seed(2)
    checks = []
    for label, b, s, hq, hkv, hd, dtype, causal, v_hd in flash_cases(torch):
        q, k, v = (torch.randn((b, s, h, hd), device=dev, generator=g)
                   .to(dtype) for h in (hq, hkv, hkv))
        v[..., v_hd:] = 0
        want_route = "tc" if dtype == torch.bfloat16 else "fma"
        check(flash_route(q, k, v) == want_route,
              f"flash_attention {label}: route {flash_route(q, k, v)}")
        before = _lib.route_launches()["flash_attention"][want_route]
        flash_attention(q, k, v, causal=causal)
        check(_lib.route_launches()["flash_attention"][want_route]
              == before + 1, f"flash_attention {label}: the default call "
                             f"did not take the {want_route} route")
        want = flash_attention_plain(q, k, v, causal=causal).float()
        atol, rtol = tol[dtype]
        routes = ("tc", "fma") if want_route == "tc" else ("fma",)
        errs = {}
        for route in routes:
            got = flash_attention_cuda(q, k, v, causal=causal, route=route)
            diff = (got.float() - want).abs()
            errs[route] = float(diff.max())
            check(bool((diff <= atol + rtol * want.abs()).all()),
                  f"flash_attention {label} {route}: max abs error "
                  f"{errs[route]} outside atol {atol} + rtol {rtol}")
            check(not causal or torch.equal(
                got[:, 0], v[:, 0].repeat_interleave(hq // hkv, dim=1)),
                f"flash_attention {label} {route}: causal row 0 is not v[0]")
            del got, diff
        pairs = s * (s + 1) // 2 if causal else s * s
        flops = 4 * b * hq * hd * pairs
        nbytes = b * s * (2 * hq + 2 * hkv) * hd * q.element_size()
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S
                           if dtype == torch.bfloat16 else FP32_FLOPS_PER_S)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        fns = {r: (lambda r=r: flash_attention_cuda(q, k, v, causal=causal,
                                                    route=r))
               for r in routes}
        fns["sdpa"] = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)
        if v_hd < hd:          # the library's MLA call: v unpadded
            fns["sdpa_v_unpadded"] = lambda: F.scaled_dot_product_attention(
                qt, kt, vt[..., :v_hd], is_causal=causal, enable_gqa=True)
        iters = 5 if s > 1024 else 20
        dev_t = device_ms(torch, fns, iters, cold=label == "main")
        checks.append({
            "label": label, "shape": [b, s, hq, hkv, hd], "v_hd": v_hd,
            "dtype": str(dtype).replace("torch.", ""), "causal": causal,
            "route": want_route, "max_abs_err": errs[want_route],
            "max_abs_err_by_route": errs, "atol": atol, "rtol": rtol,
            "ms": dev_t[want_route]["median"],
            "library_ms": dev_t["sdpa"]["median"],
            "device": dev_t,
            "host": {n: time_ms(torch, fn, iters) for n, fn in fns.items()},
            "plain_ms": time_ms(torch, lambda: flash_attention_plain(
                q, k, v, causal=causal), 3),
            "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
            "bytes": nbytes})
        del q, k, v, want, qt, kt, vt, fns
    for c in checks:
        times = "; ".join(
            f"{n} device {spread(c['device'][n])}, host loop "
            f"{c['host'][n]:.4f} ms" for n in c["device"])
        print(f"phase1 flash_attention {c['label']}: B,S,Hq,Hkv,hd "
              f"{c['shape']} {c['dtype']} causal={c['causal']}; max abs err "
              f"{c['max_abs_err_by_route']} (atol {c['atol']} rtol "
              f"{c['rtol']}); {times}; plain {c['plain_ms']:.3f} ms, bound "
              f"{c['bound_ms']:.4f} ms ({c['bound_by']})", flush=True)
    main = checks[0]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:99",
            **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")},
            "cold_ms": main["device"][main["route"]]["cold"]["median"],
            "library_cold_ms": main["device"]["sdpa"]["cold"]["median"],
            "shape": f"bf16 B,S,Hq,Hkv,hd {main['shape']} causal, tc route",
            "checks": checks}


# ---------------------------------------------------------------------------
# Phase 2: the main path
# ---------------------------------------------------------------------------

def make_state(torch, dev, n_layers: int = N_LAYERS) -> dict:
    g = torch.Generator(device=dev).manual_seed(0)
    params, m, v = {}, {}, {}
    for name, shape in param_shapes(n_layers).items():
        if name.endswith("norm"):
            params[name] = torch.ones(shape, device=dev)
        else:
            params[name] = torch.empty(shape, device=dev).normal_(
                0, 0.02, generator=g)
        m[name] = torch.empty(shape, device=dev).normal_(0, 1e-3,
                                                         generator=g)
        v[name] = torch.empty(shape, device=dev).normal_(
            0, 1e-3, generator=g).square_()
    return {"params": params, "opt": {"m": m, "v": v}}


def finetune_top(ns, step: int, layers=None) -> None:
    """One in-place AdamW-style step on layers 28-31 (or ``layers``):
    params, m, v."""
    import torch
    g = None
    for name in top_names(TOP_LAYERS if layers is None else layers):
        p = ns[f"params/{name}"]
        if g is None:
            g = torch.Generator(device=p.device).manual_seed(1000 + step)
        m, v = ns[f"opt/m/{name}"], ns[f"opt/v/{name}"]
        grad = torch.empty_like(p).normal_(0, 1e-2, generator=g)
        m.mul_(0.9).add_(grad, alpha=0.1)
        v.mul_(0.999).addcmul_(grad, grad, value=0.001)
        p.addcdiv_(m, v.sqrt().add_(1e-8), value=-1e-4)


def reinit_vocab_slice(ns, lo: int, hi: int, seed: int = 7) -> None:
    """Re-initialise embedding rows [lo, hi) and zero their moments."""
    import torch
    emb = ns["params/embed"]
    g = torch.Generator(device=emb.device).manual_seed(seed)
    emb[lo:hi].normal_(0, 0.02, generator=g)
    ns["opt/m/embed"][lo:hi].zero_()
    ns["opt/v/embed"][lo:hi].zero_()


def tensor_snapshot(torch, ns) -> dict:
    return {n: ns[n].clone() for n in ns.names()
            if isinstance(ns[n], torch.Tensor)}


def same_state(torch, sess, snap) -> bool:
    return sorted(sess.ns.names()) == sorted(snap) and all(
        torch.equal(sess.ns[n], snap[n]) for n in snap)


def phase2(torch, dev, workdir: Path) -> dict:
    from repro_torch.core import KishuSession, open_store
    from repro_torch.kernels import _lib

    rec: dict = {}
    state = make_state(torch, dev)
    n_tensors = sum(len(d) for d in (state["params"], state["opt"]["m"],
                                     state["opt"]["v"]))
    state_bytes = sum(t.numel() * t.element_size()
                      for d in (state["params"], state["opt"]["m"],
                                state["opt"]["v"]) for t in d.values())
    rec["tensors"], rec["state_bytes"] = n_tensors, state_bytes
    print(f"phase2 state: {n_tensors} tensors, {state_bytes} bytes on "
          f"{dev}", flush=True)
    check(n_tensors == 3 * len(param_shapes()), f"{n_tensors} tensors")
    n_top = 3 * len(top_names())             # params, m, v of layers 28-31
    sess = KishuSession(open_store(f"dir://{workdir}/cas"), chunk_bytes=CB,
                        trace=True)
    tracer = sess.obs.tracer

    def stages() -> dict:
        """Seconds per span name since the last call (host clock)."""
        out = tracer.stage_totals()
        tracer.clear()
        return out

    check(sess.device.type == "cuda", "the session did not default to cuda")
    sess.register("finetune_top", finetune_top)
    sess.register("reinit_vocab_slice", reinit_vocab_slice)
    try:
        _lib.reset_launches()
        t0 = time.perf_counter()
        c_attach = sess.init_state(state)
        torch.cuda.synchronize()
        rec["attach_s"] = time.perf_counter() - t0
        rec["attach_stages"] = stages()
        w = sess.last_run.write
        rec["attach"] = {"bytes_serialized": w.bytes_serialized,
                         "bytes_written": w.bytes_written,
                         "chunks_written": w.chunks_written}
        del state
        snap0 = tensor_snapshot(torch, sess.ns)

        t0 = time.perf_counter()
        c_ft = sess.run("finetune_top", step=1)
        rec["finetune_top_s"] = time.perf_counter() - t0
        rec["finetune_top_stages"] = stages()
        w = sess.last_run.write
        rec["finetune_top"] = {
            "covs_updated": sess.last_run.covs_updated,
            "bytes_serialized": w.bytes_serialized,
            "bytes_dev2host": w.bytes_dev2host,
            "bytes_written": w.bytes_written, "covs_packed": w.covs_packed}
        check(sess.last_run.covs_updated == n_top,
              f"finetune_top updated {sess.last_run.covs_updated} covs")

        for label, (lo, hi) in (("reinit_vocab_slice", VOCAB_ROWS),
                                ("reinit_vocab_slice_mid", VOCAB_ROWS_MID)):
            t0 = time.perf_counter()
            c_vocab = sess.run("reinit_vocab_slice", lo=lo, hi=hi)
            rec[f"{label}_s"] = time.perf_counter() - t0
            rec[f"{label}_stages"] = stages()
            w = sess.last_run.write
            rec[label] = {
                "rows": [lo, hi - 1], "commit": c_vocab,
                "covs_updated": sess.last_run.covs_updated,
                "covs_packed": w.covs_packed,
                "bytes_serialized": w.bytes_serialized,
                "bytes_dev2host": w.bytes_dev2host,
                "bytes_written": w.bytes_written,
                "chunks_written": w.chunks_written,
                "chunks_encoded": w.chunks_encoded,
                "chunks_codec_skipped": w.chunks_codec_skipped}
            check(w.covs_packed == 3, f"{label}: {rec[label]}")
        check(rec["reinit_vocab_slice"]["chunks_encoded"] > 0,
              f"aligned vocab slice encoded no chunk: "
              f"{rec['reinit_vocab_slice']}")
        snap2 = tensor_snapshot(torch, sess.ns)

        def checkout(label: str, target: str, snap: dict) -> None:
            t0 = time.perf_counter()
            st = sess.checkout(target)
            torch.cuda.synchronize()
            rec[f"{label}_s"] = time.perf_counter() - t0
            rec[f"{label}_stages"] = stages()
            rec[label] = {"covs_loaded": st.covs_loaded,
                          "covs_patched": st.covs_patched,
                          "covs_scattered": st.covs_scattered,
                          "chunks_patched": st.chunks_patched,
                          "bytes_loaded": st.bytes_loaded,
                          "bytes_cached": st.bytes_cached,
                          "bytes_host2dev": st.bytes_host2dev}
            check(st.covs_scattered == 3 and st.covs_loaded == n_top + 3,
                  f"{label}: {rec[label]}")
            check(same_state(torch, sess, snap),
                  f"{label}: state not bit-identical")
            print(f"phase2 {label}: {rec[f'{label}_s']:.3f} s, all "
                  f"{len(snap)} tensors bit-identical; {rec[label]}; "
                  f"stages {rec[f'{label}_stages']}", flush=True)

        checkout("checkout_back", c_attach, snap0)
        checkout("checkout_forward", c_vocab, snap2)
        del snap2
        # the cycle reinit_vocab_slice -> checkout back -> checkout forward,
        # twice more: each from the finetune_top state (an untimed checkout
        # there), with a fresh seed, so each commit re-initialises the rows
        # and zeroes their moments as the first did
        cycles = [{k: rec[f"{k}_s"] for k in (
            "reinit_vocab_slice", "checkout_back", "checkout_forward")}]
        cycles[0]["encode_dev"] = \
            rec["reinit_vocab_slice_stages"].get("encode_dev", 0.0)
        for rep in (1, 2):
            sess.checkout(c_ft)
            stages()
            lo, hi = VOCAB_ROWS
            t0 = time.perf_counter()
            c_rep = sess.run("reinit_vocab_slice", lo=lo, hi=hi, seed=7 + rep)
            label = f"reinit_vocab_slice_{rep}"
            rec[f"{label}_s"] = time.perf_counter() - t0
            rec[f"{label}_stages"] = stages()
            w = sess.last_run.write
            rec[label] = {"covs_packed": w.covs_packed,
                          "bytes_dev2host": w.bytes_dev2host,
                          "bytes_written": w.bytes_written,
                          "chunks_encoded": w.chunks_encoded,
                          "chunks_codec_skipped": w.chunks_codec_skipped}
            check(w.covs_packed == 3 and w.chunks_encoded > 0,
                  f"{label}: {rec[label]}")
            print(f"phase2 {label}: {rec[f'{label}_s']:.3f} s; "
                  f"{rec[label]}; stages {rec[f'{label}_stages']}",
                  flush=True)
            snap = tensor_snapshot(torch, sess.ns)
            checkout(f"checkout_back_{rep}", c_attach, snap0)
            checkout(f"checkout_forward_{rep}", c_rep, snap)
            del snap
            cycles.append({k: rec[f"{k}_{rep}_s"] for k in (
                "reinit_vocab_slice", "checkout_back", "checkout_forward")})
            cycles[-1]["encode_dev"] = \
                rec[f"{label}_stages"].get("encode_dev", 0.0)
        rec["cycles"] = cycles
        for i, c in enumerate(cycles):
            over = [k for k, v in c.items() if v >= 1.0]
            print(f"phase2 cycle {i}: reinit_vocab_slice "
                  f"{c['reinit_vocab_slice']:.3f} s (encode_dev "
                  f"{c['encode_dev'] * 1e3:.3f} ms), checkout back "
                  f"{c['checkout_back']:.3f} s, checkout forward "
                  f"{c['checkout_forward']:.3f} s; at or over 1 s: {over}",
                  flush=True)
        rec["commits"] = [c_attach, c_ft,
                          rec["reinit_vocab_slice"]["commit"], c_vocab]
        rec["launches"] = _lib.launches()
    finally:
        sess.close()
    for key in ("attach", "finetune_top", "reinit_vocab_slice",
                "reinit_vocab_slice_mid"):
        print(f"phase2 {key}: {rec[f'{key}_s']:.3f} s; {rec[key]}; "
              f"stages {rec[f'{key}_stages']}", flush=True)
    print(f"phase2 kernels: {json.dumps(rec['launches'])}", flush=True)
    missing = [k for k in COMMIT_PATH_KERNELS if rec["launches"][k] <= 0]
    check(not missing, f"kernels never launched on the main path: {missing}")
    return rec


# ---------------------------------------------------------------------------
# Phase 3: a CUDA session against a CPU session on a small input
# ---------------------------------------------------------------------------

def phase3(torch) -> dict:
    from repro_torch.core import KishuSession, MemoryStore

    def cells(device):
        def init(ns):
            g = torch.Generator(device="cpu").manual_seed(3)
            ns["w"] = torch.randn(300_000, generator=g).to(device)
            ns["h"] = torch.randn(200_001, generator=g).to(device) \
                .to(torch.bfloat16)
            ns["u"] = torch.randint(0, 256, (77_777,), generator=g,
                                    dtype=torch.uint8).to(device)

        def step(ns, k):
            ns["w"][16384 * k: 16384 * (k + 1)] = 0.0
            ns["h"][::50_000] = float(k)
            ns["u"][5:9] = k
        return init, step

    out = {}
    for device in ("cpu", "cuda"):
        store = MemoryStore()
        s = KishuSession(store, chunk_bytes=1 << 16, cache_bytes=0,
                         device=device)
        init, step = cells(device)
        s.register("init", init)
        s.register("step", step)
        s.init_state({})
        c0 = s.run("init")
        cids = [s.run("step", k=k) for k in (1, 2, 3)]
        s.checkout(c0)
        back = {n: s.ns[n].cpu().clone() for n in s.ns.names()}
        s.checkout(cids[-1])
        fwd = {n: s.ns[n].cpu().clone() for n in s.ns.names()}
        out[device] = (dict(store.chunks), back, fwd)
        s.close()
    check(out["cpu"][0] == out["cuda"][0],
          "CUDA and CPU sessions wrote different stores")
    for i in (1, 2):
        for n, t in out["cpu"][i].items():
            check(torch.equal(t, out["cuda"][i][n]),
                  f"CUDA and CPU sessions restored {n} differently")
    frames = sum(1 for v in out["cuda"][0].values() if v[:5] == b"KZC1\x04")
    print(f"phase3: CUDA session store == CPU session store "
          f"({len(out['cpu'][0])} chunks, {frames} device-encoded frames); "
          f"checkouts identical", flush=True)
    return {"chunks": len(out["cpu"][0]), "frames": frames}


# ---------------------------------------------------------------------------
# Phase 4: the trainer path (SmolLM-360M, full size)
# ---------------------------------------------------------------------------

def verify_exact(torch, ns, snap, label: str) -> float:
    """Every tensor of ``ns`` bit-identical to ``snap``, by the block_diff
    kernel (``delta.exact_dirty_indices``).  A :func:`host_snapshot` leaf
    is copied back to the card alone and held against the live local
    shard.  Returns the seconds taken."""
    from torch.distributed.tensor import DTensor
    from repro_torch.core.delta import exact_dirty_indices
    t0 = time.perf_counter()
    names = sorted(n for n in ns.names() if isinstance(ns[n], torch.Tensor))
    check(names == sorted(snap), f"{label}: tensor names differ")
    bad = {}
    for n in names:
        x, want = ns[n], snap[n]
        if want.device != x.device:
            x = x.to_local() if isinstance(x, DTensor) else x
            want = want.to(x.device)
        d = exact_dirty_indices(x, want, CB)
        if d:
            bad[n] = d[:4]
    check(not bad, f"{label}: not bit-identical: {bad}")
    return time.perf_counter() - t0


def phase4(torch, dev, workdir: Path) -> dict:
    from repro_torch.core import open_store
    from repro_torch.kernels import _lib
    from repro_torch.models.config import get_config
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import ManagedTrainingSession, resume

    cfg = get_config("smollm-360m")            # full width and depth
    opt = AdamWConfig(lr=1e-3)                  # the launcher's default lr
    url = f"dir://{workdir}/train_cas"
    kw = dict(global_batch=8, seq_len=128, chunk_bytes=CB)
    embed, head = "state/params/embed", "state/params/lm_head"
    rec: dict = {"arch": cfg.name, **kw, "steps_per_phase": 2}
    sess = ManagedTrainingSession(cfg, opt, open_store(url), **kw)
    check(sess.device.type == "cuda", "the trainer did not default to cuda")
    sess.kishu.obs.tracer.enabled = True

    def timed(label: str, fn):
        sess.kishu.obs.tracer.clear()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        rec[f"{label}_s"] = time.perf_counter() - t0
        rec[f"{label}_stages"] = sess.kishu.obs.tracer.stage_totals()
        return out

    def commit_rec(label: str) -> None:
        r = sess.kishu.last_run
        w = r.write
        rec[label] = {"covs_updated": r.covs_updated,
                      "bytes_serialized": w.bytes_serialized,
                      "bytes_dev2host": w.bytes_dev2host,
                      "bytes_written": w.bytes_written,
                      "chunks_written": w.chunks_written,
                      "covs_packed": w.covs_packed,
                      "loss": sess.ns.get("metrics/last_loss")}

    def checkout_rec(label: str, st) -> None:
        rec[label] = {"covs_loaded": st.covs_loaded,
                      "covs_patched": st.covs_patched,
                      "bytes_loaded": st.bytes_loaded,
                      "bytes_cached": st.bytes_cached,
                      "bytes_host2dev": st.bytes_host2dev}

    _lib.reset_launches()
    try:
        c0 = timed("attach", lambda: sess.attach(seed=0))
        commit_rec("attach")
        params = [sess.ns[n] for n in sess.ns.names()
                  if n.startswith("state/params/") and n != head]
        n_params = sum(t.numel() for t in params)
        tensors = {id(sess.ns[n]): sess.ns[n] for n in sess.ns.names()
                   if isinstance(sess.ns[n], torch.Tensor)}
        rec["params"] = n_params
        rec["state_bytes"] = sum(t.numel() * t.element_size()
                                 for t in tensors.values())
        rec["tensors"] = len(tensors)
        check(n_params == 361_821_120, f"{n_params} parameters")
        check(all(t.dtype == torch.bfloat16 for t in params)
              and sess.ns["state/opt/mu/embed"].dtype == torch.float32,
              "params must be bf16 and moments fp32")
        check(sess.ns[embed] is sess.ns[head], "lm_head is not embed")
        print(f"phase4 state: {cfg.name}, {n_params} bf16 params + fp32 "
              f"moments, {rec['tensors']} tensors, {rec['state_bytes']} "
              f"bytes on {dev}", flush=True)

        c1 = timed("train_1", lambda: sess.train(2))
        commit_rec("train_1")
        loss1 = rec["train_1"]["loss"]
        s1 = tensor_snapshot(torch, sess.ns)

        c2 = timed("set_lr", lambda: sess.set_lr(opt.lr / 2))
        commit_rec("set_lr")
        rec["verify_set_lr_s"] = verify_exact(torch, sess.ns, s1, "set_lr")
        idx1 = sess.kishu.graph.nodes[c1].state_index
        idx2 = sess.kishu.graph.nodes[c2].state_index
        moved = sorted(k for k in idx2 if idx2[k] != idx1.get(k))
        check(sess.kishu.last_run.covs_updated == 1
              and moved == ["hparams/lr"]
              and rec["set_lr"]["bytes_written"] < 200,
              f"the LR-only commit wrote more than hparams/lr: {moved}, "
              f"{rec['set_lr']}")

        c3 = timed("train_2", lambda: sess.train(2))
        commit_rec("train_2")
        loss3 = rec["train_2"]["loss"]
        check(loss3 == loss3 and loss1 == loss1 and loss3 < loss1,
              f"loss not finite and falling: {loss1} then {loss3}")
        s3 = tensor_snapshot(torch, sess.ns)
        c4 = timed("evaluate", lambda: sess.evaluate(1))
        commit_rec("evaluate")
        rec["eval_loss"] = sess.eval_loss()

        for label, target, snap in (("checkout_back", c1, s1),
                                     ("checkout_forward", c3, s3)):
            st = timed(label, lambda t=target: sess.checkout(t))
            checkout_rec(label, st)
            rec[f"verify_{label}_s"] = verify_exact(torch, sess.ns, snap,
                                                   label)
            check(sess.ns[embed] is sess.ns[head],
                  f"{label}: lm_head is not embed")
        del s3
        # train replay: from the parent of the first train commit, train(2)
        # again must reproduce that commit's state bit for bit (Kishu's
        # fallback recomputation replays commands and relies on this)
        st = timed("checkout_parent", lambda: sess.checkout(c0))
        checkout_rec("checkout_parent", st)
        c5 = timed("train_replay", lambda: sess.train(2))
        commit_rec("train_replay")
        rec["verify_train_replay_s"] = verify_exact(
            torch, sess.ns, s1, "train(2) replayed from its parent")
        check(rec["train_replay"]["loss"] == loss1,
              f"replayed loss {rec['train_replay']['loss']} != {loss1}")
        docs = [sess.kishu.graph.nodes[c].stats for c in (c1, c5)]
        check(docs[0].get("replay_safe") is True
              and docs[1].get("replay_safe") is True,
              f"replay_safe in the train commits' docs: {docs}")
        # on the card exec_s ends after the device has finished the cell
        rec["train_exec_s"] = [docs[0]["exec_s"], docs[1]["exec_s"]]
        rec["commits"] = [c0, c1, c2, c3, c4, c5]
    finally:
        sess.close()
    # the resumed session traces from its first load (KISHU_TRACE=1)
    prev = os.environ.get("KISHU_TRACE")
    os.environ["KISHU_TRACE"] = "1"
    try:
        t0 = time.perf_counter()
        r = resume(cfg, opt, open_store(url), **kw)
        torch.cuda.synchronize()
        rec["resume_s"] = time.perf_counter() - t0
    finally:
        if prev is None:
            os.environ.pop("KISHU_TRACE", None)
        else:
            os.environ["KISHU_TRACE"] = prev
    rec["resume_stages"] = r.kishu.obs.tracer.stage_totals()
    try:
        check(r.kishu.head == c5, f"resumed at {r.kishu.head}, not {c5}")
        rec["verify_resume_s"] = verify_exact(torch, r.ns, s1, "resume")
        check(r.ns[embed] is r.ns[head], "resume: lm_head is not embed")
        rec["launches"] = _lib.launches()
    finally:
        r.close()

    for key in ("attach", "train_1", "set_lr", "train_2", "evaluate",
                "train_replay"):
        print(f"phase4 {key}: {rec[f'{key}_s']:.3f} s; {rec[key]}; "
              f"stages {rec[f'{key}_stages']}", flush=True)
    print(f"phase4 train replay: checkout of the parent "
          f"{rec['checkout_parent_s']:.3f} s ({rec['checkout_parent']}), "
          f"then train(2) again: every tensor bit-identical to the first "
          f"train commit (block_diff, {rec['verify_train_replay_s']:.3f} s), "
          f"loss {rec['train_replay']['loss']}", flush=True)
    for key in ("checkout_back", "checkout_forward"):
        print(f"phase4 {key}: {rec[f'{key}_s']:.3f} s, every tensor "
              f"bit-identical (block_diff, {rec[f'verify_{key}_s']:.3f} s); "
              f"{rec[key]}; stages {rec[f'{key}_stages']}", flush=True)
    print(f"phase4 resume: {rec['resume_s']:.3f} s, every tensor "
          f"bit-identical (block_diff, {rec['verify_resume_s']:.3f} s); "
          f"stages {rec['resume_stages']}", flush=True)
    print(f"phase4 set_lr: no tensor changed (block_diff, "
          f"{rec['verify_set_lr_s']:.3f} s); eval loss {rec['eval_loss']}",
          flush=True)
    print(f"phase4 kernels: {json.dumps(rec['launches'])}", flush=True)
    print(f"phase4 exec_s of the two train(2) commits (device time "
          f"included): {rec['train_exec_s']}", flush=True)
    missing = [k for k in TRAINER_PATH_KERNELS if rec["launches"][k] <= 0]
    check(not missing, f"kernels never launched on the trainer path: "
                       f"{missing}")
    return rec, s1


# ---------------------------------------------------------------------------
# Phase 4b: the checkout planner on Cell B (SmolLM-360M, full size)
# ---------------------------------------------------------------------------

PLAN_MODES = ("fetch", "replay", "auto")


def plan_summary(lines: list) -> list:
    """The head and the tail of ``format_plan``'s lines (the per-co-variable
    rows go to the JSON record)."""
    return lines[:2] + lines[-1:]


def phase4b(torch, dev, workdir: Path, rec4: dict, snap1: dict) -> dict:
    """For each planner mode, a trainer session over Phase 4's store (the
    trainer reads $KISHU_PLANNER) resumes at the head and checks out the
    first train commit; block_diff holds the result against Phase 4's
    snapshot of that commit."""
    from repro_torch.core.planner import format_plan
    from repro_torch.kernels import _lib
    from repro_torch.models.config import get_config
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import resume
    from repro_torch.core import open_store

    cfg = get_config("smollm-360m")
    opt = AdamWConfig(lr=1e-3)
    url = f"dir://{workdir}/train_cas"
    kw = dict(global_batch=8, seq_len=128, chunk_bytes=CB)
    c1, head = rec4["commits"][1], rec4["commits"][-1]
    rec: dict = {"target": c1, "head": head}
    prev = os.environ.get("KISHU_PLANNER")
    _lib.reset_launches()
    try:
        for mode in PLAN_MODES:
            os.environ["KISHU_PLANNER"] = mode
            t0 = time.perf_counter()
            r = resume(cfg, opt, open_store(url), **kw)
            torch.cuda.synchronize()
            resume_s = time.perf_counter() - t0
            try:
                check(r.kishu.plan_mode == mode and r.kishu.head == head,
                      f"{mode}: session at {r.kishu.head}, mode "
                      f"{r.kishu.plan_mode}")
                priced = r.kishu.plan(c1)
                lines = format_plan(priced)
                # `kishu plan` of the same checkout: no live namespace, so
                # fetch against replay for every co-variable, no patch
                code, cli_lines = kishu(["--store", url, "plan", c1,
                                         "--from", head, "--mode", mode])
                check(code == 0, f"{mode}: kishu plan exited {code}")
                t0 = time.perf_counter()
                st = r.checkout(c1)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                verify_s = verify_exact(torch, r.ns, snap1,
                                        f"phase4b {mode} checkout")
                n = priced.counts()
                planned = {"fetch": st.covs_planned_fetch,
                           "patch": st.covs_planned_patch,
                           "replay": st.covs_planned_replay}
                check(planned == n,
                      f"{mode}: the plan {n} is not its execution {planned}")
                if mode == "replay":
                    check(0 < st.covs_recomputed == st.covs_planned_replay,
                          f"replay: {st.covs_recomputed} recomputed of "
                          f"{st.covs_planned_replay} planned")
                if mode == "fetch":
                    check(st.covs_recomputed == 0,
                          f"fetch: {st.covs_recomputed} recomputed")
                check(not r.kishu.restorer._memo,
                      f"{mode}: the replay memo still holds tensors")
                # back to the head (a checkout moves HEAD in the store, and
                # the next mode starts there): the same state, verified too
                t0 = time.perf_counter()
                back = r.checkout(head)
                torch.cuda.synchronize()
                back_s = time.perf_counter() - t0
                verify_exact(torch, r.ns, snap1, f"phase4b {mode} back")
                rec[mode] = {
                    "resume_s": resume_s, "wall_s": wall,
                    "plan_est_s": st.plan_est_s,
                    "est_fetch_s": priced.est_fetch_s,
                    "est_replay_s": priced.est_replay_s,
                    "latency_s": priced.latency_s,
                    "bandwidth_Bps": priced.bandwidth_Bps,
                    "covs_planned": planned,
                    "covs_recomputed": st.covs_recomputed,
                    "covs_loaded": st.covs_loaded,
                    "covs_patched": st.covs_patched,
                    "bytes_loaded": st.bytes_loaded,
                    "bytes_cached": st.bytes_cached,
                    "verify_s": verify_s, "plan_lines": lines,
                    "cli_plan_lines": cli_lines,
                    "back_s": back_s,
                    "back_planned": {"fetch": back.covs_planned_fetch,
                                     "patch": back.covs_planned_patch,
                                     "replay": back.covs_planned_replay},
                    "back_recomputed": back.covs_recomputed}
            finally:
                r.close()
                del r
                torch.cuda.empty_cache()
            x = rec[mode]
            print(f"phase4b {mode}: checkout {head} -> {c1} {wall:.3f} s "
                  f"(plan_est_s {x['plan_est_s']:.3f}); planned "
                  f"{x['covs_planned']}, covs_recomputed "
                  f"{x['covs_recomputed']}, bytes_loaded "
                  f"{x['bytes_loaded']}; block_diff exact "
                  f"({verify_s:.3f} s); resume {resume_s:.3f} s; back to "
                  f"the head {back_s:.3f} s, planned {x['back_planned']}, "
                  f"exact", flush=True)
            for line in plan_summary(lines):
                print(f"phase4b {mode} plan: {line}", flush=True)
            for line in plan_summary(cli_lines):
                print(f"phase4b {mode} kishu plan: {line}", flush=True)
    finally:
        if prev is None:
            os.environ.pop("KISHU_PLANNER", None)
        else:
            os.environ["KISHU_PLANNER"] = prev
    rec["launches"] = _lib.launches()
    print(f"phase4b kernels: {json.dumps(rec['launches'])}", flush=True)
    check(rec["launches"]["block_diff"] > 0,
          "phase4b: no verification went through block_diff")
    return rec


# ---------------------------------------------------------------------------
# The kishu CLI on the card's stores, in process
# ---------------------------------------------------------------------------

def kishu(args: list):
    """(exit code, stdout lines) of the port's kishu CLI, run in process."""
    import contextlib
    import io
    from repro_torch.launch.kishu_cli import main as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = cli(args)
    return code, buf.getvalue().splitlines()


def cli_verbs(url: str, target: str, label: str) -> dict:
    """``log``, ``plan``, ``verify``, ``fsck`` and ``topology`` through the
    port's CLI entry point, each of which must exit 0."""
    rec: dict = {}
    for verb in (["log"], ["plan", target], ["verify"], ["fsck"],
                 ["topology"]):
        t0 = time.perf_counter()
        code, out = kishu(["--store", url] + verb)
        rec[verb[0]] = {"exit": code, "s": time.perf_counter() - t0,
                        "lines": out}
        check(code == 0, f"{label}: kishu {' '.join(verb)} exited {code}: "
                         f"{out[-3:]}")
        print(f"{label} kishu {verb[0]}: exit 0 in "
              f"{rec[verb[0]]['s']:.3f} s; {out[-1] if out else ''}",
              flush=True)
    return rec


# ---------------------------------------------------------------------------
# Phase 6: Cell D, the storage fabric
# ---------------------------------------------------------------------------

FABRIC_LAYERS = 8                    # Cell A's state cut to its first 8
FABRIC_TOP = range(4, 8)             # finetune_top: the last four of them
FABRIC_PATH_KERNELS = ("chunk_hash", "delta_pack", "delta_codec",
                       "patch_scatter", "block_diff")


def wipe_chunks(root: Path) -> None:
    shutil.rmtree(root / "chunks")
    (root / "chunks").mkdir()


def phase6(torch, dev, workdir: Path) -> dict:
    """Cell A's cells on ``fabric://rep(shard(s0,s1),r)`` with the planner
    on auto; a replica and then a shard lose every chunk file, and each
    checkout after the loss must still be exact (block_diff)."""
    from repro_torch.core import KishuSession, open_store, scrub
    from repro_torch.kernels import _lib

    d = workdir
    url = (f"fabric://rep(shard(dir://{d}/s0,dir://{d}/s1),"
           f"dir://{d}/r)")
    rec: dict = {"store": url, "layers": FABRIC_LAYERS}
    state = make_state(torch, dev, FABRIC_LAYERS)
    rec["state_bytes"] = sum(t.numel() * t.element_size()
                             for grp in (state["params"], state["opt"]["m"],
                                         state["opt"]["v"])
                             for t in grp.values())
    sess = KishuSession(open_store(url), chunk_bytes=CB, plan_mode="auto")
    check(sess.device.type == "cuda" and sess.plan_mode == "auto",
          f"fabric session on {sess.device}, {sess.plan_mode}")
    sess.register("finetune_top", finetune_top)
    sess.register("reinit_vocab_slice", reinit_vocab_slice)

    def op(label: str, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        rec[f"{label}_s"] = time.perf_counter() - t0
        return out

    def commit(label: str, fn) -> str:
        cid = op(label, fn)
        w = sess.last_run.write
        rec[label] = {"covs_updated": sess.last_run.covs_updated,
                      "bytes_written": w.bytes_written,
                      "bytes_dev2host": w.bytes_dev2host,
                      "chunks_written": w.chunks_written,
                      "chunks_encoded": w.chunks_encoded}
        print(f"phase6 {label}: {rec[f'{label}_s']:.3f} s; {rec[label]}",
              flush=True)
        return cid

    def checkout(label: str, target: str, snap: dict) -> None:
        st = op(label, lambda: sess.checkout(target))
        rec[f"verify_{label}_s"] = verify_exact(torch, sess.ns, snap, label)
        rec[label] = {"plan_est_s": st.plan_est_s,
                      "covs_planned": {"fetch": st.covs_planned_fetch,
                                       "patch": st.covs_planned_patch,
                                       "replay": st.covs_planned_replay},
                      "covs_loaded": st.covs_loaded,
                      "covs_patched": st.covs_patched,
                      "covs_recomputed": st.covs_recomputed,
                      "bytes_loaded": st.bytes_loaded,
                      "bytes_cached": st.bytes_cached}
        print(f"phase6 {label}: {rec[f'{label}_s']:.3f} s, exact "
              f"(block_diff, {rec[f'verify_{label}_s']:.3f} s); "
              f"{rec[label]}", flush=True)

    def scrub_op(label: str, repair: bool):
        r = op(label, lambda: scrub(open_store(url), repair=repair))
        rec[label] = {"problems": r.problems, "repaired": r.repaired,
                      "remaining": r.remaining,
                      "replica_missing": r.replica_missing,
                      "misplaced": r.misplaced,
                      "chunks_checked": r.chunks_checked}
        print(f"phase6 {label}: {rec[f'{label}_s']:.3f} s; {rec[label]}",
              flush=True)
        return r

    _lib.reset_launches()
    try:
        c_attach = commit("attach", lambda: sess.init_state(state))
        del state
        snap0 = tensor_snapshot(torch, sess.ns)
        commit("finetune_top", lambda: sess.run(
            "finetune_top", step=1, layers=list(FABRIC_TOP)))
        lo, hi = VOCAB_ROWS
        c_vocab = commit("reinit_vocab_slice", lambda: sess.run(
            "reinit_vocab_slice", lo=lo, hi=hi))
        snap2 = tensor_snapshot(torch, sess.ns)
        checkout("checkout_back", c_attach, snap0)
        checkout("checkout_forward", c_vocab, snap2)
        # the chunk cache off: every read below goes to the fabric
        sess.chunk_cache.clear()
        sess.chunk_cache.max_bytes = 0
        wipe_chunks(d / "r")
        checkout("checkout_back_r_wiped", c_attach, snap0)
        r = scrub_op("scrub_repair", True)
        check(r.replica_missing > 0 and r.remaining == 0,
              f"scrub --repair after the replica wipe: {rec['scrub_repair']}")
        wipe_chunks(d / "s1")
        checkout("checkout_forward_s1_wiped", c_vocab, snap2)
        r = scrub_op("scrub_repair_2", True)
        check(r.remaining == 0, f"second scrub --repair: "
                                f"{rec['scrub_repair_2']}")
        r = scrub_op("scrub_final", False)
        check(r.problems == 0, f"the final scrub is not clean: "
                               f"{rec['scrub_final']}")
        rec["commits"] = [c_attach, c_vocab]
        rec["launches"] = _lib.launches()
    finally:
        sess.close()
    print(f"phase6 state: {rec['state_bytes']} bytes ({FABRIC_LAYERS} of "
          f"{N_LAYERS} layers); kernels: {json.dumps(rec['launches'])}",
          flush=True)
    missing = [k for k in FABRIC_PATH_KERNELS if rec["launches"][k] <= 0]
    check(not missing, f"kernels never launched on the fabric path: "
                       f"{missing}")
    return rec


# ---------------------------------------------------------------------------
# Phase 5: serving under Kishu (SmolLM-360M, full size)
# ---------------------------------------------------------------------------

def logit_bound_of(torch, cfg, params) -> float:
    """Bound on |prefill - decode| logits, from bf16: one rounding (2**-8
    relative) per residual add, 2 per layer (3 in an enc-dec decoder,
    whose cross-attention adds one), summed as a random walk, moves the
    final normed state x (|x| = sqrt(d_model)) by
    2**-8 sqrt(adds) sqrt(d_model); a logit moves by at most that times
    the norm of its unembedding row (the embedding's when tied)."""
    import math
    w = params["embed"].float() if cfg.tie_embeddings \
        else params["lm_head"].float().t()
    adds = cfg.n_layers * (3 if cfg.enc_dec else 2)
    return 2 ** -8 * math.sqrt(adds) * math.sqrt(cfg.d_model) \
        * float(w.norm(dim=1).max())


def serve_cell(torch, dev, workdir: Path, tag: str, cfg, params, *,
               batch: int, prompt: int, gen: int, chunk_bytes: int,
               flavors: tuple, path_kernels: tuple,
               compare_mask=None, after_prefill=None,
               enc_frames=None) -> dict:
    """examples/serve_batched.py on the card for ``cfg``: ``make_prefill_step``
    on ``batch`` x ``prompt`` tokens, then the teacher-forced decode loop
    (a CUDA graph of the step) fills the caches and its logits are held
    against the prefill's within :func:`logit_bound_of`; the prefix is
    committed once (dir:// store, ``chunk_bytes`` chunks), and each flavor
    of generation starts from a checkout of the prefix that block_diff
    verifies exact.  The first two flavors must generate other tokens; a
    repeated flavor must give the same tokens and caches; a last
    generation by the eager step, from the same checkout, must equal the
    first flavor's bit for bit.

    ``compare_mask(prompts)``, run before the counted path, returns the
    [B,S] positions at which prefill and decode are held (all by default)
    and a dict recorded beside them; ``after_prefill(rec, logits)`` runs
    inside the prefill cell after the prefill step.  Kernel launches are
    counted from the prefix commit to the eager generation's
    verification, and each of ``path_kernels`` must have launched.

    An enc-dec model takes ``enc_frames`` [B, S_enc, d]: the prefill step
    encodes them with the prompt, and ``lm.encode`` writes them once into
    the caches' ``enc_out`` before the prefix commit.  Decode never writes
    ``enc_out``, so every rollback must keep its tensor and ask the store
    for none of its chunks.  The card's peak allocated memory over the
    cell is recorded."""
    from repro_torch.core import KishuSession, open_store
    from repro_torch.kernels import _lib
    from repro_torch.models import lm
    from repro_torch.train import step as step_lib

    b, plen, vocab = batch, prompt, cfg.vocab_size
    torch.cuda.reset_peak_memory_stats()
    prompts = torch.randint(0, vocab, (b, plen), dtype=torch.int32,
                            device=dev, generator=torch.Generator(
                                device=dev).manual_seed(1))
    prefill_step = step_lib.make_prefill_step(cfg)
    # both decode loops replay a CUDA graph of the step (the JAX package
    # jits it); the eager step runs one generation for comparison
    decode = step_lib.GraphedDecodeStep(cfg)
    eager_decode = step_lib.make_decode_step(cfg)
    logit_bound = logit_bound_of(torch, cfg, params)
    rec: dict = {"arch": cfg.name, "batch": b, "prompt": plen, "gen": gen,
                 "chunk_bytes": chunk_bytes, "logit_bound": logit_bound}
    mask = torch.ones((b, plen), dtype=torch.bool, device=dev)
    if compare_mask is not None:
        mask, rec["compare"] = compare_mask(prompts)
    errs: dict = {}
    prefill_batch = {"tokens": prompts}
    if enc_frames is not None:
        prefill_batch["enc_embeds"] = enc_frames

    def new_caches():
        caches = lm.init_caches(cfg, b, plen + gen, enc_seq=0 if enc_frames
                                is None else enc_frames.shape[1])
        if enc_frames is not None:
            with torch.no_grad():
                caches["enc_out"] = lm.encode(cfg, params,
                                              {"enc_embeds": enc_frames})
        return caches

    def prefill(ns):
        t0 = time.perf_counter()
        logits = prefill_step(params, prefill_batch)
        torch.cuda.synchronize()
        rec["prefill_step_s"] = time.perf_counter() - t0
        rec["peak_allocated_prefill_bytes"] = \
            torch.cuda.max_memory_allocated()
        if after_prefill is not None:
            after_prefill(rec, logits)
        check(tuple(logits.shape) == (b, plen, cfg.padded_vocab)
              and logits.dtype == torch.float32
              and bool(torch.isfinite(logits).all()),
              f"{tag} prefill logits {tuple(logits.shape)} {logits.dtype}")
        t0 = time.perf_counter()
        cap0, cap_s0 = decode.captures, decode.capture_s
        caches = new_caches()
        tok = prompts[:, :1]
        err = torch.zeros((b, plen), device=dev)
        err_sum = torch.zeros((), dtype=torch.float64, device=dev)
        with torch.no_grad():
            for t in range(plen):
                lg, nxt, caches = decode.with_logits(
                    params, caches, {"tokens": tok, "index": t})
                d = (lg[:, 0] - logits[:, t]).abs()
                err[:, t] = d.amax(dim=-1)
                err_sum += d.double().sum()
                tok = prompts[:, t + 1:t + 2] if t + 1 < plen else nxt
        torch.cuda.synchronize()
        rec["decode_prefill_s"] = time.perf_counter() - t0
        rec["decode_prefill_captures"] = decode.captures - cap0
        rec["decode_prefill_capture_s"] = decode.capture_s - cap_s0
        errs["max"] = err
        rec["prefill_decode_mean_abs_err"] = float(err_sum) / logits.numel()
        last = logits[:, -1]
        rec["last_argmax_agree"] = int(
            (last[:, :vocab].argmax(-1).to(torch.int32) == tok[:, 0]).sum())
        ns.set_tree("caches", caches)
        ns["prefill_last_logits"] = last.clone()
        ns["last_tok"] = tok
        ns["pos"] = plen

    def generate_with(step):
        def generate(ns, n, flavor):
            caches = ns.get_tree("caches")
            tok, pos, outs = ns["last_tok"], ns["pos"], []
            for t in range(n):
                tok, caches = step(params, caches,
                                   {"tokens": (tok + flavor) % vocab,
                                    "index": pos + t})
                outs.append(tok)
            ns.set_tree("caches", caches)
            ns["last_tok"] = tok
            ns["pos"] = pos + n
            ns["generated"] = torch.cat(outs, dim=1)
            # the cell's exec time then holds its steps' device time, not
            # only their enqueue
            torch.cuda.synchronize()
        return generate

    # the store's reads, recorded during each checkout: an enc-dec
    # rollback must read no chunk of enc_out
    store = open_store(f"dir://{workdir}/serve_cas")
    reads: list = []
    for name in ("get_chunk", "get_chunks"):
        def spy(keys, *a, _real=getattr(store, name), **kw):
            reads.extend([keys] if isinstance(keys, str) else list(keys))
            return _real(keys, *a, **kw)
        setattr(store, name, spy)
    fixed: dict = {}
    sess = KishuSession(store, chunk_bytes=chunk_bytes, trace=True)
    check(sess.device.type == "cuda", "the session did not default to cuda")
    tracer = sess.obs.tracer
    sess.register("prefill", prefill)
    sess.register("generate", generate_with(decode))
    sess.register("generate_eager", generate_with(eager_decode))
    sess.init_state({})

    def run_rec(label: str, t0: float) -> None:
        torch.cuda.synchronize()
        rec[f"{label}_s"] = time.perf_counter() - t0
        rec[f"{label}_stages"] = tracer.stage_totals()
        tracer.clear()
        r, w = sess.last_run, sess.last_run.write
        rec[label] = {"exec_s": r.exec_s, "commit_s": r.detect_s + r.write_s,
                      "covs_updated": r.covs_updated,
                      "covs_packed": w.covs_packed,
                      "bytes_serialized": w.bytes_serialized,
                      "bytes_dev2host": w.bytes_dev2host,
                      "bytes_written": w.bytes_written,
                      "chunks_written": w.chunks_written,
                      "chunks_encoded": w.chunks_encoded}

    def checkout_rec(label: str, target: str, snap: dict) -> None:
        reads.clear()
        t0 = time.perf_counter()
        st = sess.checkout(target)
        torch.cuda.synchronize()
        rec[f"{label}_s"] = time.perf_counter() - t0
        for name, (tensor, keys) in fixed.items():
            n_read = len(keys & set(reads))
            rec[f"{label}_{name.split('/')[-1]}_chunks_read"] = n_read
            check(sess.ns[name] is tensor and n_read == 0,
                  f"{tag} {label}: the rollback reloaded {name} "
                  f"({n_read} of its chunks read)")
        rec[f"{label}_stages"] = tracer.stage_totals()
        tracer.clear()
        rec[label] = {
            "covs_loaded": st.covs_loaded,
            "covs_patched": st.covs_patched,
            "covs_scattered": st.covs_scattered,
            "chunks_patched": st.chunks_patched,
            "bytes_loaded": st.bytes_loaded,
            "bytes_cached": st.bytes_cached,
            "bytes_host2dev": st.bytes_host2dev}
        rec[f"verify_{label}_s"] = verify_exact(
            torch, sess.ns, snap, f"{tag} {label} to the prefix")

    n_gen = len(flavors)
    tokens: dict = {}
    try:
        tracer.clear()
        _lib.reset_launches()
        t0 = time.perf_counter()
        c_prefix = sess.run("prefill")
        run_rec("prefill", t0)
        cache_names = sorted(n for n in sess.ns.names()
                             if n.startswith("caches/"))
        rec["cache_leaves"] = {n: [list(sess.ns[n].shape),
                                   str(sess.ns[n].dtype)]
                               for n in cache_names}
        rec["cache_bytes"] = sum(sess.ns[n].numel()
                                 * sess.ns[n].element_size()
                                 for n in cache_names)
        if enc_frames is not None:
            from repro_torch.core.chunkstore import chunk_key
            t = sess.ns["caches/enc_out"]
            raw = t.reshape(-1).view(torch.uint8).cpu().numpy().tobytes()
            fixed["caches/enc_out"] = (t, {
                chunk_key(raw[i:i + chunk_bytes])
                for i in range(0, len(raw), chunk_bytes)})
        err = errs.pop("max")
        rec["prefill_decode_positions_held"] = int(mask.sum())
        check(rec["prefill_decode_positions_held"] > 0,
              f"{tag}: no position to hold prefill against decode at")
        rec["prefill_decode_max_abs_err"] = float(err[mask].max())
        rec["prefill_decode_max_abs_err_all"] = float(err.max())
        check(rec["prefill_decode_max_abs_err"] <= logit_bound,
              f"{tag}: prefill and decode logits differ by "
              f"{rec['prefill_decode_max_abs_err']} > {logit_bound}")
        snap0 = tensor_snapshot(torch, sess.ns)
        snap1 = None
        for i, flavor in enumerate(flavors):
            checkout_rec(f"checkout_{i}", c_prefix, snap0)
            t0 = time.perf_counter()
            cap0, cap_s0 = decode.captures, decode.capture_s
            sess.run("generate", n=gen, flavor=flavor)
            run_rec(f"generate_{i}", t0)
            rec[f"generate_{i}"].update(
                flavor=flavor, captures=decode.captures - cap0,
                capture_s=decode.capture_s - cap_s0)
            got = sess.ns["generated"]
            check(tuple(got.shape) == (b, gen) and int(got.max()) < vocab
                  and int(got.min()) >= 0,
                  f"{tag} generated {tuple(got.shape)}")
            if flavor in tokens:
                check(torch.equal(got, tokens[flavor]),
                      f"{tag}: flavor {flavor} regenerated other tokens")
                rec["verify_repeat_s"] = verify_exact(
                    torch, sess.ns, snap1, f"{tag} flavor {flavor} repeated")
            else:
                tokens[flavor] = got.clone()
                if snap1 is None:
                    snap1 = tensor_snapshot(torch, sess.ns)
        check(not torch.equal(tokens[flavors[0]], tokens[flavors[1]]),
              f"{tag}: flavors {flavors[:2]} generated the same tokens")
        # the eager step from the same checkout: the graph's tokens and
        # caches bit for bit.  Its transients cannot use the graph's
        # private pool: give it the blocks the allocator holds
        torch.cuda.empty_cache()
        checkout_rec("checkout_eager", c_prefix, snap0)
        t0 = time.perf_counter()
        sess.run("generate_eager", n=gen, flavor=flavors[0])
        run_rec("generate_eager", t0)
        check(torch.equal(sess.ns["generated"], tokens[flavors[0]]),
              f"{tag}: the eager step generated other tokens than the "
              f"graph")
        rec["verify_eager_s"] = verify_exact(
            torch, sess.ns, snap1, f"{tag} eager generate against the "
                                   f"graph's")
        rec["launches"] = _lib.launches()
    finally:
        sess.close()
    rec["tokens_flavor_1_seq0"] = tokens[flavors[0]][0, :12].tolist()
    rec["prefill_tok_s"] = b * plen / rec["prefill_step_s"]
    rec["decode_prefill_tok_s"] = b * plen / rec["decode_prefill_s"]
    rec["generate_tok_s"] = [b * gen / rec[f"generate_{i}_s"]
                             for i in range(n_gen)]
    rec["captures"] = decode.captures
    rec["capture_s"] = decode.capture_s
    # steady-state steps: the loop's time less its captures
    rec["decode_prefill_ms_per_step"] = 1e3 * (
        rec["decode_prefill_s"] - rec["decode_prefill_capture_s"]) / plen
    rec["generate_ms_per_step"] = [
        1e3 * (rec[f"generate_{i}"]["exec_s"]
               - rec[f"generate_{i}"]["capture_s"]) / gen
        for i in range(n_gen)]
    rec["eager_ms_per_step"] = 1e3 * rec["generate_eager"]["exec_s"] / gen
    rec["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
    rec["peak_reserved_bytes"] = torch.cuda.max_memory_reserved()
    print(f"{tag} {cfg.name}: caches {rec['cache_leaves']} "
          f"({rec['cache_bytes']} bytes) on {dev}; peak allocated "
          f"{rec['peak_allocated_bytes']} bytes ("
          f"{rec['peak_allocated_prefill_bytes']} through the prefill "
          f"step), reserved {rec['peak_reserved_bytes']}", flush=True)
    print(f"{tag} prefill_step: {rec['prefill_step_s']:.3f} s "
          f"({rec['prefill_tok_s']:.0f} tok/s); decode-loop "
          f"prefill {rec['decode_prefill_s']:.3f} s "
          f"({rec['decode_prefill_tok_s']:.0f} tok/s); logits max abs diff "
          f"{rec['prefill_decode_max_abs_err']:.4f} at "
          f"{rec['prefill_decode_positions_held']} of {b * plen} positions "
          f"(all: {rec['prefill_decode_max_abs_err_all']:.4f}; mean "
          f"{rec['prefill_decode_mean_abs_err']:.2e}, bound "
          f"{logit_bound:.4f}); last-position argmax agrees on "
          f"{rec['last_argmax_agree']} of {b}", flush=True)
    print(f"{tag} decode graph: {rec['captures']} captures in "
          f"{rec['capture_s']:.3f} s; decode-loop prefill "
          f"{rec['decode_prefill_ms_per_step']:.3f} ms a step after "
          f"{rec['decode_prefill_captures']} capture(s) "
          f"({rec['decode_prefill_capture_s']:.3f} s); generate "
          f"{[round(x, 3) for x in rec['generate_ms_per_step']]} ms a step, "
          f"captures "
          f"{[rec[f'generate_{i}']['captures'] for i in range(n_gen)]} in "
          f"{[round(rec[f'generate_{i}']['capture_s'], 3) for i in range(n_gen)]}"
          f" s; the eager step {rec['eager_ms_per_step']:.3f} ms a step, "
          f"its generation bit-identical to the graph's (tokens, caches; "
          f"block_diff {rec['verify_eager_s']:.3f} s)", flush=True)
    for key in ["prefill"] + [f"generate_{i}" for i in range(n_gen)] \
            + ["generate_eager"]:
        print(f"{tag} {key}: {rec[f'{key}_s']:.3f} s; {rec[key]}; stages "
              f"{rec[f'{key}_stages']}", flush=True)
    for key in [f"checkout_{i}" for i in range(n_gen)] + ["checkout_eager"]:
        print(f"{tag} {key} to the prefix: {rec[f'{key}_s']:.3f} s, every "
              f"tensor bit-identical (block_diff, "
              f"{rec[f'verify_{key}_s']:.3f} s); {rec[key]}; stages "
              f"{rec[f'{key}_stages']}", flush=True)
    if "verify_repeat_s" in rec:
        print(f"{tag} flavor {flavors[0]} repeated: same tokens, caches "
              f"bit-identical (block_diff, {rec['verify_repeat_s']:.3f} s)",
              flush=True)
    print(f"{tag} generate tok/s "
          f"{[round(x, 1) for x in rec['generate_tok_s']]}; sample "
          f"{rec['tokens_flavor_1_seq0']}", flush=True)
    print(f"{tag} kernels: {json.dumps(rec['launches'])}", flush=True)
    missing = [k for k in path_kernels if rec["launches"][k] <= 0]
    check(not missing, f"{tag}: kernels never launched on the serving "
                       f"path: {missing}")
    return rec


def phase5(torch, dev, workdir: Path) -> dict:
    """Cell C: SmolLM-360M at full width and depth through
    :func:`serve_cell` — flash prefill (all 32 launches on the tc route),
    16 KiB chunks, flavors 1, 2, 3, 1."""
    from repro_torch.kernels import _lib
    from repro_torch.models import lm
    from repro_torch.models.config import get_config
    from repro_torch.optim.adamw import tree_leaves

    cfg = get_config("smollm-360m")            # full width and depth
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    check(n_params == 361_821_120, f"{n_params} parameters")
    check(all(t.dtype == torch.bfloat16 and t.is_cuda for t in leaves),
          "serving params must be bf16 on the card")
    print(f"phase5 {cfg.name}: {n_params} bf16 params", flush=True)

    def flash_launches(rec, logits):
        rec["prefill_step_launches"] = _lib.launches()["flash_attention"]
        rec["prefill_step_routes"] = _lib.route_launches()["flash_attention"]
        check(rec["prefill_step_launches"] == cfg.n_layers,
              f"prefill launched flash {rec['prefill_step_launches']} "
              f"times, want {cfg.n_layers}")
        check(rec["prefill_step_routes"] == {"tc": cfg.n_layers, "fma": 0},
              f"prefill flash routes {rec['prefill_step_routes']}, want "
              f"all {cfg.n_layers} on tc")

    rec = serve_cell(torch, dev, workdir, "phase5", cfg, params,
                     batch=SERVE_BATCH, prompt=SERVE_PROMPT, gen=SERVE_GEN,
                     chunk_bytes=SERVE_CHUNK, flavors=(1, 2, 3, 1),
                     path_kernels=SERVE_PATH_KERNELS,
                     after_prefill=flash_launches)
    rec["params"] = n_params
    print(f"phase5 prefill flash: {rec['prefill_step_launches']} launches, "
          f"by route {rec['prefill_step_routes']}", flush=True)
    return rec


# ---------------------------------------------------------------------------
# Phase 7: Cell E, Mamba-2/SSD serving (mamba2-780m, full size)
# ---------------------------------------------------------------------------

def phase7(torch, dev, workdir: Path) -> dict:
    """Cell E: mamba2-780m at full width and depth (48 SSD layers, bf16,
    random from a seed) through :func:`serve_cell`: chunked-SSD prefill of
    8 x 512 tokens, the decode loop (the SSM recurrence) fills the conv
    and float32 state caches, the prefix is committed in 1 MiB chunks, and
    four rollbacks (flavors 1, 2, 3, 1) and one by the eager step each
    reload a state every decode step rewrote in full."""
    from repro_torch.models import lm
    from repro_torch.models.config import get_config
    from repro_torch.optim.adamw import tree_leaves

    cfg = get_config("mamba2-780m")            # full width and depth
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves)
    check(all(t.is_cuda for t in leaves), "serving params must be on the "
                                          "card")
    print(f"phase7 {cfg.name}: {n_params} params, {n_bytes} bytes "
          f"(bf16, f32 dt_bias / A_log / D)", flush=True)
    rec = serve_cell(torch, dev, workdir, "phase7", cfg, params,
                     batch=SSM_BATCH, prompt=SSM_PROMPT, gen=SSM_GEN,
                     chunk_bytes=SSM_CHUNK, flavors=(1, 2, 3, 1),
                     path_kernels=SSM_PATH_KERNELS)
    rec["params"], rec["param_bytes"] = n_params, n_bytes
    state = rec["cache_leaves"]["caches/stages/stage_0/sub_0/ssm/state"]
    check(state == [[48, SSM_BATCH, 48, 64, 128], "torch.float32"],
          f"phase7: state cache {state}")
    return rec


# ---------------------------------------------------------------------------
# Phase 7b: Cell F, MoE serving (phi3.5-moe-42b-a6.6b, full width, 2 layers)
# ---------------------------------------------------------------------------

def phase7b(torch, dev, workdir: Path) -> dict:
    """Cell F: phi3.5-moe-42b-a6.6b at its published widths, cut to its
    first MOE_LAYERS of 32 layers (16 experts of 2.52 GB a layer in bf16:
    the whole model does not fit one card), through :func:`serve_cell`:
    flash prefill (hd 128, tc route) and MoE dispatch of 8 x 128 tokens,
    the decode loop, a prefix commit in 16 KiB chunks and two rollbacks
    (flavors 1, 2) plus one by the eager step.

    Prefill and decode are held where they compute the same function
    (:func:`routing_mask_of`): capacity depends on the token count (1,024
    tokens in prefill, 8 in decode), so positions a dropped assignment
    reaches are left out (the reference's semantics), and so are
    positions that bf16 rounding moved to another expert (a near tie in
    the router).  Layer 0's drops reach every later position of their
    sequence through layer 1's attention."""
    from repro_torch.models import lm
    from repro_torch.models.config import get_config
    from repro_torch.optim.adamw import tree_leaves

    cfg = get_config("phi3.5-moe-42b-a6.6b").replace(n_layers=MOE_LAYERS)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves)
    print(f"phase7b {cfg.name}, first {MOE_LAYERS} of 32 layers: "
          f"{n_params} params, {n_bytes} bytes", flush=True)

    rec = serve_cell(torch, dev, workdir, "phase7b", cfg, params,
                     batch=MOE_BATCH, prompt=MOE_PROMPT, gen=MOE_GEN,
                     chunk_bytes=SERVE_CHUNK, flavors=(1, 2),
                     path_kernels=MOE_PATH_KERNELS,
                     compare_mask=routing_mask_of(torch, cfg, params,
                                                  "phase7b"),
                     after_prefill=flash_launch_check(torch, "phase7b",
                                                      cfg.n_layers))
    rec["params"], rec["param_bytes"] = n_params, n_bytes
    return rec


def routing_mask_of(torch, cfg, params, tag: str):
    """``compare_mask`` for an MoE model: the positions at which prefill and
    decode compute the same function.  Capacity depends on the token
    count (prefill drops assignments past it, decode at batch 8 never
    does), and bf16 rounding can move a near tie in a router to another
    expert; an eager decode pass records its routing.  A position is held
    unless some MoE layer dropped an assignment of it, or routed it
    otherwise than decode did — or did so at an earlier position of its
    sequence, where an attention layer follows that MoE layer (causal
    attention carries an earlier position's output forward; without a
    later attention layer only the position's own routing reaches its
    logits).  The counts are recorded and printed."""
    from repro_torch.models import lm
    flat = [spec for st in lm.build_stages(cfg) for _ in range(st.n_units)
            for spec in st.unit]
    carried = [any(s.kind == "attn" for s in flat[i + 1:])
               for i, spec in enumerate(flat) if spec.ffn == "moe"]

    def routing_mask(prompts):
        b, s = prompts.shape
        with torch.no_grad():
            pre_routes = []
            lm.forward(cfg, params, {"tokens": prompts}, routes=pre_routes)
            caches = lm.init_caches(cfg, b, s)
            dec = []
            for t in range(s):
                routes = []
                lm.decode_step(cfg, params, caches,
                               {"tokens": prompts[:, t:t + 1], "index": t},
                               routes=routes)
                dec.append(torch.stack([e[:, 0] for e, _ in routes]))
            del caches
        dec = torch.stack(dec, dim=2)                    # [L, B, S, K]
        pre = torch.stack([e for e, _ in pre_routes])     # [L, B, S, K]
        differs = (dec.sort(-1).values != pre.sort(-1).values).any(-1)
        dropped = torch.stack([(~v).any(-1) for _, v in pre_routes])
        bad = torch.zeros((b, s), dtype=torch.bool, device=prompts.device)
        for layer, later_attn in enumerate(carried):
            bad_l = dropped[layer] | differs[layer]
            if later_attn:
                bad_l = bad_l.int().cummax(dim=1).values.bool()
            bad |= bad_l
        info = {"capacity_prefill": moe_capacity(cfg, b * s),
                "capacity_decode": moe_capacity(cfg, b),
                "dropped_per_seq": sum((~v).sum(dim=(1, 2))
                                       for _, v in pre_routes).tolist(),
                "dropped_positions": int(dropped.any(0).sum()),
                "routing_differs_at": int(differs.any(0).sum()),
                "moe_layers_followed_by_attention": carried,
                "positions_held": int((~bad).sum())}
        print(f"{tag} routing: prefill capacity {info['capacity_prefill']}"
              f" a expert ({b * s} tokens), decode {info['capacity_decode']};"
              f" dropped assignments per sequence {info['dropped_per_seq']}"
              f" (at {info['dropped_positions']} positions); routing "
              f"differs from decode at {info['routing_differs_at']} of "
              f"{b * s} positions; held {info['positions_held']}",
              flush=True)
        return ~bad, info
    return routing_mask


def flash_launch_check(torch, tag: str, n_launches: int):
    """``after_prefill``: the prefill step launched flash ``n_launches``
    times, all on the tc route (bf16)."""
    from repro_torch.kernels import _lib

    def after_prefill(rec, logits):
        rec["prefill_step_routes"] = _lib.route_launches()["flash_attention"]
        check(rec["prefill_step_routes"] == {"tc": n_launches, "fma": 0},
              f"{tag} prefill flash routes {rec['prefill_step_routes']}, "
              f"want all {n_launches} on tc")
    return after_prefill


# ---------------------------------------------------------------------------
# Phase 7c: Cell G, MLA + MoE serving (deepseek-v3-671b, full width, 4 layers)
# ---------------------------------------------------------------------------

def phase7c(torch, dev, workdir: Path) -> dict:
    """Cell G: deepseek-v3-671b at its published widths (MLA: 128 heads,
    q_lora 1536, kv_lora 512, qk 128 + 64, v 128; 256 routed experts top-8
    of d_ff 2048 plus one shared, capacity 1.25; dense-prefix d_ff 18432;
    vocab 129280, untied; the MTP block, initialised and carried, unused
    in serving), cut to its first MLA_LAYERS of 61 layers, through
    :func:`serve_cell` at Cell F's traffic: flash prefill (q and k of 192,
    v padded to 192, tc route), the decode loop filling the compressed
    caches (``c_kv`` and ``k_rope``), a prefix commit in 16 KiB chunks,
    flavors 1, 2, 1 and one generation by the eager step.  Prefill and
    decode are held as in Cell F (:func:`routing_mask_of`)."""
    from repro_torch.models import lm
    from repro_torch.models.config import get_config
    from repro_torch.optim.adamw import tree_leaves

    cfg = get_config("deepseek-v3-671b").replace(n_layers=MLA_LAYERS)
    stages = [(st.n_units, [(u.kind, u.ffn) for u in st.unit])
              for st in lm.build_stages(cfg)]
    check(stages == [(3, [("attn", "dense")]), (1, [("attn", "moe")])],
          f"phase7c stages {stages}")
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves)
    check(n_params == MLA_PARAMS, f"phase7c: {n_params} parameters")
    check("mtp" in params and all(t.is_cuda for t in leaves),
          "phase7c: the MTP block and every parameter on the card")
    print(f"phase7c {cfg.name}, first {MLA_LAYERS} of 61 layers: "
          f"{n_params} params, {n_bytes} bytes (bf16, f32 routers); "
          f"allocated {torch.cuda.memory_allocated()} bytes", flush=True)
    rec = serve_cell(torch, dev, workdir, "phase7c", cfg, params,
                     batch=MLA_BATCH, prompt=MLA_PROMPT, gen=MLA_GEN,
                     chunk_bytes=SERVE_CHUNK, flavors=(1, 2, 1),
                     path_kernels=MLA_PATH_KERNELS,
                     compare_mask=routing_mask_of(torch, cfg, params,
                                                  "phase7c"),
                     after_prefill=flash_launch_check(torch, "phase7c",
                                                      cfg.n_layers))
    rec["params"], rec["param_bytes"] = n_params, n_bytes
    leaves = rec["cache_leaves"]
    for i, n in ((0, 3), (1, 1)):
        pre = f"caches/stages/stage_{i}/sub_0/attn"
        check(leaves[f"{pre}/c_kv"] == [[n, MLA_BATCH, MLA_PROMPT + MLA_GEN,
                                         512], "torch.bfloat16"]
              and leaves[f"{pre}/k_rope"][0] == [
                  n, MLA_BATCH, MLA_PROMPT + MLA_GEN, 1, 64],
              f"phase7c: compressed caches {leaves}")
    return rec


# ---------------------------------------------------------------------------
# Phase 7d: Cell H, enc-dec serving (whisper-large-v3, full size)
# ---------------------------------------------------------------------------

def phase7d(torch, dev, workdir: Path) -> dict:
    """Cell H: whisper-large-v3 at full size, nothing cut (32 encoder and
    32 decoder layers, d_model 1280, 20 heads of 64, d_ff 5120, vocab 51866
    padded to 51968, sinusoidal positions, cross-attention in every decoder
    layer, bf16), through :func:`serve_cell`: the prefill step encodes
    ENC_FRAMES seeded frame embeddings (flash, causal as in the JAX
    package's encoder, S 1500: a ragged last tile) and runs the decoder on
    a 16-token prompt; ``lm.encode`` writes ``enc_out`` [8, 1500, 1280]
    into the caches once, before the prefix commit; the decode loop reads
    it (K and V of every decoder layer's cross-attention recomputed from
    it each step, as in the JAX package); flavors 1, 2, 1 and the eager
    step, each from a rollback that reads no chunk of ``enc_out``."""
    from repro_torch.models import lm
    from repro_torch.models.config import get_config
    from repro_torch.optim.adamw import tree_leaves

    cfg = get_config("whisper-large-v3")            # full size
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves)
    check(n_params == ENC_PARAMS, f"phase7d: {n_params} parameters")
    print(f"phase7d {cfg.name}: {n_params} params, {n_bytes} bytes",
          flush=True)
    frames = torch.randn((ENC_BATCH, ENC_FRAMES, cfg.d_model), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(2)
                         ).to(torch.bfloat16)
    rec = serve_cell(torch, dev, workdir, "phase7d", cfg, params,
                     batch=ENC_BATCH, prompt=ENC_PROMPT, gen=ENC_GEN,
                     chunk_bytes=SERVE_CHUNK, flavors=(1, 2, 1),
                     path_kernels=ENC_PATH_KERNELS,
                     after_prefill=flash_launch_check(
                         torch, "phase7d", cfg.n_encoder_layers
                         + cfg.n_layers),
                     enc_frames=frames)
    rec["params"], rec["param_bytes"] = n_params, n_bytes
    check(rec["cache_leaves"]["caches/enc_out"] == [
        [ENC_BATCH, ENC_FRAMES, cfg.d_model], "torch.bfloat16"],
        f"phase7d: enc_out {rec['cache_leaves']['caches/enc_out']}")
    print(f"phase7d rollbacks read no chunk of enc_out: "
          f"{ {k: v for k, v in rec.items() if k.endswith('_chunks_read')} }",
          flush=True)
    return rec


# ---------------------------------------------------------------------------
# Phase 8: distribution on the card (DTensor co-variables, one NCCL rank)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def uncounted(held: dict):
    """Kernel launches inside the block are added to ``held``: a
    comparison's launches, which a path's counts leave out."""
    from repro_torch.kernels import _lib
    before = _lib.launches()
    try:
        yield
    finally:
        for k, v in _lib.launches().items():
            held[k] = held.get(k, 0) + v - before.get(k, 0)


def phase8(torch, dev, workdir: Path) -> dict:
    """SmolLM-360M (its first DIST_LAYERS layers, full width) as DTensors
    under ShardingRules on a (1, 1) CUDA mesh of a one-rank NCCL group,
    committed and checked out by a KishuSession over that group; see the
    module docstring.  The group is destroyed on the way out."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor
    from repro_torch.core import KishuSession, open_store
    from repro_torch.core.delta import exact_dirty_indices
    from repro_torch.core.graph import key_str
    from repro_torch.core.namespace import flatten_tree
    from repro_torch.core.serialize import global_image, tensor_from_bytes
    from repro_torch.kernels import _lib
    from repro_torch.launch.mesh import init_file_group, make_local_mesh
    from repro_torch.models.config import get_config
    from repro_torch.optim.adamw import AdamWConfig, tree_leaves
    from repro_torch.optim.compression import (compressed_psum,
                                               quantized_psum, residual_init)
    from repro_torch.sharding.resharding import (chunks_for_range,
                                                 host_shard_ranges,
                                                 load_byte_range)
    from repro_torch.sharding.rules import ShardingRules, shard_train_state
    from repro_torch.train import step as step_lib

    rec: dict = {}
    t_all = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    init_file_group("nccl", 0, 1, str(workdir / "pg_store"))
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              "phase8: no one-rank NCCL group")
        mesh = make_local_mesh(model=1)
        check(mesh.device_type == "cuda", f"phase8: mesh on {mesh}")
        cfg = get_config("smollm-360m").replace(n_layers=DIST_LAYERS)
        opt = AdamWConfig(lr=1e-3)
        rules = ShardingRules(cfg, mesh)
        plain = step_lib.init_train_state(cfg, 0, opt, device=dev)
        clone = step_lib.init_train_state(cfg, 0, opt, device=dev)
        state = shard_train_state(clone, rules)
        n_params = sum(t.numel() for t in tree_leaves(plain["params"]))
        rec["params"] = n_params
        print(f"phase8 {cfg.name}, first {DIST_LAYERS} of 32 layers: "
              f"{n_params} params on a {tuple(mesh.shape)} "
              f"{mesh.mesh_dim_names} NCCL mesh", flush=True)
        hidden = (mesh, rules.hidden_spec(DIST_BATCH, DIST_SEQ))
        sharded_fn = step_lib.make_train_step(cfg, opt,
                                              hidden_sharding=hidden)
        plain_fn = step_lib.make_train_step(cfg, opt)
        g = torch.Generator(device=dev).manual_seed(11)
        batches = [{k: torch.randint(0, cfg.vocab_size,
                                     (DIST_BATCH, DIST_SEQ), device=dev,
                                     generator=g, dtype=torch.int32)
                    for k in ("tokens", "labels")} for _ in range(2)]
        sess = KishuSession(open_store(f"dir://{workdir}/dist_cas"),
                            chunk_bytes=CB, device=dev,
                            group=dist.group.WORLD)
        step_no = {"i": 0}

        def train(ns):
            st = ns.get_tree("state")
            bt = batches[step_no["i"]]
            bpl = rules.batch_spec(bt)
            db = {k: distribute_tensor(v, mesh, list(bpl[k]))
                  for k, v in bt.items()}
            _, m = sharded_fn(st, db)
            ns["metrics/loss"] = float(m["loss"].full_tensor())

        def reinit(ns):
            # SPMD: each rank writes the rows of its own shard
            for name in ("state/params/embed", "state/opt/mu/embed",
                         "state/opt/nu/embed"):
                x = ns[name]
                local = x.to_local()
                rows = slice(VOCAB_ROWS[0], VOCAB_ROWS[1])
                if name.endswith("params/embed"):
                    gg = torch.Generator(device=dev).manual_seed(7)
                    local[rows].normal_(0, 0.02, generator=gg)
                else:
                    local[rows].zero_()

        sess.register("train", train)
        sess.register("reinit", reinit)
        # launches of the comparisons with plain tensors (the plain step,
        # the plain commit) are taken out of the path's counts
        held: dict = {}
        _lib.reset_launches()
        t0 = time.perf_counter()
        c0 = sess.init_state({"state": state})
        rec["attach_s"] = time.perf_counter() - t0
        dt_names = [n for n in sess.ns.names()
                    if isinstance(sess.ns[n], DTensor)]
        check(len(dt_names) > 3 * 10, f"phase8: {len(dt_names)} DTensors")
        rec["dtensor_covs"] = len(dt_names)
        commits, steps = [c0], []
        def images(tree):
            return {k: global_image(v).to(torch.float32, copy=True)
                    for k, v in flatten_tree(tree).items()}
        for i in range(2):
            step_no["i"] = i
            old_s = images(sess.ns.get_tree("state/params"))
            old_p = images(plain["params"])
            t0 = time.perf_counter()
            commits.append(sess.run("train"))
            t_cell = time.perf_counter() - t0
            with uncounted(held):
                pm = plain_fn(plain, batches[i])[1]
            loss, ploss = sess.ns["metrics/loss"], float(pm["loss"])
            flat_s = images(sess.ns.get_tree("state/params"))
            flat_p = images(plain["params"])
            err = max(float((flat_s[k] - flat_p[k]).abs().max())
                      for k in flat_p)
            same = all(torch.equal(flat_s[k], flat_p[k]) for k in flat_p)
            # each leaf's change over the step against the plain step's
            rel = 0.0
            for k in flat_p:
                dp = flat_p[k] - old_p[k]
                off = float((flat_s[k] - old_s[k] - dp).norm())
                den = float(dp.norm())
                rel = max(rel, off / den if den else
                          (0.0 if off == 0 else float("inf")))
            del old_s, old_p, flat_s, flat_p
            steps.append({"cell_s": t_cell, "loss": loss,
                          "plain_loss": ploss, "max_param_err": err,
                          "max_delta_rel_err": rel, "bit_identical": same})
            print(f"phase8 step {i + 1}: sharded loss {loss:.6f}, plain "
                  f"{ploss:.6f}, params max err {err:.3g}, change against "
                  f"the plain change {rel:.3g} of its norm, bit-identical "
                  f"{same}, cell {t_cell:.2f} s", flush=True)
            check(abs(loss - ploss) < 1e-3 and err <= 2e-2
                  and rel <= DELTA_TOL,
                  f"phase8 step {i + 1}: sharded against plain {steps[-1]}")
        rec["steps"] = steps
        check(all(isinstance(sess.ns[n], DTensor) for n in dt_names),
              "phase8: a DTensor co-variable lost its placements")

        # the trained state committed as plain tensors: same keys, bytes
        t0 = time.perf_counter()
        c2 = commits[-1]
        ref = KishuSession(open_store(f"dir://{workdir}/plain_cas"),
                           chunk_bytes=CB, device=dev)
        tensors = {n: global_image(sess.ns[n]).clone()
                   if isinstance(sess.ns[n], DTensor) else sess.ns[n]
                   for n in sess.ns.names()
                   if isinstance(sess.ns[n], torch.Tensor)}
        with uncounted(held):
            rc = ref.init_state(tensors)
        bad, n_keys, n_bytes = [], 0, 0
        for n in tensors:
            a = sess.graph.manifest_of(
                (n,), sess.graph.nodes[c2].state_index[key_str((n,))])
            b = ref.graph.manifest_of((n,), rc)
            ka = [c["key"] for c in a["base"]["chunks"]]
            kb = [c["key"] for c in b["base"]["chunks"]]
            if ka != kb or a["base"]["det_hashes"] != \
                    b["base"]["det_hashes"] or \
                    a["base"]["meta"] != b["base"]["meta"]:
                bad.append(n)
                continue
            got_a = sess.store.get_chunks(ka)
            got_b = ref.store.get_chunks(kb)
            if any(got_a[k] != got_b[k] for k in ka):
                bad.append(n)
            n_keys += len(ka)
            n_bytes += sum(len(got_a[k]) for k in ka)
        ref.close()
        del tensors
        rec["same_as_plain"] = {"chunks": n_keys, "bytes": n_bytes,
                                "differ": bad,
                                "s": time.perf_counter() - t0}
        check(not bad and n_keys > 0, f"phase8: commit differs from the "
              f"plain commit of the same values: {bad[:4]}")
        print(f"phase8 commit = plain commit: {n_keys} chunk keys, "
              f"{n_bytes} bytes", flush=True)

        # sparse cycle: reinit_vocab_slice, patch checkout back, forward
        snap2 = {n: global_image(sess.ns[n]).clone() for n in dt_names}
        t0 = time.perf_counter()
        cr = sess.run("reinit")
        rec["reinit_s"] = time.perf_counter() - t0
        rec["reinit_covs"] = sess.last_run.covs_updated
        snapr = {n: global_image(sess.ns[n]).clone() for n in dt_names}
        for label, cid, snap in (("back", c2, snap2), ("forward", cr, snapr)):
            t0 = time.perf_counter()
            st = sess.checkout(cid)
            dt = time.perf_counter() - t0
            dirty = {n: exact_dirty_indices(sess.ns[n], snap[n], CB)
                     for n in dt_names}
            bad = {n: d[:4] for n, d in dirty.items() if d}
            rec[f"checkout_{label}"] = {"s": dt, "covs_patched":
                                        st.covs_patched,
                                        "covs_loaded": st.covs_loaded,
                                        "chunks_patched": st.chunks_patched,
                                        "bytes_loaded": st.bytes_loaded}
            print(f"phase8 checkout {label}: {dt:.3f} s, "
                  f"{st.covs_patched} patched ({st.chunks_patched} chunks),"
                  f" {st.covs_loaded} loaded", flush=True)
            check(not bad, f"phase8 checkout {label}: not exact: {bad}")
            check(st.covs_patched >= 3, f"phase8 checkout {label}: "
                  f"{st.covs_patched} co-variables patched")
            check(all(isinstance(sess.ns[n], DTensor) for n in dt_names),
                  f"phase8 checkout {label}: DTensors lost")
        del snapr

        # elastic restore of the trained commit onto 8-way Shard(0)
        t0 = time.perf_counter()
        name = "state/params/embed"
        man = sess.graph.manifest_of(
            (name,), sess.graph.nodes[c2].state_index[key_str((name,))])
        shape = man["base"]["meta"]["shape"]
        ranges = host_shard_ranges(shape, man["base"]["meta"]["dtype"],
                                   (ELASTIC_WAYS,), [Shard(0)])
        read: list = []
        get = sess.store.get_chunks

        def counting(keys, **kw):
            read.extend(keys)
            return get(keys, **kw)
        parts, per_range = [], []
        sess.store.get_chunks = counting
        try:
            for r in range(ELASTIC_WAYS):
                (lo, hi), = ranges[r]
                read.clear()
                parts.append(load_byte_range(sess.store, man, lo, hi))
                want = [man["base"]["chunks"][i]["key"]
                        for i in chunks_for_range(man, lo, hi)]
                per_range.append(len(read))
                check(read == want, f"phase8 elastic rank {r}: read "
                      f"{len(read)} chunks, range needs {len(want)}")
        finally:
            sess.store.get_chunks = get
        whole = tensor_from_bytes(parts, man["base"]["meta"]["dtype"],
                                  shape, dev)
        diff = exact_dirty_indices(whole, snap2[name], CB)
        rec["elastic"] = {"ways": ELASTIC_WAYS, "chunks_per_range":
                          per_range, "s": time.perf_counter() - t0}
        print(f"phase8 elastic restore of {name} onto {ELASTIC_WAYS}-way "
              f"Shard(0): chunks per range {per_range}", flush=True)
        check(not diff, f"phase8 elastic restore not exact: {diff[:4]}")
        del snap2, whole, parts

        # int8 compressed all-reduce over the NCCL group
        gg = torch.Generator(device=dev).manual_seed(5)
        grads = {"embed": torch.randn(shape, device=dev, generator=gg)
                 * 1e-3}
        mean, _ = compressed_psum(grads, residual_init(grads), mesh, "data")
        s_int, scale, q = quantized_psum(grads["embed"].float(),
                                         mesh.get_group("data"))
        rel = float((mean["embed"] - grads["embed"]).abs().max()
                    / grads["embed"].abs().max())
        exact = bool(torch.equal(s_int, q.to(torch.int32)))
        rec["compressed_psum"] = {"int32_sum_exact": exact,
                                  "rel_err": rel,
                                  "wire_dtype": str(q.dtype)}
        check(exact and rel < 0.02 and q.dtype == torch.int8,
              f"phase8 compressed_psum: {rec['compressed_psum']}")
        sess.close()
        rec["launches"] = {k: v - held.get(k, 0)
                           for k, v in _lib.launches().items()}
        rec["comparison_launches"] = held
        for k in DIST_PATH_KERNELS:
            check(rec["launches"][k] > 0,
                  f"phase8: {k} never launched: {rec['launches']}")
        # the attach hashes every DTensor co-variable on the card
        check(rec["launches"]["chunk_hash"] >= len(dt_names),
              f"phase8: chunk_hash {rec['launches']['chunk_hash']} for "
              f"{len(dt_names)} DTensor co-variables")
    finally:
        dist.destroy_process_group()
    rec["peak_allocated"] = torch.cuda.max_memory_allocated()
    rec["peak_reserved"] = torch.cuda.max_memory_reserved()
    rec["s"] = time.perf_counter() - t_all
    print(f"phase8 launches {rec['launches']} (comparisons with plain "
          f"tensors, not counted: {rec['comparison_launches']}), "
          f"{rec['s']:.1f} s, peak "
          f"allocated {rec['peak_allocated']} reserved "
          f"{rec['peak_reserved']}", flush=True)
    return rec


# ---------------------------------------------------------------------------
# Phase 9: Cell J, decode on DTensor caches (one NCCL rank)
# ---------------------------------------------------------------------------

def phase9(torch, dev, workdir: Path) -> dict:
    """Cell J: serving on DTensor caches.  SmolLM-360M at full width, its
    first SHARD_LAYERS layers, bf16; params under ShardingRules and
    caches under ``shard_caches`` on a (1, 1) ("data", "model") mesh of a
    one-rank NCCL group; a KishuSession over the group.  Cell C's flow:
    the sharded prefill (flash on the local shards) gives the prompt's
    logits; the sharded step fills the prompt teacher-forced and its
    logits are held against the prefill's within :func:`logit_bound_of`;
    the prefix commit equals the plain commit of the same cache values
    (chunk keys, hashes, bytes); flavors 1, 2, 1 each generate from the
    prefix and roll back to it, timed and verified exact by block_diff on
    the local shards.  Then the sharded step, teacher-forced from the prefix,
    is held against the plain graphed step on plain copies of the same
    caches; one sharded step runs under ``CommDebugMode`` and must issue
    its three reductions in every attention layer.  The launches of the
    plain comparisons are not counted.  The group is destroyed on the way
    out."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.core import KishuSession, open_store
    from repro_torch.core.delta import exact_dirty_indices
    from repro_torch.core.graph import key_str
    from repro_torch.core.serialize import global_image
    from repro_torch.kernels import _lib
    from repro_torch.launch.mesh import init_file_group, make_local_mesh
    from repro_torch.models import lm
    from repro_torch.models.config import get_config
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.sharding.rules import (ShardingRules, distribute_tree,
                                            shard_caches)
    from repro_torch.train import step as step_lib

    rec: dict = {}
    t_all = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    init_file_group("nccl", 0, 1, str(workdir / "pg_store"))
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              "phase9: no one-rank NCCL group")
        mesh = make_local_mesh(model=1)
        check(mesh.device_type == "cuda", f"phase9: mesh on {mesh}")
        cfg = get_config("smollm-360m").replace(n_layers=SHARD_LAYERS)
        params = lm.init_params(cfg, torch.Generator(device=dev)
                                .manual_seed(0))
        rules = ShardingRules(cfg, mesh)
        dparams = distribute_tree(params, mesh,
                                  rules.param_shardings(params))
        b, plen, gen, vocab = (SHARD_BATCH, SHARD_PROMPT, SHARD_GEN,
                               cfg.vocab_size)
        rec.update(arch=cfg.name, layers=SHARD_LAYERS, batch=b,
                   slots=SHARD_SLOTS, prompt=plen, gen=gen,
                   chunk_bytes=SERVE_CHUNK)
        logit_bound = logit_bound_of(torch, cfg, params)
        rec["logit_bound"] = logit_bound
        prompts = torch.randint(0, vocab, (b, plen), dtype=torch.int32,
                                device=dev, generator=torch.Generator(
                                    device=dev).manual_seed(1))
        tok_pl = list(rules.batch_spec({"t": prompts})["t"])

        def dtok(t):
            return distribute_tensor(t.contiguous(), mesh, tok_pl)

        def new_caches():
            return shard_caches(lm.init_caches(cfg, b, SHARD_SLOTS,
                                               device=dev), rules, b)

        def sharded_logits(caches, tok, index):
            with torch.no_grad(), step_lib.spmd(dparams):
                lg, _ = lm.decode_step(cfg, dparams, caches,
                                       {"tokens": dtok(tok),
                                        "index": index})
            return lg.full_tensor()

        graphed = step_lib.GraphedDecodeStep(cfg)

        def sharded_step(_params, caches, bt):
            # the path: the sharded step replayed from its CUDA graph
            nxt, caches = graphed(dparams, caches,
                                  {**bt, "tokens": dtok(bt["tokens"])})
            return nxt.full_tensor(), caches

        prefill_step = step_lib.make_prefill_step(cfg)
        held: dict = {}

        def prefill(ns):
            t0 = time.perf_counter()
            logits = prefill_step(dparams, {"tokens": dtok(prompts)})
            logits = logits.full_tensor()
            torch.cuda.synchronize()
            rec["prefill_step_s"] = time.perf_counter() - t0
            rec["prefill_step_routes"] = \
                _lib.route_launches()["flash_attention"]
            check(tuple(logits.shape) == (b, plen, cfg.padded_vocab)
                  and bool(torch.isfinite(logits).all()),
                  f"phase9 prefill logits {tuple(logits.shape)}")
            caches = new_caches()
            t0 = time.perf_counter()
            err = torch.zeros((), device=dev)
            tok = prompts[:, :1]
            for t in range(plen):
                lg, nxt, _ = graphed.with_logits(
                    dparams, caches, {"tokens": dtok(tok), "index": t})
                lg = lg.full_tensor()
                err = torch.maximum(err, (lg[:, 0] - logits[:, t]).abs()
                                    .max())
                tok = prompts[:, t + 1:t + 2] if t + 1 < plen \
                    else nxt.full_tensor()
            torch.cuda.synchronize()
            rec["decode_prefill_s"] = time.perf_counter() - t0
            rec["decode_prefill_captures"] = graphed.captures
            rec["decode_prefill_capture_s"] = graphed.capture_s
            rec["prefill_decode_max_abs_err"] = float(err)
            ns.set_tree("caches", caches)
            ns["last_tok"] = tok
            ns["pos"] = plen

        def generate(ns, n, flavor):
            caches = ns.get_tree("caches")
            tok, pos, outs = ns["last_tok"], ns["pos"], []
            for t in range(n):
                tok, caches = sharded_step(None, caches,
                                           {"tokens": (tok + flavor) % vocab,
                                            "index": pos + t})
                outs.append(tok)
            ns["last_tok"] = tok
            ns["pos"] = pos + n
            ns["generated"] = torch.cat(outs, dim=1)
            torch.cuda.synchronize()

        def compare(ns):
            # the graphed sharded step against the eager sharded step on a
            # copy of the same caches (bit for bit) and against the plain
            # graphed step on plain copies (the bf16 bound), teacher-
            # forced; the eager step's collectives in one step
            caches = ns.get_tree("caches")
            eager_caches = tree_map(lambda x: x.clone(), caches)
            with uncounted(held):
                plain = tree_map(lambda x: global_image(x).clone(), caches)
            toks = torch.randint(0, vocab, (b, SHARD_COMPARE),
                                 dtype=torch.int32, device=dev,
                                 generator=torch.Generator(device=dev)
                                 .manual_seed(9))
            plain_graphed = step_lib.GraphedDecodeStep(cfg)
            pos, err, t0 = ns["pos"], 0.0, time.perf_counter()
            same = True
            for t in range(SHARD_COMPARE):
                tok = toks[:, t:t + 1]
                got, _, _ = graphed.with_logits(
                    dparams, caches, {"tokens": dtok(tok), "index": pos + t})
                got = got.full_tensor()
                if t == 0:
                    comm = CommDebugMode()
                    with comm:
                        eager = sharded_logits(eager_caches, tok, pos + t)
                    rec["step_all_reduce"] = sum(
                        v for k, v in comm.get_comm_counts().items()
                        if str(k).endswith("all_reduce"))
                else:
                    eager = sharded_logits(eager_caches, tok, pos + t)
                same = same and bool(torch.equal(got, eager))
                with uncounted(held):
                    want, _, _ = plain_graphed.with_logits(
                        params, plain, {"tokens": tok, "index": pos + t})
                err = max(err, float((got - want).abs().max()))
            torch.cuda.synchronize()
            rec["compare_s"] = time.perf_counter() - t0
            rec["graphed_equals_eager"] = same and all(
                torch.equal(x.to_local(), y.to_local()) for x, y in
                zip(tree_leaves(caches), tree_leaves(eager_caches)))
            rec["sharded_vs_plain_max_abs_err"] = err
            rec["plain_graph_captures"] = plain_graphed.captures
            ns["pos"] = pos + SHARD_COMPARE

        sess = KishuSession(open_store(f"dir://{workdir}/shard_cas"),
                            chunk_bytes=SERVE_CHUNK, device=dev,
                            group=dist.group.WORLD)
        for name, fn in (("prefill", prefill), ("generate", generate),
                         ("compare", compare)):
            sess.register(name, fn)
        sess.init_state({})

        def cache_names():
            return sorted(n for n in sess.ns.names()
                          if n.startswith("caches/"))

        def local_snapshot():
            return {n: (sess.ns[n].to_local() if isinstance(
                sess.ns[n], DTensor) else sess.ns[n]).clone()
                for n in sess.ns.names()
                if isinstance(sess.ns[n], torch.Tensor)}

        def verify_local(snap, label):
            t0 = time.perf_counter()
            names = sorted(n for n in sess.ns.names()
                           if isinstance(sess.ns[n], torch.Tensor))
            check(names == sorted(snap), f"phase9 {label}: names differ")
            bad = {}
            for n in names:
                x = sess.ns[n]
                x = x.to_local() if isinstance(x, DTensor) else x
                d = exact_dirty_indices(x, snap[n], SERVE_CHUNK)
                if d:
                    bad[n] = d[:4]
            check(not bad, f"phase9 {label}: not bit-identical: {bad}")
            return time.perf_counter() - t0

        _lib.reset_launches()
        t0 = time.perf_counter()
        c_prefix = sess.run("prefill")
        torch.cuda.synchronize()
        rec["prefill_cell_s"] = time.perf_counter() - t0
        check(rec["prefill_step_routes"] == {"tc": SHARD_LAYERS, "fma": 0},
              f"phase9 prefill flash routes {rec['prefill_step_routes']}, "
              f"want all {SHARD_LAYERS} on tc")
        names = cache_names()
        check(names and all(isinstance(sess.ns[n], DTensor)
                            for n in names), "phase9: caches not DTensors")
        rec["cache_bytes"] = sum(sess.ns[n].numel()
                                 * sess.ns[n].element_size() for n in names)
        rec["cache_placements"] = {n.split("/")[-1]: str(
            sess.ns[n].placements) for n in names}
        check(rec["prefill_decode_max_abs_err"] <= logit_bound,
              f"phase9: prefill and sharded decode logits differ by "
              f"{rec['prefill_decode_max_abs_err']} > {logit_bound}")

        # the prefix commit against the plain commit of the same values
        t0 = time.perf_counter()
        ref = KishuSession(open_store(f"dir://{workdir}/plain_cas"),
                           chunk_bytes=SERVE_CHUNK, device=dev)
        tensors = {n: global_image(sess.ns[n]).clone() for n in names}
        with uncounted(held):
            rc = ref.init_state(tensors)
        bad, n_keys, n_bytes = [], 0, 0
        for n in names:
            a = sess.graph.manifest_of(
                (n,), sess.graph.nodes[c_prefix].state_index[key_str((n,))])
            pm = ref.graph.manifest_of((n,), rc)
            ka = [c["key"] for c in a["base"]["chunks"]]
            kb = [c["key"] for c in pm["base"]["chunks"]]
            if ka != kb or a["base"]["det_hashes"] != \
                    pm["base"]["det_hashes"]:
                bad.append(n)
                continue
            got_a, got_b = sess.store.get_chunks(ka), ref.store.get_chunks(kb)
            if any(got_a[k] != got_b[k] for k in ka):
                bad.append(n)
            n_keys += len(ka)
            n_bytes += sum(len(got_a[k]) for k in ka)
        ref.close()
        del tensors
        rec["same_as_plain"] = {"chunks": n_keys, "bytes": n_bytes,
                                "differ": bad, "s": time.perf_counter() - t0}
        check(not bad and n_keys > 0, f"phase9: the prefix commit differs "
              f"from the plain commit of the same values: {bad[:4]}")

        snap0 = local_snapshot()
        snap1, tokens, rollbacks, gens = None, {}, [], []

        def rollback():
            t0 = time.perf_counter()
            st = sess.checkout(c_prefix)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            v = verify_local(snap0, f"rollback {len(rollbacks)}")
            rollbacks.append({"s": dt, "verify_s": v,
                              "covs_patched": st.covs_patched,
                              "covs_loaded": st.covs_loaded,
                              "chunks_patched": st.chunks_patched,
                              "bytes_loaded": st.bytes_loaded})
            check(all(isinstance(sess.ns[n], DTensor) for n in names),
                  f"phase9 rollback {len(rollbacks)}: DTensors lost")

        # flavors 1, 2, 1, each generation followed by a rollback to the
        # prefix; the last rollback leads to the comparison
        for flavor in (1, 2, 1):
            t0 = time.perf_counter()
            cap0, cap_s0 = graphed.captures, graphed.capture_s
            sess.run("generate", n=gen, flavor=flavor)
            torch.cuda.synchronize()
            cap_s = graphed.capture_s - cap_s0
            gens.append({"flavor": flavor, "s": time.perf_counter() - t0,
                         "exec_s": sess.last_run.exec_s,
                         "captures": graphed.captures - cap0,
                         "capture_s": cap_s,
                         "ms_per_step": 1e3 * (sess.last_run.exec_s - cap_s)
                         / gen})
            got = sess.ns["generated"]
            check(tuple(got.shape) == (b, gen) and int(got.max()) < vocab
                  and int(got.min()) >= 0,
                  f"phase9 generated {tuple(got.shape)}")
            if flavor in tokens:
                check(torch.equal(got, tokens[flavor]),
                      f"phase9: flavor {flavor} regenerated other tokens")
                rec["verify_repeat_s"] = verify_local(snap1,
                                                      "repeated flavor")
            else:
                tokens[flavor] = got.clone()
                if snap1 is None:
                    snap1 = local_snapshot()
            rollback()
        check(not torch.equal(tokens[1], tokens[2]),
              "phase9: flavors 1 and 2 generated the same tokens")
        rec["rollbacks"], rec["generates"] = rollbacks, gens
        rec["generate_ms_per_step"] = [g["ms_per_step"] for g in gens]
        del snap1

        # the sharded step against the plain graphed step, from the prefix
        sess.run("compare")
        check(rec["sharded_vs_plain_max_abs_err"] <= logit_bound,
              f"phase9: the sharded step differs from the plain graphed "
              f"step by {rec['sharded_vs_plain_max_abs_err']} > "
              f"{logit_bound}")
        check(rec["step_all_reduce"] == 3 * SHARD_LAYERS,
              f"phase9: {rec['step_all_reduce']} all-reduces in a sharded "
              f"step, want 3 in each of {SHARD_LAYERS} attention layers")
        check(rec["graphed_equals_eager"], "phase9: the graphed sharded "
              "step differs from the eager sharded step (logits or caches)")
        # one capture for the whole phase: the rollbacks patch every cache
        # leaf in place, so the graph's addresses stay live
        rec["captures"], rec["capture_s"] = graphed.captures, \
            graphed.capture_s
        check(graphed.captures == 1, f"phase9: {graphed.captures} captures "
              f"of the sharded step, want 1 (a rollback recaptured)")
        sess.close()
        rec["launches"] = {k: v - held.get(k, 0)
                           for k, v in _lib.launches().items()}
        rec["comparison_launches"] = held
        missing = [k for k in SHARD_PATH_KERNELS if rec["launches"][k] <= 0]
        check(not missing, f"phase9: kernels never launched on the sharded "
                           f"path: {missing}")
    finally:
        dist.destroy_process_group()
    rec["peak_allocated"] = torch.cuda.max_memory_allocated()
    rec["peak_reserved"] = torch.cuda.max_memory_reserved()
    rec["s"] = time.perf_counter() - t_all
    print(f"phase9 {cfg.name}, first {SHARD_LAYERS} of 32 layers, bf16 on a "
          f"(1, 1) NCCL mesh: caches {rec['cache_bytes']} bytes, "
          f"placements {rec['cache_placements']}", flush=True)
    print(f"phase9 sharded prefill {rec['prefill_step_s']:.3f} s (flash "
          f"{rec['prefill_step_routes']}); graphed sharded decode over "
          f"the {plen}-token prompt {rec['decode_prefill_s']:.3f} s "
          f"(capture {rec['decode_prefill_capture_s']:.3f} s), logits "
          f"max abs diff {rec['prefill_decode_max_abs_err']:.4f} (bound "
          f"{logit_bound:.4f})", flush=True)
    print(f"phase9 prefix commit = plain commit: "
          f"{rec['same_as_plain']['chunks']} chunk keys, "
          f"{rec['same_as_plain']['bytes']} bytes", flush=True)
    for i, (g, r) in enumerate(zip(rec["generates"], rec["rollbacks"])):
        print(f"phase9 generate flavor {g['flavor']}: {g['ms_per_step']:.3f}"
              f" ms a step, {g['captures']} captures; rollback {i} to the "
              f"prefix: {r['s']:.3f} s, "
              f"exact on the local shards (block_diff {r['verify_s']:.3f} "
              f"s), {r['covs_patched']} patched ({r['chunks_patched']} "
              f"chunks), {r['covs_loaded']} loaded", flush=True)
    print(f"phase9 graphed sharded step over {SHARD_COMPARE} teacher-forced "
          f"steps: equal to the eager sharded step bit for bit "
          f"{rec['graphed_equals_eager']}; against the plain graphed step "
          f"max abs diff {rec['sharded_vs_plain_max_abs_err']:.5f} (bound "
          f"{logit_bound:.4f}); {rec['step_all_reduce']} all-reduces in one "
          f"eager step; {rec['captures']} capture(s) in the phase, "
          f"{rec['capture_s']:.3f} s", flush=True)
    print(f"phase9 launches {rec['launches']} (comparisons with plain "
          f"tensors, not counted: {rec['comparison_launches']}), "
          f"{rec['s']:.1f} s, peak allocated {rec['peak_allocated']} "
          f"reserved {rec['peak_reserved']}", flush=True)
    check(rec["s"] < PHASE9_LIMIT_S,
          f"phase9 took {rec['s']:.1f} s, over {PHASE9_LIMIT_S:.0f} s")
    return rec


# ---------------------------------------------------------------------------
# Phase 10: Cell K, training where the reference trains (one card)
# ---------------------------------------------------------------------------

def manifests_of(sess, cid: str, names) -> dict:
    """{name: (chunk keys, detection hashes, meta)} of each co-variable in
    commit ``cid``: equal keys are equal bytes (blake2b of the content)."""
    from repro_torch.core.graph import key_str
    out = {}
    for n in names:
        m = sess.graph.manifest_of(
            (n,), sess.graph.nodes[cid].state_index[key_str((n,))])
        out[n] = ([c["key"] for c in m["base"]["chunks"]],
                  m["base"]["det_hashes"], m["base"]["meta"])
    return out


def same_as_store(ref):
    """A store that keeps no chunk: each chunk put into it is held against
    ``ref``'s chunk of the same key (their logical bytes), so a second
    session's commit of the same values can be compared with a first's
    without a second copy of the state in memory."""
    from repro_torch.core import MemoryStore
    from repro_torch.core.chunkstore import ChunkMissingError, decode_chunk

    class SameAs(MemoryStore):
        def __init__(self):
            super().__init__()
            self.checked, self.checked_bytes, self.differ = set(), 0, []

        def put_chunk(self, key, data):
            data = decode_chunk(bytes(data))
            if key not in self.checked:
                self.checked_bytes += len(data)
            self.checked.add(key)
            try:
                same = ref.get_chunk(key) == data
            except ChunkMissingError:
                same = False
            if not same:
                self.differ.append(key)
            return True
    return SameAs()


def host_snapshot(torch, ns) -> dict:
    """Every tensor of ``ns`` copied to host memory (a DTensor's local
    shard), so a later exactness check costs the card no second copy."""
    from torch.distributed.tensor import DTensor
    return {n: (ns[n].to_local() if isinstance(ns[n], DTensor)
                else ns[n]).to("cpu", copy=True)
            for n in ns.names() if isinstance(ns[n], torch.Tensor)}


def phase10_moe(torch, dev, workdir: Path, held: dict) -> dict:
    """Cell K (a): phi3.5-moe-42b-a6.6b at full width, its first
    TRAIN_MOE_LAYERS of 32 layers, bf16 params and float32 moments, as
    DTensors under ShardingRules on a one-rank NCCL (1, 1) mesh; two
    sharded train steps as Kishu cells (MemoryStore) against the plain
    step on a plain copy; the DTensor commit against the plain commit of
    the same values; a checkout back to the first step's commit, exact
    under block_diff.  Launches of the comparisons go to ``held``."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor
    from repro_torch.core import KishuSession, MemoryStore
    from repro_torch.core.namespace import flatten_tree
    from repro_torch.launch.dryrun import opt_config
    from repro_torch.launch.mesh import init_file_group, make_local_mesh
    from repro_torch.models.config import get_config
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.sharding import context as shctx
    from repro_torch.sharding.rules import ShardingRules, shard_train_state
    from repro_torch.train import step as step_lib

    rec: dict = {}
    t_all = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    full = get_config("phi3.5-moe-42b-a6.6b")
    cfg = full.replace(n_layers=TRAIN_MOE_LAYERS)
    opt = dataclasses.replace(opt_config(full), lr=1e-3)
    init_file_group("nccl", 0, 1, str(workdir / "pg_store"))
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              "phase10 moe: no one-rank NCCL group")
        mesh = make_local_mesh(model=1)
        rules = ShardingRules(cfg, mesh)
        plain = step_lib.init_train_state(cfg, 0, opt, device=dev)
        state = shard_train_state(step_lib.init_train_state(cfg, 0, opt,
                                                            device=dev),
                                  rules)
        n_params = sum(t.numel() for t in tree_leaves(plain["params"]))
        rec.update(arch=cfg.name, layers=TRAIN_MOE_LAYERS, params=n_params,
                   moment_dtype=opt.moment_dtype, batch=TRAIN_BATCH,
                   seq=TRAIN_SEQ, state_bytes=sum(
                       t.numel() * t.element_size()
                       for t in tree_leaves(plain)))
        print(f"phase10 {cfg.name}, first {TRAIN_MOE_LAYERS} of 32 layers: "
              f"{n_params} params (bf16, {opt.moment_dtype} moments, "
              f"{rec['state_bytes']} bytes of state) on a "
              f"{tuple(mesh.shape)} NCCL mesh", flush=True)
        hidden = (mesh, rules.hidden_spec(TRAIN_BATCH, TRAIN_SEQ))
        sharded_fn = step_lib.make_train_step(cfg, opt,
                                              hidden_sharding=hidden)
        plain_fn = step_lib.make_train_step(cfg, opt)
        g = torch.Generator(device=dev).manual_seed(13)
        batches = [{k: torch.randint(0, cfg.vocab_size,
                                     (TRAIN_BATCH, TRAIN_SEQ), device=dev,
                                     generator=g, dtype=torch.int32)
                    for k in ("tokens", "labels")} for _ in range(2)]
        sess = KishuSession(MemoryStore(), chunk_bytes=CB, device=dev,
                            group=dist.group.WORLD)
        step_no = {"i": 0}

        def train(ns):
            bt = batches[step_no["i"]]
            bpl = rules.batch_spec(bt)
            with shctx.moe_weight_gather(rules):
                _, m = sharded_fn(ns.get_tree("state"), {
                    k: distribute_tensor(v, mesh, list(bpl[k]))
                    for k, v in bt.items()})
            ns["metrics/loss"] = float(m["loss"].full_tensor())
        sess.register("train", train)

        def whole(x):
            # on a one-rank mesh the local shard is the whole tensor
            if isinstance(x, DTensor):
                check(tuple(x.to_local().shape) == tuple(x.shape),
                      "phase10 moe: a local shard is not the whole tensor")
                return x.to_local()
            return x

        t0 = time.perf_counter()
        c0 = sess.init_state({"state": state})
        rec["attach_s"] = time.perf_counter() - t0
        del state       # the session holds it; a checkout replaces it
        print(f"phase10 moe attach {rec['attach_s']:.2f} s", flush=True)
        names = [n for n in sess.ns.names()
                 if isinstance(sess.ns[n], torch.Tensor)]
        rec["dtensor_covs"] = sum(isinstance(sess.ns[n], DTensor)
                                  for n in names)
        commits, steps, snap1 = [c0], [], None
        for i in range(2):
            step_no["i"] = i
            old_s = {k: whole(v).clone() for k, v in
                     flatten_tree(sess.ns.get_tree("state/params")).items()}
            old_p = {k: v.clone() for k, v in
                     flatten_tree(plain["params"]).items()}
            t0 = time.perf_counter()
            commits.append(sess.run("train"))
            t_cell = time.perf_counter() - t0
            exec_s = sess.last_run.exec_s
            with uncounted(held):
                pm = plain_fn(plain, batches[i])[1]
            loss, ploss = sess.ns["metrics/loss"], float(pm["loss"])
            new_s = flatten_tree(sess.ns.get_tree("state/params"))
            err, rel, same = 0.0, 0.0, True
            for k, p in flatten_tree(plain["params"]).items():
                x, y = whole(new_s[k]).float(), p.float()
                err = max(err, float((x - y).abs().max()))
                same = same and bool(torch.equal(x, y))
                dp = y - old_p[k].float()
                off = float((x - old_s[k].float() - dp).norm())
                den = float(dp.norm())
                rel = max(rel, off / den if den else
                          (0.0 if off == 0 else float("inf")))
            del old_s, old_p, new_s
            steps.append({"cell_s": t_cell, "exec_s": exec_s, "loss": loss,
                          "plain_loss": ploss, "max_param_err": err,
                          "max_delta_rel_err": rel, "bit_identical": same})
            print(f"phase10 moe step {i + 1}: sharded loss {loss:.6f}, "
                  f"plain {ploss:.6f}, params max err {err:.3g}, change "
                  f"against the plain change {rel:.3g} of its norm, "
                  f"bit-identical {same}, cell {t_cell:.2f} s (step and "
                  f"commit {exec_s:.2f} s)", flush=True)
            check(abs(loss - ploss) < 1e-3 and err <= 2e-2
                  and rel <= DELTA_TOL,
                  f"phase10 moe step {i + 1}: sharded against plain "
                  f"{steps[-1]}")
            if i == 0:
                t0 = time.perf_counter()
                snap1 = host_snapshot(torch, sess.ns)
                rec["snapshot_s"] = time.perf_counter() - t0
        rec["steps"] = steps
        check(all(isinstance(sess.ns[n], DTensor) for n in names
                  if n.startswith("state/params")),
              "phase10 moe: a DTensor co-variable lost its placements")

        # the trained state committed as plain tensors: same keys, hashes,
        # meta and logical bytes
        t0 = time.perf_counter()
        ref_store = same_as_store(sess.store)
        ref = KishuSession(ref_store, chunk_bytes=CB, device=dev)
        with uncounted(held):
            rc = ref.init_state({n: whole(sess.ns[n]) for n in names})
        mine = manifests_of(sess, commits[-1], names)
        theirs = manifests_of(ref, rc, names)
        ref.close()
        bad = sorted(n for n in names if mine[n] != theirs[n])
        n_keys = sum(len(mine[n][0]) for n in names)
        distinct = {k for n in names for k in mine[n][0]}
        rec["same_as_plain"] = {"chunks": n_keys, "distinct": len(distinct),
                                "chunks_checked": len(ref_store.checked),
                                "bytes": ref_store.checked_bytes,
                                "differ": bad[:4],
                                "bytes_differ": ref_store.differ[:4],
                                "s": time.perf_counter() - t0}
        check(not bad and not ref_store.differ and n_keys > 0
              and ref_store.checked == distinct,
              f"phase10 moe: the commit differs from the plain commit of "
              f"the same values: {rec['same_as_plain']}")
        print(f"phase10 moe commit = plain commit: {n_keys} chunk keys, "
              f"{ref_store.checked_bytes} bytes", flush=True)
        del plain

        # a checkout back to the first step's commit
        t0 = time.perf_counter()
        st = sess.checkout(commits[1])
        rec["checkout_s"] = time.perf_counter() - t0
        rec["checkout"] = {"covs_patched": st.covs_patched,
                           "covs_loaded": st.covs_loaded,
                           "bytes_loaded": st.bytes_loaded}
        rec["verify_checkout_s"] = verify_exact(
            torch, sess.ns, snap1, "phase10 moe checkout")
        check(all(isinstance(sess.ns[n], DTensor) for n in names
                  if n.startswith("state/params")),
              "phase10 moe checkout: DTensors lost")
        del snap1
        sess.close()
    finally:
        dist.destroy_process_group()
    rec["peak_allocated"] = torch.cuda.max_memory_allocated()
    rec["peak_reserved"] = torch.cuda.max_memory_reserved()
    rec["s"] = time.perf_counter() - t_all
    print(f"phase10 moe: attach {rec['attach_s']:.2f} s, checkout to step 1 "
          f"{rec['checkout_s']:.2f} s ({rec['checkout']}), exact "
          f"(block_diff {rec['verify_checkout_s']:.2f} s); {rec['s']:.1f} "
          f"s, peak allocated {rec['peak_allocated']} reserved "
          f"{rec['peak_reserved']}", flush=True)
    return rec


def phase10_vlm(torch, dev) -> dict:
    """Cell K (b): qwen2-vl-72b at full width, its first TRAIN_VLM_LAYERS
    of 80 layers, bf16 params and bf16 moments, plain tensors; one train
    cell from a seeded batch of frontend ``embeds`` and ``positions_thw``
    (MemoryStore): ``embed``'s gradient is zero (its moments stay zero)
    and its new value is the decay-only AdamW update; a rollback to the
    parent is exact under block_diff and the cell replayed from there
    commits the same chunk keys as the first run, every co-variable."""
    from repro_torch.core import KishuSession, MemoryStore
    from repro_torch.launch.dryrun import opt_config
    from repro_torch.models.config import get_config
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import step as step_lib

    rec: dict = {}
    t_all = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    full = get_config("qwen2-vl-72b")
    cfg = full.replace(n_layers=TRAIN_VLM_LAYERS)
    opt = dataclasses.replace(opt_config(full), lr=1e-3)
    state = step_lib.init_train_state(cfg, 0, opt, device=dev)
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    rec.update(arch=cfg.name, layers=TRAIN_VLM_LAYERS, params=n_params,
               moment_dtype=opt.moment_dtype, batch=TRAIN_BATCH,
               seq=TRAIN_SEQ, state_bytes=sum(
                   t.numel() * t.element_size() for t in tree_leaves(state)))
    print(f"phase10 {cfg.name}, first {TRAIN_VLM_LAYERS} of 80 layers: "
          f"{n_params} params (bf16, {opt.moment_dtype} moments, "
          f"{rec['state_bytes']} bytes of state)", flush=True)
    g = torch.Generator(device=dev).manual_seed(14)
    t = torch.arange(TRAIN_SEQ, device=dev, dtype=torch.int32)
    thw = torch.stack([t // 64, (t // 8) % 8, t % 8], dim=-1)
    batch = {"embeds": torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.d_model),
                                   device=dev, generator=g)
             .to(torch.bfloat16),
             "positions_thw": thw.expand(TRAIN_BATCH, TRAIN_SEQ, 3)
             .contiguous(),
             "labels": torch.randint(0, cfg.vocab_size,
                                     (TRAIN_BATCH, TRAIN_SEQ), device=dev,
                                     generator=g, dtype=torch.int32)}
    train_fn = step_lib.make_train_step(cfg, opt)
    sess = KishuSession(MemoryStore(), chunk_bytes=CB, device=dev)

    def train(ns):
        _, m = train_fn(ns.get_tree("state"), batch)
        ns["metrics/loss"] = float(m["loss"])
    sess.register("train", train)
    try:
        t0 = time.perf_counter()
        c0 = sess.init_state({"state": state})
        rec["attach_s"] = time.perf_counter() - t0
        del state       # the session holds it; a checkout replaces it
        t0 = time.perf_counter()
        snap0 = host_snapshot(torch, sess.ns)
        rec["snapshot_s"] = time.perf_counter() - t0
        e0 = sess.ns["state/params/embed"].clone()
        t0 = time.perf_counter()
        c1 = sess.run("train")
        rec["train_s"] = time.perf_counter() - t0
        rec["train_exec_s"] = sess.last_run.exec_s
        rec["loss"] = sess.ns["metrics/loss"]
        names = sorted(n for n in sess.ns.names()
                       if isinstance(sess.ns[n], torch.Tensor))
        first = manifests_of(sess, c1, names)
        # a zero gradient leaves both moments zero (clip > 0): exact
        mu, nu = sess.ns["state/opt/mu/embed"], sess.ns["state/opt/nu/embed"]
        rec["embed_moments_zero"] = not bool(mu.any()) and not bool(nu.any())
        lr = torch.tensor(opt.lr, dtype=torch.float32, device=dev)
        decayed = (e0.float() * (1 - lr * opt.weight_decay)).to(e0.dtype)
        rec["embed_decay_only"] = bool(torch.equal(
            sess.ns["state/params/embed"], decayed))
        del e0, decayed
        check(rec["embed_moments_zero"] and rec["embed_decay_only"],
              f"phase10 vlm: embed's gradient is not zero or its update is "
              f"not the decay alone ({rec['embed_moments_zero']}, "
              f"{rec['embed_decay_only']})")
        check(math.isfinite(rec["loss"]), f"phase10 vlm loss {rec['loss']}")

        t0 = time.perf_counter()
        st = sess.checkout(c0)
        rec["rollback_s"] = time.perf_counter() - t0
        rec["rollback"] = {"covs_patched": st.covs_patched,
                           "covs_loaded": st.covs_loaded,
                           "bytes_loaded": st.bytes_loaded}
        rec["verify_rollback_s"] = verify_exact(
            torch, sess.ns, snap0, "phase10 vlm rollback")
        del snap0
        t0 = time.perf_counter()
        c2 = sess.run("train")
        rec["replay_s"] = time.perf_counter() - t0
        again = manifests_of(sess, c2, names)
        bad = sorted(n for n in names if again[n] != first[n])
        rec["replay_differ"] = bad[:4]
        rec["replay_chunks"] = sum(len(first[n][0]) for n in names)
        check(not bad and sess.ns["metrics/loss"] == rec["loss"],
              f"phase10 vlm: the replayed train cell differs: {bad[:4]}, "
              f"loss {sess.ns['metrics/loss']} against {rec['loss']}")
    finally:
        sess.close()
    rec["peak_allocated"] = torch.cuda.max_memory_allocated()
    rec["peak_reserved"] = torch.cuda.max_memory_reserved()
    rec["s"] = time.perf_counter() - t_all
    print(f"phase10 vlm: loss {rec['loss']:.6f}; embed gradient zero, "
          f"update decay-only; attach {rec['attach_s']:.2f} s, train cell "
          f"{rec['train_s']:.2f} s, rollback {rec['rollback_s']:.2f} s "
          f"({rec['rollback']}, exact: block_diff "
          f"{rec['verify_rollback_s']:.2f} s), replay {rec['replay_s']:.2f} "
          f"s with the same {rec['replay_chunks']} chunk keys; "
          f"{rec['s']:.1f} s, peak allocated {rec['peak_allocated']} "
          f"reserved {rec['peak_reserved']}", flush=True)
    return rec


def phase10(torch, dev, workdir: Path) -> dict:
    """Cell K: training where the JAX package trains and the port raised
    before — through MoE layers on DTensors (:func:`phase10_moe`) and from
    a frontend's embeddings (:func:`phase10_vlm`).  Launch counts are read
    from both parts together, the comparisons' taken out."""
    from repro_torch.kernels import _lib
    t_all = time.perf_counter()
    held: dict = {}
    _lib.reset_launches()
    rec = {"moe": phase10_moe(torch, dev, workdir, held)}
    free_card(torch)
    rec["vlm"] = phase10_vlm(torch, dev)
    rec["moe_s"], rec["vlm_s"] = rec["moe"]["s"], rec["vlm"]["s"]
    rec["launches"] = {k: v - held.get(k, 0)
                       for k, v in _lib.launches().items()}
    rec["comparison_launches"] = held
    rec["s"] = time.perf_counter() - t_all
    missing = [k for k in TRAIN_PATH_KERNELS if rec["launches"][k] <= 0]
    print(f"phase10 launches {rec['launches']} (comparisons with plain "
          f"tensors, not counted: {held}), {rec['s']:.1f} s", flush=True)
    check(not missing, f"phase10: kernels never launched on the training "
                       f"path: {missing}")
    check(rec["s"] < PHASE10_LIMIT_S,
          f"phase10 took {rec['s']:.1f} s, over {PHASE10_LIMIT_S:.0f} s")
    return rec


def moe_capacity(cfg, n_tokens: int) -> int:
    from repro_torch.models.moe import capacity
    return capacity(n_tokens, cfg.moe)


def parse_args(argv):
    import argparse
    ap = argparse.ArgumentParser(description="Drive the port on one card.")
    ap.add_argument("--only", type=lambda v: v.split(","), default=[],
                    help=f"run only these phases, comma-separated, of "
                         f"{', '.join(TIMED_PHASES)}")
    ap.add_argument("--root", type=lambda v: Path(v).resolve(), default=ROOT,
                    help="the tree whose chip_smoke.py and src/ --only runs")
    args = ap.parse_args(argv)
    bad = [p for p in args.only if p not in TIMED_PHASES]
    if bad:
        ap.error(f"--only takes {', '.join(TIMED_PHASES)}, not {bad}")
    return args


def free_card(torch) -> None:
    """Between phases: collect the reference cycles a phase leaves (a
    session's registered cells close over its caches and parameters), so
    their tensors and CUDA graphs go now, then return the cached blocks
    to the card.  Cells G and H need most of it."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def only_phases(torch, phases, root: Path) -> int:
    """Run ``phases`` alone, from the ``chip_smoke.py`` under ``root``
    (its ``src/`` is first on the path), and print each one's wall times
    as one line: ``timed <phase> <root> {...}``."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke_timed",
                                                  root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    from repro_torch.kernels import _lib
    _lib.load_all()
    dev = torch.device("cuda")
    print(f"card: {nvidia_smi_line()}", flush=True)
    for name in phases:
        workdir = Path(tempfile.mkdtemp(prefix=f"kishu_{name}_"))
        try:
            rec = getattr(mod, name)(torch, dev, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        free_card(torch)
        times = {k: v for k, v in rec.items()
                 if k.endswith(("_s", "_ms_per_step", "_bytes"))
                 and isinstance(v, (int, float))}
        if "generate_ms_per_step" in rec:
            times["generate_ms_per_step"] = rec["generate_ms_per_step"]
        print(f"timed {name} {root} {json.dumps(times)}", flush=True)
    return 0


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    args = parse_args(sys.argv[1:])
    src = args.root / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no repro_torch package under {src}; run it from "
              f"the repository root", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    if args.only:
        return only_phases(torch, args.only, args.root)
    from repro_torch.kernels import _lib

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    print(f"card: {smi}", flush=True)
    t0 = time.perf_counter()
    _lib.load_all()
    build_s = time.perf_counter() - t0
    print(f"phase0: built and loaded {len(_lib.KERNELS)} kernel libraries "
          f"in {build_s:.2f} s", flush=True)
    for log in sorted(_lib.build_dir().glob("*.log")):
        for line in log.read_text(errors="replace").splitlines():
            if "registers" in line and "Used" in line or "spill" in line:
                print(f"phase0 {log.stem.split('-')[0]}: {line.strip()}")

    record: dict = {"card": smi, "device": torch.cuda.get_device_name(0),
                    "torch": torch.__version__, "cuda": torch.version.cuda,
                    "build_s": build_s}
    t0 = time.perf_counter()
    kernels = phase1(torch, dev)
    kernels.append(phase1_flash(torch, dev))
    kernels.append(phase1_chunk_key(torch, dev))
    record["phase1_s"] = time.perf_counter() - t0
    free_card(torch)
    workdir = Path(tempfile.mkdtemp(prefix="kishu_smoke_"))
    try:
        t0 = time.perf_counter()
        record["phase2"] = phase2(torch, dev, workdir)
        record["phase2_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    free_card(torch)
    record["phase3"] = phase3(torch)
    free_card(torch)
    workdir = Path(tempfile.mkdtemp(prefix="kishu_smoke_train_"))
    try:
        t0 = time.perf_counter()
        record["phase4"], snap1 = phase4(torch, dev, workdir)
        record["phase4_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        record["phase4b"] = phase4b(torch, dev, workdir, record["phase4"],
                                    snap1)
        record["phase4b_s"] = time.perf_counter() - t0
        del snap1
        free_card(torch)
        c = record["phase4"]["commits"]
        record["cli_phase4"] = cli_verbs(f"dir://{workdir}/train_cas",
                                         c[1], "cli phase4")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    free_card(torch)
    workdir = Path(tempfile.mkdtemp(prefix="kishu_smoke_serve_"))
    try:
        t0 = time.perf_counter()
        record["phase5"] = phase5(torch, dev, workdir)
        record["phase5_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    free_card(torch)
    workdir = Path(tempfile.mkdtemp(prefix="kishu_smoke_fabric_"))
    try:
        t0 = time.perf_counter()
        record["phase6"] = phase6(torch, dev, workdir)
        record["phase6_s"] = time.perf_counter() - t0
        record["cli_phase6"] = cli_verbs(record["phase6"]["store"],
                                         record["phase6"]["commits"][0],
                                         "cli phase6")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for phase, fn in (("phase7", phase7), ("phase7b", phase7b),
                      ("phase7c", phase7c), ("phase7d", phase7d),
                      ("phase8", phase8), ("phase9", phase9),
                      ("phase10", phase10)):
        free_card(torch)
        workdir = Path(tempfile.mkdtemp(prefix=f"kishu_smoke_{phase}_"))
        try:
            t0 = time.perf_counter()
            record[phase] = fn(torch, dev, workdir)
            record[f"{phase}_s"] = time.perf_counter() - t0
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    # launches: each kernel's count on the path that first needed it —
    # Phase 2 (commit -> checkout) for the four, Phase 4 (trainer) for
    # block_diff, Phase 5 (serving) for flash_attention — and, beside it,
    # its count on each path's own run
    first_path = {"block_diff": "phase4", "flash_attention": "phase5"}
    for row in kernels:
        phase = first_path.get(row["name"], "phase2")
        row["launches"] = record[phase]["launches"][row["name"]]
        row["launches_by_path"] = {p: record[p]["launches"][row["name"]]
                                   for p in PATHS}
    record["kernels"] = kernels
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "launches_by_path")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in kernels]}), flush=True)
    print(f"card: {nvidia_smi_line()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
