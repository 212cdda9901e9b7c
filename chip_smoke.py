#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Kishu on one NVIDIA card, end to end.

    python3 chip_smoke.py          # from the repository root; one card, nvcc

Phase 0  builds the four CUDA kernels from ``src/repro_torch/csrc`` (one
         nvcc per source, all started together) and prints the card's name
         and power limit.
Phase 1  holds every kernel against its plain torch version on the card at
         the main path's shapes (1 MiB chunks of a 49152 x 960 fp32 tensor,
         plus ragged bf16 / unaligned uint8 tensors) — results must be
         bit-identical — and times the kernel, the plain version, the
         least time the card could take (the bound), and for patch_scatter
         the one PyTorch call that computes the same function.
Phase 2  the main path: a ``KishuSession`` on a ``dir://`` store commits a
         SmolLM-360M-shaped fine-tuning state (fp32 params + AdamW m and v,
         870 tensors, 4.34 GB, random from a seeded CUDA generator), runs an
         AdamW step on layers 28-31 and re-initialises two vocabulary
         slices (rows 32768-37682 and 40000-44914), then checks out back
         and forward; every tensor must come back bit-identical.  Kernel
         launch counts are read from this phase only.
Phase 3  the same small cells through a CUDA session and a CPU session (the
         plain versions) must write identical stores.

Output: per-phase lines, one JSON line of kernels, the nvidia-smi line,
and last ``{"ok": true, "device": {...}}``.  The full record goes to
``build/chip_smoke.json``.  Without a card, or outside the
repository, it exits non-zero before printing any result.
"""
from __future__ import annotations

import json
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
HASH_OPS_PER_WORD = 18               # kernel's integer ops per hashed word
# least integer ops per word the codec's function needs (not this kernel's
# ballot design): a 32 x 32 bit transpose in 5 butterfly stages, each a
# shift, an xor and an and per word (6 ops per swapped pair of words), plus
# an OR and an AND per plane word to classify planes as zero or ones
CODEC_OPS_PER_WORD = 5 * 3 + 2

# SmolLM-360M (hf:HuggingFaceTB/SmolLM-360M): 32 layers, d_model 960,
# 15 query / 5 key-value heads of 64, d_ff 2560, vocab 49152, tied embeddings
N_LAYERS, D_MODEL, N_HEADS, N_KV, HEAD_DIM, D_FF, VOCAB = \
    32, 960, 15, 5, 64, 2560, 49152
TOP_LAYERS = range(28, 32)           # finetune_top updates these
# reinit_vocab_slice runs on two slices of 4915 rows: one that starts on a
# 4 MiB boundary (row 32768 = 120 MiB), whose zeroed moments the sampled
# codec probe accepts, and one that starts mid-chunk (row 40000), where the
# probe samples half-old rows and sends the whole slice raw
VOCAB_ROWS = (32768, 37683)
VOCAB_ROWS_MID = (40000, 44915)


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


def param_shapes() -> dict:
    q, kv = N_HEADS * HEAD_DIM, N_KV * HEAD_DIM
    shapes = {"embed": (VOCAB, D_MODEL), "final_norm": (D_MODEL,)}
    for i in range(N_LAYERS):
        p = f"layers/{i:02d}"
        shapes.update({
            f"{p}/attn_norm": (D_MODEL,), f"{p}/attn/q": (D_MODEL, q),
            f"{p}/attn/k": (D_MODEL, kv), f"{p}/attn/v": (D_MODEL, kv),
            f"{p}/attn/o": (q, D_MODEL), f"{p}/mlp_norm": (D_MODEL,),
            f"{p}/mlp/gate": (D_MODEL, D_FF), f"{p}/mlp/up": (D_MODEL, D_FF),
            f"{p}/mlp/down": (D_FF, D_MODEL)})
    return shapes


def top_names() -> list:
    return [n for n in param_shapes()
            if any(n.startswith(f"layers/{i:02d}/") for i in TOP_LAYERS)]


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


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(torch, a, b) -> float:
    a, b = a.to(torch.int64), b.to(torch.int64)
    return float((a - b).abs().max()) if a.numel() else 0.0


def phase1(torch, dev) -> list:
    from repro_torch.core.hashing import MASK32, chunk_hashes_plain
    from repro_torch.kernels.chunk_hash.ops import chunk_hash_cuda
    from repro_torch.kernels.delta_codec import host as codec_host
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
    rows_out.append({
        "name": "chunk_hash", "route": "cuda",
        "source": "src/repro_torch/csrc/chunk_hash.cu",
        "replaces": "src/repro/kernels/chunk_hash/kernel.py:61",
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: chunk_hash_cuda(u8, CB), 20),
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
    rows_out.append({
        "name": "delta_pack", "route": "cuda",
        "source": "src/repro_torch/csrc/delta_pack.cu",
        "replaces": "src/repro/kernels/delta_pack/kernel.py:112",
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: delta_pack_cuda(u8b, prev32, CB), 20),
        "plain_ms": time_ms(torch, lambda: delta_pack_plain(u8b, prev, CB),
                            2),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"fp32 [{VOCAB}, {D_MODEL}], {kcount} of {n} chunks dirty"})

    # -- delta_codec: the compacted rows of a zeroed AdamW-moment slice
    m0 = torch.empty((VOCAB, D_MODEL), device=dev).normal_(0, 1e-3,
                                                           generator=g)
    m1 = m0.clone()
    m1[lo:hi] = 0
    _, _, _, mcount, rows = delta_pack_cuda(
        m1.view(-1).view(torch.uint8),
        i32_bits(chunk_hashes_plain(m0.view(-1).view(torch.uint8), CB)), CB)
    gw = 1024
    km, kn, kp = codec_encode_cuda(rows, gw)
    pm, pn, pp = codec_encode_plain(u32_values(rows), gw)
    check(kn == pn > 0, f"codec stored planes {kn} vs {pn}")
    outs = [(km.to(torch.int64) & MASK32, pm), (kp, i32_bits(pp))]
    check(all(torch.equal(a.to(torch.int64), b.to(torch.int64))
              for a, b in outs), "delta_codec != plain")
    err = max(max_abs_err(torch, a, b) for a, b in outs)
    masks = km.cpu().numpy().view("<u4")
    planes = kp.cpu().numpy().view("<u4")
    frames = codec_host.frames_from_encoded(masks, planes, (CB // 4) // gw,
                                            gw, [CB] * mcount)
    host_rows = rows.cpu().numpy()
    for r in (0, mcount - 1):              # a zeroed row and a mixed one
        want = codec_host.make_frame(
            codec_host.bitplane_compress(host_rows[r].tobytes(), gw), CB)
        check(frames[r] == want, f"device frame {r} != host bitplane frame")
    rw = rows.numel()
    b_ms, b_by = bound(rw * 4 + masks.nbytes + planes.nbytes,
                       CODEC_OPS_PER_WORD * rw)
    rows_out.append({
        "name": "delta_codec", "route": "cuda",
        "source": "src/repro_torch/csrc/delta_codec.cu",
        "replaces": "src/repro/kernels/delta_codec/kernel.py:105",
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: codec_encode_cuda(rows, gw), 20),
        "plain_ms": time_ms(torch,
                            lambda: codec_encode_plain(u32_values(rows), gw),
                            2),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"{mcount} rows x 262144 words, {kn} stored planes"})

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
    rows_out.append({
        "name": "patch_scatter", "route": "cuda",
        "source": "src/repro_torch/csrc/patch_scatter.cu",
        "replaces": "src/repro/kernels/patch_scatter/kernel.py:55",
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: patch_scatter_cuda(a, CB, idx, kbuf),
                      50),
        "plain_ms": time_ms(torch, lambda: patch_scatter_plain(
            b, CB, idx_list, kbuf), 10),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(torch, lambda: words_view.index_copy_(
            0, lib_idx, kbuf), 50),
        "shape": f"{k_rows} chunks of 1 MiB into fp32 [{VOCAB}, {D_MODEL}]"})
    for r in rows_out:
        print(f"phase1 {r['name']}: bit-identical to plain; {r['shape']}; "
              f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"library {r['library_ms']}", flush=True)
    return rows_out


# ---------------------------------------------------------------------------
# Phase 2: the main path
# ---------------------------------------------------------------------------

def make_state(torch, dev) -> dict:
    g = torch.Generator(device=dev).manual_seed(0)
    params, m, v = {}, {}, {}
    for name, shape in param_shapes().items():
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


def finetune_top(ns, step: int) -> None:
    """One in-place AdamW-style step on layers 28-31 (params, m, v)."""
    import torch
    g = None
    for name in top_names():
        p = ns[f"params/{name}"]
        if g is None:
            g = torch.Generator(device=p.device).manual_seed(1000 + step)
        m, v = ns[f"opt/m/{name}"], ns[f"opt/v/{name}"]
        grad = torch.empty_like(p).normal_(0, 1e-2, generator=g)
        m.mul_(0.9).add_(grad, alpha=0.1)
        v.mul_(0.999).addcmul_(grad, grad, value=0.001)
        p.addcdiv_(m, v.sqrt().add_(1e-8), value=-1e-4)


def reinit_vocab_slice(ns, lo: int, hi: int) -> None:
    """Re-initialise embedding rows [lo, hi) and zero their moments."""
    import torch
    emb = ns["params/embed"]
    g = torch.Generator(device=emb.device).manual_seed(7)
    emb[lo:hi].normal_(0, 0.02, generator=g)
    ns["opt/m/embed"][lo:hi].zero_()
    ns["opt/v/embed"][lo:hi].zero_()


def snapshot(torch, sess) -> dict:
    return {n: sess.ns[n].clone() for n in sess.ns.names()}


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
        snap0 = snapshot(torch, sess)

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
        snap2 = snapshot(torch, sess)

        for label, target, snap in (("checkout_back", c_attach, snap0),
                                     ("checkout_forward", c_vocab, snap2)):
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
    missing = [k for k, v in rec["launches"].items() if v <= 0]
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


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no repro_torch package under {src}; run it from "
              f"the repository root", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
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
            if "registers" in line:
                print(f"phase0 {log.stem.split('-')[0]}: {line.strip()}")

    record: dict = {"card": smi, "device": torch.cuda.get_device_name(0),
                    "torch": torch.__version__, "cuda": torch.version.cuda,
                    "build_s": build_s}
    t0 = time.perf_counter()
    kernels = phase1(torch, dev)
    record["phase1_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    workdir = Path(tempfile.mkdtemp(prefix="kishu_smoke_"))
    try:
        t0 = time.perf_counter()
        record["phase2"] = phase2(torch, dev, workdir)
        record["phase2_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    record["phase3"] = phase3(torch)
    for row in kernels:
        row["launches"] = record["phase2"]["launches"][row["name"]]
    record["kernels"] = kernels
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in kernels]}), flush=True)
    print(f"card: {nvidia_smi_line()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
