"""Frozen arithmetic of the benchmark: model FLOPs a decoded token, the
least bytes of Kishu's commit and undo, and the H100's datasheet peaks.

Everything here is reckoned from a configuration file's numbers and a
traffic mix's shapes, never from the program's counters, so a change to
the program cannot move the yardstick.  ``tests/test_portbench_arith.py``
holds it against hand-worked SmolLM-360M and Mamba-2 780M numbers.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

# NVIDIA H100 SXM5 datasheet, dense rates (no sparsity), at 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_FP8_FLOPS = 1979e12
PEAK_TF32_FLOPS = 495e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "int32": 4,
               "int64": 8}


def head_dim(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def ssm_dims(m: dict) -> Tuple[int, int, int, int]:
    """(d_inner, SSD heads, conv channels, in_proj width) of a Mamba-2
    configuration."""
    s = m["ssm"]
    d_in = s["expand"] * m["d_model"]
    nh = d_in // s["head_dim"]
    gn = s["n_groups"] * s["d_state"]
    return d_in, nh, d_in + 2 * gn, 2 * d_in + 2 * gn + nh


def flops_per_token(m: dict, context: int) -> int:
    """Model FLOPs of decoding one token that attends over ``context``
    positions (itself included): 2 per multiply-add of every projection,
    of attention's two products over the filled context, of the SSM's
    state update and readout, and of the unembedding over the true
    vocabulary.  Norms, rotations and other elementwise work are left
    out, as model-FLOP counts do."""
    d, v = m["d_model"], m["vocab_size"]
    if m.get("family") == "ssm":
        s = m["ssm"]
        d_in, nh, conv_ch, proj = ssm_dims(m)
        state = nh * s["head_dim"] * s["d_state"]
        layer = (2 * d * proj                     # in_proj
                 + 2 * s["conv_width"] * conv_ch  # depthwise conv
                 + 4 * state                      # x (x) B into the state, C . state
                 + 2 * d_in * d)                  # out_proj
    else:
        hd = head_dim(m)
        q, kv = m["n_heads"] * hd, m["n_kv_heads"] * hd
        layer = (2 * d * q + 2 * 2 * d * kv + 2 * q * d   # q, k, v, o
                 + 3 * 2 * d * m["d_ff"]                  # gate, up, down
                 + 2 * 2 * q * context)                   # QK^T, PV
    return m["n_layers"] * layer + 2 * d * v


def generate_flops(m: dict, batch: int, start: int, n: int) -> int:
    """FLOPs of ``n`` greedy steps for ``batch`` sequences whose first
    generated token sits at position ``start``."""
    return batch * sum(flops_per_token(m, start + t + 1) for t in range(n))


# ---------------------------------------------------------------------------
# the state a generate cell writes, and the chunks it dirties
# ---------------------------------------------------------------------------

Leaf = Tuple[str, Tuple[int, ...], str, Optional[int]]
"""(name, shape, dtype, axis): ``axis`` is the axis along which the cell
writes the slots ``[start, start + n)``; None for a leaf it rewrites
whole."""


def cache_leaves(m: dict, batch: int, seq: int) -> List[Leaf]:
    """The device leaves a generate cell writes: the decode caches as the
    port lays them out (stacked ``[n_layers, ...]``), the last token and
    the generated tokens."""
    L = m["n_layers"]
    dt = m.get("dtype", "bfloat16")
    if m.get("family") == "ssm":
        s = m["ssm"]
        _, nh, conv_ch, _ = ssm_dims(m)
        leaves: List[Leaf] = [
            ("conv", (L, batch, s["conv_width"] - 1, conv_ch), dt, None),
            ("state", (L, batch, nh, s["head_dim"], s["d_state"]),
             "float32", None)]
    else:
        kv = (L, batch, seq, m["n_kv_heads"], head_dim(m))
        leaves = [("k", kv, dt, 2), ("v", kv, dt, 2),
                  ("index", (L,), "int32", None)]
    return leaves + [("last_tok", (batch, 1), "int32", None)]


def _prod(xs: Sequence[int]) -> int:
    out = 1
    for x in xs:
        out *= x
    return out


def leaf_bytes(leaf: Leaf) -> int:
    _, shape, dt, _ = leaf
    return _prod(shape) * DTYPE_BYTES[dt]


def dirty_chunks(leaf: Leaf, start: int, n: int, chunk_bytes: int) -> int:
    """Chunks of ``chunk_bytes`` that a write of slots ``[start, start+n)``
    along the leaf's axis touches (every chunk for a whole rewrite)."""
    _, shape, dt, axis = leaf
    total = leaf_bytes(leaf)
    if axis is None:
        return -(-total // chunk_bytes)
    row = _prod(shape[axis + 1:]) * DTYPE_BYTES[dt]
    span = shape[axis] * row
    count, last = 0, -1
    for i in range(_prod(shape[:axis])):
        lo = i * span + start * row
        hi = i * span + (start + n) * row
        first, end = lo // chunk_bytes, (hi - 1) // chunk_bytes
        first = max(first, last + 1)
        if end >= first:
            count += end - first + 1
            last = end
    return count


def cell_bytes(m: dict, batch: int, prompt: int, gen: int,
               chunk_bytes: int) -> Dict[str, int]:
    """What a generate cell leaves for Kishu: ``written`` (bytes of every
    device leaf it wrote, the new ``generated`` leaf included), ``dirty``
    (the dirty chunks' bytes, each chunk counted whole and the last of a
    leaf cut at its end) and ``chunks``."""
    seq = prompt + gen
    leaves = cache_leaves(m, batch, seq) + [
        ("generated", (batch, gen), "int32", None)]
    written = sum(leaf_bytes(x) for x in leaves)
    chunks = dirty = 0
    for leaf in leaves:
        c = dirty_chunks(leaf, prompt, gen, chunk_bytes)
        chunks += c
        dirty += min(c * chunk_bytes, leaf_bytes(leaf))
    return {"written": written, "dirty": dirty, "chunks": chunks}


def commit_least_bytes(m: dict, batch: int, prompt: int, gen: int,
                       chunk_bytes: int) -> int:
    """Least device bytes of a commit: every byte the cell wrote, read once
    (detection has to look at it), plus the dirty chunks, written once."""
    c = cell_bytes(m, batch, prompt, gen, chunk_bytes)
    return c["written"] + c["dirty"]


def undo_least_bytes(m: dict, batch: int, prompt: int, gen: int,
                     chunk_bytes: int) -> int:
    """Least device bytes of the undo to the prefix: the chunks the cell
    dirtied in the prefix's leaves, read once and written once (the new
    ``generated`` leaf is dropped, not restored)."""
    seq = prompt + gen
    dirty = 0
    for leaf in cache_leaves(m, batch, seq):
        c = dirty_chunks(leaf, prompt, gen, chunk_bytes)
        dirty += min(c * chunk_bytes, leaf_bytes(leaf))
    return 2 * dirty


def least_seconds(nbytes: float = 0.0, flops: float = 0.0,
                  flops_peak: float = PEAK_BF16_FLOPS) -> float:
    """The roofline's least time: the larger of bytes over the HBM peak and
    operations over the compute peak."""
    return max(nbytes / PEAK_HBM_BYTES_PER_S, flops / flops_peak)
