"""Mamba-2 layer via SSD (state-space duality), chunked algorithm: the port
of the JAX package's ``models/mamba.py``.

Reference: "Transformers are SSMs" (arXiv:2405.21060).  The sequence is cut
into chunks of length L; within a chunk the output is an attention-like
masked-decay product, and a loop over chunks carries the [B,H,P,N]
recurrent state — O(S) work, O(1) decode state.

Shapes: x_head [B,S,H,P], dt [B,S,H], A [H] (negative), B/C broadcast from
[B,S,G,N] groups to heads.  State: [B,H,P,N], float32.

The leaves, shapes, dtypes and casts are the JAX package's (every product
accumulates in float32 and is cast where the JAX package casts).  The two
three-operand einsums of :func:`ssd_chunked` (``s_local``, ``y_inter``)
act on activations only, not on weights, and keep
:func:`layers.einsum_f32`'s upcast path.  Two departures:

- :func:`ssd_chunked` masks the intra-chunk decay *before* its ``exp``
  (``exp(where(mask, diff, -inf))``).  The JAX package takes ``exp`` of
  the whole ``diff`` and masks after; the upper triangle is positive and
  overflows to ``inf`` once a chunk's cumulative decay passes about 88,
  and the masked zero times ``inf`` makes its gradient non-finite.  The
  forward values are the same (``exp(-inf) = 0``).
- :func:`ssm_decode` writes the caches in place (``copy_`` into the
  stacked ``[n_units, ...]`` views), as ``layers.gqa_decode`` does for
  K/V, with no host sync, so a CUDA graph can capture the step.

SSD and the convolution are plain torch: the JAX package computes them
outside any Pallas kernel, so no hand-written kernel stands behind them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models import layers
from repro_torch.models.config import ArchConfig, SSMConfig
from repro_torch.models.layers import Shape, einsum_f32


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def _dims(cfg: ArchConfig):
    s: SSMConfig = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    conv_ch = d_in + 2 * s.n_groups * s.d_state
    return s, d_in, n_heads, conv_ch


def ssm_init(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype,
             lead: Shape = ()) -> dict:
    """The JAX package's leaves and distributions (``lead`` prepends the
    stacked-unit axis): f32 ``dt_bias`` (0), ``A_log`` (0) and ``D`` (1)."""
    s, d_in, n_heads, conv_ch = _dims(cfg)
    d = cfg.d_model
    dev = gen.device
    proj_out = 2 * d_in + 2 * s.n_groups * s.d_state + n_heads
    conv_w = torch.empty((*lead, s.conv_width, conv_ch), dtype=torch.float32,
                         device=dev).normal_(generator=gen) * 0.1
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "in_proj": layers.dense_param(gen, d, proj_out, dtype, lead),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((*lead, conv_ch), dtype=dtype, device=dev),
        "dt_bias": torch.zeros((*lead, n_heads), **f32),
        "A_log": torch.zeros((*lead, n_heads), **f32),
        "D": torch.ones((*lead, n_heads), **f32),
        "norm": layers.rmsnorm_init(d_in, dtype, dev, lead),
        "out_proj": layers.dense_param(gen, d_in, d, dtype, lead),
    }


# ---------------------------------------------------------------------------
# projections + causal depthwise conv
# ---------------------------------------------------------------------------

def _split_proj(p: dict, cfg: ArchConfig, x: torch.Tensor):
    s, d_in, n_heads, _ = _dims(cfg)
    gn = s.n_groups * s.d_state
    proj = einsum_f32("bsd,dk->bsk", x, p["in_proj"]).to(x.dtype)
    return torch.split(proj, [d_in, d_in, gn, gn, n_heads], dim=-1)


def causal_conv(conv_w: torch.Tensor, conv_b: torch.Tensor,
                u: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d. u: [B,S,C]; conv_w: [W,C]."""
    w, seq = conv_w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, w - 1, 0))
    out = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    for i in range(w):
        out = out + pad[:, i:i + seq, :].float() * conv_w[i].float()
    return F.silu(out + conv_b.float()).to(u.dtype)


def _groups_to_heads(t: torch.Tensor, n_heads: int, n_groups: int
                     ) -> torch.Tensor:
    """[B,S,G*N] -> [B,S,H,N]."""
    b, s_, gn = t.shape
    n = gn // n_groups
    rep = n_heads // n_groups
    return t.reshape(b, s_, n_groups, 1, n) \
        .expand(b, s_, n_groups, rep, n).reshape(b, s_, n_heads, n)


# ---------------------------------------------------------------------------
# chunked SSD core
# ---------------------------------------------------------------------------

def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b_ssm: torch.Tensor, c_ssm: torch.Tensor,
                d_skip: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD over a full sequence.

    x: [B,S,H,P]; dt: [B,S,H] (post-softplus, >0); a: [H] (negative);
    b_ssm/c_ssm: [B,S,H,N]; d_skip: [H].  Returns (y [B,S,H,P] in x's
    dtype, state [B,H,P,N] float32).  The [B,C,L,L,H] temporaries live
    only inside the call."""
    bsz, seq, nh, hp = x.shape
    nstate = b_ssm.shape[-1]
    if seq % chunk:
        raise ValueError(f"sequence {seq} is not a multiple of chunk {chunk}")
    nc = seq // chunk

    # per-step log decay, f32 throughout the decay path
    la = dt.float() * a.float()                                  # [B,S,H]
    xc = x.reshape(bsz, nc, chunk, nh, hp)
    dtc = dt.reshape(bsz, nc, chunk, nh).float()
    lac = la.reshape(bsz, nc, chunk, nh)
    bc = b_ssm.reshape(bsz, nc, chunk, nh, nstate)
    cc = c_ssm.reshape(bsz, nc, chunk, nh, nstate)

    cum = torch.cumsum(lac, dim=2)                               # [B,C,L,H]
    total = cum[:, :, -1, :]                                     # [B,C,H]

    # ---- intra-chunk (attention-like) ----
    # M[i,j] = exp(cum_i - cum_j) for j <= i, masked before the exp
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]         # [B,C,L,L,H]
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=x.device).tril()
    m = torch.exp(torch.where(mask[None, None, :, :, None], diff,
                              float("-inf")))
    del diff
    cb = einsum_f32("bcihn,bcjhn->bchij", cc, bc)
    # scores[b,c,h,i,j] = (C_i . B_j) * M[i,j] * dt_j
    dt_j = dtc.permute(0, 1, 3, 2)[:, :, :, None, :]            # [B,C,H,1,L]
    scores = cb * m.movedim(-1, 2) * dt_j
    del m, cb
    y_intra = einsum_f32("bchij,bcjhp->bcihp", scores.to(x.dtype), xc)
    del scores

    # ---- per-chunk local end-state ----
    # S_local[c] = sum_j exp(total_c - cum_j) * dt_j * B_j (x) x_j
    w_end = torch.exp(total[:, :, None, :] - cum) * dtc          # [B,C,L,H]
    s_local = einsum_f32("bclh,bclhn,bclhp->bchpn", w_end.to(x.dtype), bc,
                         xc)                                     # [B,C,H,P,N]

    # ---- inter-chunk scan ----
    s = torch.zeros((bsz, nh, hp, nstate), dtype=torch.float32,
                    device=x.device) if initial_state is None \
        else initial_state.float()
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)
        s = s * torch.exp(total[:, c])[:, :, None, None] + s_local[:, c]
    s_prev = torch.stack(s_prevs, dim=1)                         # [B,C,H,P,N]

    # Y_inter[i] = exp(cum_i) * C_i . S_prev
    y_inter = einsum_f32("bclh,bclhn,bchpn->bclhp",
                         torch.exp(cum).to(x.dtype), cc, s_prev.to(x.dtype))

    y = (y_intra + y_inter).reshape(bsz, seq, nh, hp)
    y = y + x.float() * d_skip.float()[None, None, :, None]
    return y.to(x.dtype), s


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    a: torch.Tensor, b_ssm: torch.Tensor,
                    c_ssm: torch.Tensor, d_skip: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent step. state [B,H,P,N]; x [B,H,P]; dt [B,H];
    b/c [B,H,N].  Returns (y [B,H,P], new state); ``state`` is not
    written."""
    dt32 = dt.float()
    decay = torch.exp(dt32 * a.float())                          # [B,H]
    inp = (dt32[:, :, None, None] * x.float()[:, :, :, None]
           * b_ssm.float()[:, :, None, :])
    new_state = state * decay[:, :, None, None] + inp
    y = torch.einsum("bhpn,bhn->bhp", new_state, c_ssm.float())
    y = y + x.float() * d_skip.float()[None, :, None]
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# full layer forward / decode
# ---------------------------------------------------------------------------

def _gate_out(p: dict, cfg: ArchConfig, y: torch.Tensor, z: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """RMSNorm of y gated by silu(z), then the output projection."""
    y = layers.rmsnorm(p["norm"], y * F.silu(z.float()).to(y.dtype),
                       cfg.norm_eps)
    return einsum_f32("bsk,kd->bsd", y, p["out_proj"]).to(x.dtype)


def ssm_forward(p: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence Mamba-2 block. x: [B,S,d] -> [B,S,d]."""
    s, d_in, n_heads, _ = _dims(cfg)
    bsz, seq, _ = x.shape
    z, xin, b_raw, c_raw, dt_raw = _split_proj(p, cfg, x)
    conv_out = causal_conv(p["conv_w"], p["conv_b"],
                           torch.cat([xin, b_raw, c_raw], dim=-1))
    gn = s.n_groups * s.d_state
    xin, b_raw, c_raw = torch.split(conv_out, [d_in, gn, gn], dim=-1)

    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float())
    xh = xin.reshape(bsz, seq, n_heads, s.head_dim)
    bh = _groups_to_heads(b_raw, n_heads, s.n_groups)
    ch = _groups_to_heads(c_raw, n_heads, s.n_groups)

    if isinstance(xh, DTensor):
        y = _sharded_ssd(xh, dt, a, bh, ch, p["D"], s.chunk_size)
    else:
        y, _ = ssd_chunked(xh, dt, a, bh, ch, p["D"], s.chunk_size)
    return _gate_out(p, cfg, y.reshape(bsz, seq, d_in), z, x)


def _sharded_ssd(x: DTensor, dt, a, b_ssm, c_ssm, d_skip, chunk: int
                 ) -> DTensor:
    """:func:`ssd_chunked`'s ``y`` for DTensor inputs, each rank scanning
    its own batch rows and heads: the recurrence runs along the sequence
    and is independent across rows and heads, so x [B,S,H,P], dt
    [B,S,H], B and C [B,S,H,N] keep the mesh dims that shard their batch
    and take the heads on every other mesh dim where they divide (the
    sequence is never split), ``a`` and ``d_skip`` [H] their heads, and
    :func:`ssd_chunked` runs on the local shards.  ``y`` comes back on
    that layout; the gradients of ``a`` and ``d_skip`` are partial over
    the batch's mesh dims."""
    mesh = x.device_mesh
    pl, head, ways = [], [], 1
    for i, q in enumerate(x.placements):
        n = mesh.size(i)
        if isinstance(q, Shard) and q.dim == 0:
            pl.append(q)
            head.append(Partial())
        elif x.shape[2] % (ways * n) == 0:
            ways *= n
            pl.append(Shard(2))
            head.append(Shard(0))
        else:
            pl.append(Replicate())
            head.append(Replicate())
    x_l, dt_l, b_l, c_l = (layers._as_dtensor(t, mesh).redistribute(mesh, pl)
                           .to_local() for t in (x, dt, b_ssm, c_ssm))
    a_l, d_l = (layers._as_dtensor(t, mesh).redistribute(mesh, [
        q if isinstance(q, Shard) else Replicate() for q in head])
        .to_local(grad_placements=head) for t in (a, d_skip))
    y, _ = ssd_chunked(x_l, dt_l, a_l, b_l, c_l, d_l, chunk)
    return DTensor.from_local(y, mesh, pl, run_check=False)


def ssm_cache_init(cfg: ArchConfig, batch: int, dtype: torch.dtype, device,
                   lead: Shape = ()) -> dict:
    """Zeroed SSM cache: ``conv`` [*lead, B, W-1, C] in the model dtype,
    ``state`` [*lead, B, H, P, N] float32 (the JAX package's leaves)."""
    s, d_in, n_heads, conv_ch = _dims(cfg)
    return {
        "conv": torch.zeros((*lead, batch, s.conv_width - 1, conv_ch),
                            dtype=dtype, device=device),
        "state": torch.zeros((*lead, batch, n_heads, s.head_dim, s.d_state),
                             dtype=torch.float32, device=device),
    }


def _decode_inputs(cfg: ArchConfig, conv_w, conv_b, dt_bias, a_log,
                   conv: torch.Tensor, xin, b_raw, c_raw, dt_raw):
    """One decode step's conv and SSD inputs from the projections (each
    [B,1,...]) and the conv cache [B,W-1,C]: (the new window [B,W,C],
    x [B,H,P], dt [B,H], A [H], B and C [B,H,N])."""
    s, d_in, n_heads, _ = _dims(cfg)
    bsz = xin.shape[0]
    conv_in = torch.cat([xin, b_raw, c_raw], dim=-1)             # [B,1,C]
    window = torch.cat([conv, conv_in], dim=1)                   # [B,W,C]
    conv_out = (torch.einsum("bwc,wc->bc", window.float(), conv_w.float())
                + conv_b.float())
    conv_out = F.silu(conv_out).to(xin.dtype)[:, None, :]        # [B,1,C]
    gn = s.n_groups * s.d_state
    xin, b_raw, c_raw = torch.split(conv_out, [d_in, gn, gn], dim=-1)

    dt = F.softplus(dt_raw[:, 0].float() + dt_bias.float())     # [B,H]
    a = -torch.exp(a_log.float())
    xh = xin[:, 0].reshape(bsz, n_heads, s.head_dim)
    bh = _groups_to_heads(b_raw, n_heads, s.n_groups)[:, 0]
    ch = _groups_to_heads(c_raw, n_heads, s.n_groups)[:, 0]
    return window, xh, dt, a, bh, ch


def ssm_decode(p: dict, cfg: ArchConfig, x: torch.Tensor, cache: dict
               ) -> Tuple[torch.Tensor, dict]:
    """One-token decode. x: [B,1,d]. cache: {"conv": [B,W-1,C], "state":
    [B,H,P,N]}, both written in place (``copy_``: the same tensors, so a
    Kishu session and a captured CUDA graph see the write).  DTensor
    caches take :func:`_sharded_ssm_decode`.  Returns (y [B,1,d],
    cache)."""
    if isinstance(cache["state"], DTensor):
        return _sharded_ssm_decode(p, cfg, x, cache)
    s, d_in, n_heads, _ = _dims(cfg)
    z, xin, b_raw, c_raw, dt_raw = _split_proj(p, cfg, x)
    window, xh, dt, a, bh, ch = _decode_inputs(
        cfg, p["conv_w"], p["conv_b"], p["dt_bias"], p["A_log"],
        cache["conv"], xin, b_raw, c_raw, dt_raw)
    y, new_state = ssd_decode_step(cache["state"], xh, dt, a, bh, ch,
                                   p["D"])
    out = _gate_out(p, cfg, y.reshape(x.shape[0], 1, d_in), z, x)
    cache["conv"].copy_(window[:, 1:])
    cache["state"].copy_(new_state)
    return out, cache


def _sharded_ssm_decode(p: dict, cfg: ArchConfig, x: torch.Tensor,
                        cache: dict) -> Tuple[torch.Tensor, dict]:
    """:func:`ssm_decode` on DTensor caches under
    ``ShardingRules.cache_spec``: ``state`` [B,H,P,N] sharded on the
    batch and the heads, ``conv`` [B,W-1,C] on the batch (and on W-1
    where ``model`` divides it).  Each rank takes its batch rows of the
    projections with every channel (the conv weight gathered whole),
    updates the whole conv window alike on every rank of a batch shard,
    and runs :func:`ssd_decode_step` on its own heads; both caches are
    written in place on the local shards (``copy_``).  ``y`` goes on as a
    DTensor sharded like the state."""
    s, d_in, n_heads, _ = _dims(cfg)
    state, conv = cache["state"], cache["conv"]
    mesh = state.device_mesh
    sh = layers.seq_shard(conv)
    z, *proj = _split_proj(p, cfg, x)
    window, xh, dt, a, bh, ch = _decode_inputs(
        cfg, *(layers.whole(p[k]) for k in ("conv_w", "conv_b", "dt_bias",
                                             "A_log")),
        *(layers.local_rows(t, sh) for t in [conv] + proj))
    sloc, soff = layers.shard_box(state)
    h = slice(soff[1], soff[1] + sloc[1])                        # my heads
    y, new_state = ssd_decode_step(state.to_local(), xh[:, h], dt[:, h],
                                   a[h], bh[:, h], ch[:, h],
                                   layers.whole(p["D"])[h])
    state.to_local().copy_(new_state)
    conv.to_local().copy_(window[:, 1 + sh.lo:1 + sh.lo + sh.n])
    # this rank's rows and heads [b, h, P] flatten to its rows and a
    # contiguous block of the d_in channels [b, h*P]: the local shard of
    # y [B, d_in] on the state's placements (the state is sharded on the
    # batch and the heads only), so no DTensor is reshaped
    b = state.shape[0]
    y = DTensor.from_local(y.reshape(y.shape[0], -1).contiguous(), mesh,
                           list(state.placements), run_check=False,
                           shape=(b, d_in), stride=(d_in, 1)).unsqueeze(1)
    return _gate_out(p, cfg, y, z, x), cache


def ssd_reference(x, dt, a, b_ssm, c_ssm, d_skip):
    """Plain O(S) sequential oracle for tests: :func:`ssd_chunked`'s
    signature without chunking.  Returns (y, final_state)."""
    bsz, seq, nh, hp = x.shape
    n = b_ssm.shape[-1]
    state = torch.zeros((bsz, nh, hp, n), dtype=torch.float32,
                        device=x.device)
    ys = []
    for t in range(seq):
        y, state = ssd_decode_step(state, x[:, t], dt[:, t], a,
                                   b_ssm[:, t], c_ssm[:, t], d_skip)
        ys.append(y)
    return torch.stack(ys, dim=1), state
