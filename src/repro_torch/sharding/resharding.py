"""Elastic restore: checkpoints are mesh-independent (the port of the JAX
package's ``sharding/resharding.py``).

Chunk manifests describe *global* tensors (co-variable base buffers, in
C order), so a state written under one layout — one card, a 2x2 mesh, a
16x16 one — restores onto any other by (a) selecting only the chunks that
overlap the byte ranges a rank is responsible for and (b) building its
local shard, which ``DTensor.from_local`` places on the new mesh.  A
DTensor co-variable commits its global bytes, so its chunk keys, hashes
and manifest are those of the same values committed as one plain tensor,
by either package.

Exact ranges exist where a rank's shard is one contiguous run of the
global image: ``Shard(0)`` and ``Replicate()`` placements, or any
placement over mesh dims of size 1.  Any other layout falls back to the
full range, as in the JAX package, and the rank slices its shard from the
full image.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Placement, Replicate
from torch.distributed.tensor._utils import \
    _compute_local_shape_and_global_offset

from repro_torch.core.chunkstore import ChunkStore
from repro_torch.core.serialize import (ChunkMissingError, leaf_from_bytes,
                                        tensor_from_bytes, torch_dtype)
from repro_torch.launch.mesh import mesh_coordinates

Range = Tuple[int, int]


def chunks_for_range(manifest: dict, lo: int, hi: int) -> List[int]:
    """Indices of chunks overlapping global byte range [lo, hi)."""
    out = []
    off = 0
    for i, c in enumerate(manifest["base"]["chunks"]):
        if off < hi and off + c["n"] > lo:
            out.append(i)
        off += c["n"]
    return out


def load_byte_range(store: ChunkStore, manifest: dict, lo: int, hi: int,
                    stats=None) -> bytes:
    """Assemble exactly [lo, hi) of the base buffer, reading only the
    overlapping chunks, planned first and fetched with the backend's
    batched get (a rank's shard streams at store bandwidth)."""
    wanted = []                      # (key, slice lo, slice hi) per chunk
    off = 0
    for c in manifest["base"]["chunks"]:
        if off < hi and off + c["n"] > lo:
            wanted.append((c["key"], max(lo - off, 0), min(hi - off, c["n"])))
        off += c["n"]
        if off >= hi:
            break
    got = store.get_chunks([k for k, _, _ in wanted])
    missing = [k for k, _, _ in wanted if k not in got]
    if missing:
        raise ChunkMissingError(f"chunk {missing[0]} missing")
    if stats is not None:
        stats.bytes_loaded += sum(len(got[k]) for k in {w[0] for w in wanted})
    return b"".join(got[k][a:b] for k, a, b in wanted)


def _mesh_shape(mesh) -> Tuple[int, ...]:
    return tuple(mesh.shape) if hasattr(mesh, "mesh_dim_names") \
        else tuple(mesh)


def local_box(shape: Sequence[int], mesh_shape: Sequence[int],
               coord: Sequence[int], placements: Sequence[Placement]
               ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(local shape, global offset) of the shard at ``coord``, by
    DTensor's own helper."""
    return _compute_local_shape_and_global_offset(
        tuple(shape), tuple(mesh_shape), list(coord), list(placements))


def _box_range(shape: Sequence[int], item: int, local: Sequence[int],
               offset: Sequence[int]) -> Optional[Range]:
    """The byte range of a C-order box, or ``None`` when the box is not
    one contiguous run: leading dims of extent 1, then one partial dim,
    then whole dims."""
    shape, local = tuple(shape), tuple(local)
    k = next((i for i, (l, n) in enumerate(zip(local, shape)) if l != n),
             None)
    if k is not None and (any(l != 1 for l in local[:k])
                          or local[k + 1:] != shape[k + 1:]):
        return None
    stride = [item] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    lo = sum(o * st for o, st in zip(offset, stride))
    return lo, lo + int(np.prod(local, dtype=np.int64)) * item


def host_shard_ranges(shape: Sequence[int], dtype, mesh,
                      placements: Sequence[Placement]
                      ) -> Dict[int, List[Range]]:
    """Per-rank contiguous byte ranges of a C-order tensor under
    ``placements`` on ``mesh`` (a ``DeviceMesh``, or a mesh shape for a
    layout no process group spans — ranks in row-major order), each rank's
    box by DTensor's own local-shape and offset helper.  Exact where the
    box is one contiguous run (``Shard(0)``/``Replicate()``, or a mesh dim
    of size 1); otherwise the rank gets the full range."""
    item = torch.empty((), dtype=torch_dtype(dtype)
                       if isinstance(dtype, str) else dtype).element_size()
    shape = tuple(int(s) for s in shape)
    total = int(np.prod(shape, dtype=np.int64)) * item
    mshape = _mesh_shape(mesh)
    ranks = (mesh.mesh.reshape(-1).tolist()
             if hasattr(mesh, "mesh_dim_names") else
             list(range(int(np.prod(mshape, dtype=np.int64)))))
    out: Dict[int, List[Range]] = {}
    for rank, coord in zip(ranks, mesh_coordinates(mshape)):
        local, offset = local_box(shape, mshape, coord, placements)
        out[int(rank)] = [_box_range(shape, item, local, offset)
                          or (0, total)]
    return out


def local_byte_range(x: DTensor) -> Optional[Range]:
    """This rank's byte range of a DTensor's global image, or ``None``
    when its shard is not one contiguous run (then only the full image
    holds it)."""
    coord = x.device_mesh.get_coordinate()
    local, offset = local_box(x.shape, x.device_mesh.shape, coord,
                               x.placements)
    return _box_range(tuple(x.shape), x.element_size(), local, offset)


def restore_shard(store: ChunkStore, manifest: dict, mesh,
                  placements: Sequence[Placement], device=None,
                  stats=None) -> DTensor:
    """This rank's shard of a committed tensor, read from only the chunks
    it needs and placed on ``mesh`` with ``placements``
    (``DTensor.from_local``, no communication)."""
    meta = manifest["base"]["meta"]
    shape, dtype = tuple(meta["shape"]), meta["dtype"]
    coord = mesh.get_coordinate()
    local, offset = local_box(shape, mesh.shape, coord, placements)
    item = torch.empty((), dtype=torch_dtype(dtype)).element_size()
    if device is None:
        device = torch.device(mesh.device_type)
    rng = _box_range(shape, item, local, offset)
    if rng is not None:
        t = tensor_from_bytes(load_byte_range(store, manifest, *rng, stats),
                              dtype, local, device)
    else:
        full = tensor_from_bytes(
            load_byte_range(store, manifest, 0, manifest["base"]["nbytes"],
                            stats), dtype, shape, device)
        idx = tuple(slice(o, o + n) for o, n in zip(offset, local))
        t = full[idx].contiguous()
    if stats is not None:
        stats.bytes_logical += t.numel() * item
    return DTensor.from_local(t, mesh, list(placements), run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def elastic_restore_leaf(store: ChunkStore, manifest: dict, mesh=None,
                         placements: Optional[Sequence[Placement]] = None,
                         device=None) -> Any:
    """Restore a manifest's base leaf.  With ``mesh`` and ``placements``
    the result is this rank's DTensor, read shard-locally
    (:func:`restore_shard`); without, the whole leaf (a tensor on
    ``device``, or numpy with ``device=None``)."""
    if mesh is not None:
        return restore_shard(store, manifest, mesh,
                             placements or [Replicate()] * mesh.ndim, device)
    base = manifest["base"]
    blob = load_byte_range(store, manifest, 0, base["nbytes"])
    return leaf_from_bytes(blob, base["meta"], device=device)
