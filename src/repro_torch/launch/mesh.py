"""Device meshes and process groups for the port (the JAX package's
``launch/mesh.py``), plus a launcher of local ranks.

A mesh is a named ``torch.distributed.device_mesh.DeviceMesh`` over the
default process group.  Nothing here touches a process group when the
module is imported: the callers initialise one first — NCCL on cards,
gloo for CPU ranks, or the ``fake`` backend, under which the 256- and
512-rank production meshes build in one process with no allocation and
no communication (the dry run, ``launch/dryrun.py``).
"""
from __future__ import annotations

import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

# Hardware constants for the roofline model: NVIDIA H100 SXM (H100 80GB
# HBM3) datasheet peaks at its 700 W power limit, the rates
# ``chip_smoke.py`` takes its bounds against.
PEAK_FLOPS_BF16 = 989e12            # FLOP/s, dense tensor-core bf16
PEAK_FLOPS_FP32 = 67e12             # FLOP/s, float32 outside tensor cores
HBM_BW = 3.35e12                    # bytes/s
INT32_OPS_PER_S = 132 * 64 * 1.98e9  # 132 SMs x 64 INT32 lanes x boost

PRODUCTION_SHAPES = {"single": ((16, 16), ("data", "model")),
                     "multi": ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16x16 = 256 ranks a pod; ``multi_pod`` adds a leading 2-pod axis
    (512).  The default process group must span that many ranks (the
    dry run uses the ``fake`` backend: :func:`init_fake_group`)."""
    shape, axes = PRODUCTION_SHAPES["multi" if multi_pod else "single"]
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_local_mesh(model: int = 1, data: int = 0,
                    device_type: Optional[str] = None) -> DeviceMesh:
    """A ``("data", "model")`` mesh over the default group's ranks (tests,
    the card's one-rank Phase 8).  ``device_type`` defaults to ``cuda``
    under NCCL and ``cpu`` otherwise."""
    n = dist.get_world_size()
    data = data or (n // model)
    if data * model != n:
        raise ValueError(f"mesh ({data}, {model}) does not cover {n} ranks")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))


def init_fake_group(world_size: int) -> None:
    """A ``fake`` default process group of ``world_size`` ranks in this
    process (rank 0): collectives return at once and move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def init_file_group(backend: str, rank: int, world_size: int,
                    path: str) -> None:
    """The default process group over a ``FileStore`` at ``path`` (no
    TCP rendezvous).  NCCL takes this rank's card."""
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, store=dist.FileStore(path, world_size),
                            rank=rank, world_size=world_size)


def _rank_main(fn, rank, world, path, backend, args, out) -> None:
    try:
        init_file_group(backend, rank, world, path)
        try:
            out.put((rank, "ok", fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:                  # reported to the parent, which
        out.put((rank, "error", traceback.format_exc()))  # raises it
        raise


def run_local_ranks(fn: Callable, world_size: int, *args: Any,
                    backend: str = "gloo", timeout: float = 120.0
                    ) -> List[Any]:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes joined by a ``backend`` group over a ``FileStore`` in a
    fresh temporary directory; returns each rank's result in rank order.
    ``fn`` and its results must pickle.  A rank that raises, or a run
    longer than ``timeout`` seconds, terminates every rank and raises
    ``RuntimeError`` with the first traceback."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="kishu-ranks-") as tmp:
        path = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world_size, path, backend, args,
                                   out), daemon=True)
                 for r in range(world_size)]
        for p in procs:
            p.start()
        results: dict = {}
        error = None
        try:
            deadline = time.monotonic() + timeout
            while len(results) < world_size and error is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    error = f"ranks timed out after {timeout} s " \
                            f"({sorted(results)} done)"
                    break
                try:
                    rank, status, value = out.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [p.exitcode for p in procs
                            if p.exitcode not in (None, 0)]
                    if dead and out.empty():
                        error = f"a rank exited with {dead[0]}"
                    continue
                if status == "ok":
                    results[rank] = value
                else:
                    error = f"rank {rank} failed:\n{value}"
        finally:
            for p in procs:
                p.join(timeout=5 if error is None else 0.1)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=5)
    if error is not None:
        raise RuntimeError(error)
    return [results[r] for r in range(world_size)]


def mesh_coordinates(mesh_shape: Sequence[int]) -> List[List[int]]:
    """Every coordinate of a mesh of this shape, in rank (row-major)
    order."""
    coords: List[List[int]] = [[]]
    for n in mesh_shape:
        coords = [c + [i] for c in coords for i in range(n)]
    return coords
