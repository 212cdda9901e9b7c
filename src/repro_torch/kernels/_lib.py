"""Build, bind and count the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds.  All sources build at first use,
one ``nvcc`` each, started together, into a content-addressed directory
(``build/kernels`` at the repository root, or ``$KISHU_KERNEL_BUILD_DIR``)
that ``.gitignore`` lists.  ``nvcc``'s ``-Xptxas -v`` report of registers
and spills is kept beside each library as ``<lib>.log``.

Wrappers pass ``data_ptr()`` pointers and PyTorch's current stream; every
C entry point returns ``cudaGetLastError()`` and :func:`call` raises when it
is not 0.  :func:`note_launch` is the one place a wrapper's launch count
moves: once per wrapper call that launched its kernel (and, for a kernel
with several routes, the count of the route it took).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
KERNELS = ("chunk_hash", "delta_pack", "delta_codec", "patch_scatter",
           "block_diff", "flash_attention", "chunk_key")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _LL, _I, _F = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
# entry point -> (library, argtypes); every entry returns a cudaError_t
_SIGNATURES: Dict[str, Tuple[str, List]] = {
    "kishu_chunk_hash": ("chunk_hash", [_P, _LL, _LL, _I, _P, _P]),
    "kishu_delta_pack_scan": ("delta_pack",
                              [_P, _LL, _LL, _I, _P, _P, _P, _P, _P, _P]),
    "kishu_delta_pack_gather": ("delta_pack", [_P, _LL, _LL, _I, _P, _P, _P]),
    # rows, n_groups, gw, masks, count, planes, status, status_words
    "kishu_codec_encode": ("delta_codec",
                           [_P, _LL, _I, _P, _P, _P, _P, _LL, _P]),
    "kishu_patch_scatter": ("patch_scatter",
                            [_P, _LL, _LL, _I, _P, _LL, _P, _P]),
    "kishu_block_diff": ("block_diff", [_P, _P, _LL, _LL, _I, _P, _P]),
    # data, nbytes, chunk_bytes, idx, n_idx, out
    "kishu_chunk_key": ("chunk_key", [_P, _LL, _LL, _P, _LL, _P, _P]),
    # q, k, v, o; B, S, Hq, Hkv, hd, dtype, causal; scale; 4 x 4 strides
    "kishu_flash_attention": ("flash_attention",
                              [_P] * 4 + [_I] * 7 + [_F] + [_LL] * 16
                              + [_P]),
    # q, k, v, o; B, S, Hq, Hkv, hd, causal; scale; 4 x (b, s, h) strides
    "kishu_flash_attention_tc": ("flash_attention",
                                 [_P] * 4 + [_I] * 6 + [_F] + [_LL] * 12
                                 + [_P]),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_launches: Dict[str, int] = {name: 0 for name in KERNELS}
# kernel -> route -> launches, for kernels with more than one route
_routes: Dict[str, Dict[str, int]] = {"flash_attention": {"tc": 0,
                                                          "fma": 0}}


def build_dir() -> Path:
    env = os.environ.get("KISHU_KERNEL_BUILD_DIR", "").strip()
    return Path(env) if env else CSRC.parents[2] / "build" / "kernels"


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (sm_90a) on PATH or in /usr/local/cuda")
    return nvcc


def _digest(name: str) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Dict[str, Path]:
    """Compile every kernel library not yet built (all ``nvcc`` processes
    start together); returns name -> library path.  Raises with the
    compiler's output when a build fails."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {n: out_dir / f"lib{n}-{_digest(n)}.so" for n in KERNELS}
    todo = [n for n, p in paths.items() if not p.exists()]
    if not todo:
        return paths
    nvcc = find_nvcc()
    procs = []
    for name in todo:
        tmp = paths[name].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, f"-I{CSRC}", "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        paths[name].with_suffix(".log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def _lib(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            for n, path in build_all().items():
                if n not in _libs:
                    cdll = ctypes.CDLL(str(path))
                    cdll.kishu_error_string.argtypes = [_I]
                    cdll.kishu_error_string.restype = ctypes.c_char_p
                    for fn, (owner, argtypes) in _SIGNATURES.items():
                        if owner == n:
                            f = getattr(cdll, fn)
                            f.argtypes = argtypes
                            f.restype = _I
                    _libs[n] = cdll
            lib = _libs[name]
    return lib


def load_all() -> None:
    """Build and load every kernel library now (set-up, not a launch)."""
    for name in KERNELS:
        _lib(name)


def call(fn: str, *args) -> None:
    """Call one C entry point; raise when it reports a CUDA error."""
    lib = _lib(_SIGNATURES[fn][0])
    err = getattr(lib, fn)(*args)
    if err != 0:
        msg = lib.kishu_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{fn}: CUDA error {err} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s card, as a pointer-sized int."""
    return torch.cuda.current_stream(t.device).cuda_stream


def splits_for(n_rows: int, row_bytes: int) -> int:
    """Blocks per chunk row: enough blocks to fill the card's 132 SMs eight
    times over, each with at least 32 KiB of the row."""
    by_fill = -(-(132 * 8) // max(1, n_rows))
    by_size = max(1, row_bytes // 32768)
    return max(1, min(by_fill, by_size))


def note_launch(name: str, route: str = "") -> None:
    """Count one launch of kernel ``name`` (and of its ``route``, for a
    kernel with several)."""
    with _lock:
        _launches[name] += 1
        if route:
            _routes[name][route] += 1


def launches() -> Dict[str, int]:
    with _lock:
        return dict(_launches)


def route_launches() -> Dict[str, Dict[str, int]]:
    """Launches per route of each kernel that has several routes."""
    with _lock:
        return {name: dict(r) for name, r in _routes.items()}


def reset_launches() -> None:
    with _lock:
        for name in _launches:
            _launches[name] = 0
        for r in _routes.values():
            for route in r:
                r[route] = 0
