"""The port stands alone: no module of ``repro_torch`` imports jax or
anything of ``repro``; importing it pulls neither into the process; the
kernel modules import (and build nothing) without nvcc; and a wrapper given
a tensor it has no kernel for raises instead of falling back."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import torch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"


def _bad_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            if n == "jax" or n.startswith("jax.") or n == "repro" \
                    or n.startswith("repro."):
                bad.append((path.name, node.lineno, n))
    return bad


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [SMOKE],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    assert _bad_imports(path) == []


def test_import_pulls_in_neither_jax_nor_repro():
    code = ("import sys, repro_torch.core, repro_torch.interop\n"
            "import repro_torch.kernels.chunk_hash.ops\n"
            "import repro_torch.kernels.delta_pack.ops\n"
            "import repro_torch.kernels.delta_codec.ops\n"
            "import repro_torch.kernels.patch_scatter.ops\n"
            "bad = [m for m in sys.modules if m == 'jax' or m == 'repro'\n"
            "       or m.startswith(('jax.', 'repro.'))]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(ROOT), timeout=120)


def test_kernel_modules_build_nothing_at_import(tmp_path, monkeypatch):
    monkeypatch.setenv("KISHU_KERNEL_BUILD_DIR", str(tmp_path / "kbuild"))
    from repro_torch.kernels import _lib
    assert set(_lib.KERNELS) == {"chunk_hash", "delta_pack", "delta_codec",
                                 "patch_scatter"}
    for name in _lib.KERNELS:
        assert (_lib.CSRC / f"{name}.cu").is_file()
    assert not (tmp_path / "kbuild").exists()
    assert set(_lib.launches()) == set(_lib.KERNELS)


def test_missing_nvcc_raises(monkeypatch):
    from repro_torch.kernels import _lib
    monkeypatch.setenv("PATH", "")
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _lib.find_nvcc()


def test_wrappers_raise_on_devices_without_a_kernel():
    """Neither a kernel nor a silent plain-version run for a device the
    port has no kernel for (``meta`` stands in for one)."""
    from repro_torch.kernels.chunk_hash.ops import chunk_hash
    from repro_torch.kernels.delta_codec.ops import encode_rows
    from repro_torch.kernels.delta_pack.ops import delta_pack
    from repro_torch.kernels.patch_scatter.ops import scatter_chunks
    import numpy as np
    x = torch.zeros(4096, device="meta")
    with pytest.raises((ValueError, NotImplementedError, RuntimeError)):
        chunk_hash(x, 4096)
    with pytest.raises((ValueError, NotImplementedError, RuntimeError)):
        delta_pack(x, np.zeros(4, np.uint64), 4096)
    with pytest.raises((ValueError, NotImplementedError, RuntimeError)):
        encode_rows(torch.zeros((1, 1024), dtype=torch.int32, device="meta"))
    with pytest.raises((ValueError, NotImplementedError, RuntimeError)):
        scatter_chunks(x, [0], [bytes(4096)], 4096)
