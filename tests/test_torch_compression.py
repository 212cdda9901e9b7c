"""The port's int8 error-feedback gradient compression on 8 gloo ranks
(``tests/test_distribution.py::test_compressed_psum_numerics``'s case):
each rank holds its own gradients, the compressed mean is within 0.02 of
the true mean relative to its largest entry, the int32 sums equal numpy's
sums of the ranks' int8 values exactly, and the error-feedback residual
is each rank's quantization error."""
import numpy as np
import torch

from repro_torch.launch.mesh import run_local_ranks

WORLD = 8
RANK_TIMEOUT = 90.0


def _grads(i):
    return {"w": torch.full((64,), float(i + 1)),
            "b": torch.linspace(-1, 1, 32) * (i + 1)}


def _rank(rank, world):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.optim.compression import (compressed_psum,
                                               quantized_psum, residual_init)
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    g = _grads(rank)
    mean, new_r = compressed_psum(g, residual_init(g), mesh, "data")
    sums = {k: quantized_psum(g[k].float(), mesh.get_group("data"))
            for k in g}
    return ({k: v.numpy() for k, v in mean.items()},
            {k: v.numpy() for k, v in new_r.items()},
            {k: (s.numpy(), float(sc), q.numpy())
             for k, (s, sc, q) in sums.items()})


def test_compressed_psum_numerics():
    out = run_local_ranks(_rank, WORLD, timeout=RANK_TIMEOUT)
    want = {k: np.mean([_grads(i)[k].numpy() for i in range(WORLD)], axis=0)
            for k in ("w", "b")}
    for rank, (mean, resid, sums) in enumerate(out):
        for k in ("w", "b"):
            scale = np.abs(want[k]).max() + 1e-9
            err = np.abs(mean[k] - want[k]).max() / scale
            assert err < 0.02, (rank, k, err)
            s, sc, q = sums[k]
            assert q.dtype == np.int8 and s.dtype == np.int32
            qs = np.stack([out[r][2][k][2] for r in range(WORLD)])
            assert np.array_equal(s, qs.astype(np.int32).sum(0))
            amax = max(np.abs(_grads(r)[k].numpy()).max()
                       for r in range(WORLD))
            assert np.isclose(sc, np.float32(amax) / np.float32(127.0))
            g = _grads(rank)[k].numpy()
            np.testing.assert_allclose(resid[k], g - q.astype(np.float32)
                                       * np.float32(sc), atol=1e-6)
        assert all(np.array_equal(mean[k], out[0][0][k]) for k in mean)
