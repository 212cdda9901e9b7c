"""The port's ManagedTrainingSession: the JAX package's train-loop cases
(tied-embedding aliasing, undo, branch, hparam deltas, async checkpointing,
crash resume) on CPU tensors, then the two packages against each other —
the same attach commit from one carried-over state, and each resuming the
other's store bit for bit and training on — and the launcher's entry point.

Restored state is verified exactly with ``delta.exact_dirty_indices``
(the ``block_diff`` plain version on CPU tensors).  Continued losses agree
within rtol 1e-4 (float32, reduced configs: summation order differs).
"""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.models import get_config as jget  # noqa: E402
from repro.models.testing import reduced as jreduced  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamW  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro.train import step as jstep  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
from repro_torch.core.delta import exact_dirty_indices  # noqa: E402
from repro_torch.interop import train_state_to_torch  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models.config import get_config as tget  # noqa: E402
from repro_torch.models.testing import reduced as treduced  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.train.loop import ManagedTrainingSession, resume  # noqa: E402

EMBED, HEAD = "state/params/embed", "state/params/lm_head"
CB = 1 << 16


@pytest.fixture(scope="module")
def tied_cfg():
    return treduced(tget("qwen3-1.7b"), n_layers=2)


def make_sess(cfg, store=None, **kw):
    return ManagedTrainingSession(cfg, AdamWConfig(lr=1e-3),
                                  store or tcore.MemoryStore(),
                                  global_batch=2, seq_len=16, device="cpu",
                                  **kw)


def _snap(ns):
    return {n: (v.clone() if isinstance(v, torch.Tensor) else v)
            for n, v in ns.items()}


def _assert_exact(ns, snap):
    """Every tensor bit-identical to its snapshot (block_diff, exact)."""
    assert sorted(ns.names()) == sorted(snap)
    for n, want in snap.items():
        got = ns[n]
        if isinstance(want, torch.Tensor):
            assert got.dtype == want.dtype and got.shape == want.shape, n
            assert exact_dirty_indices(got, want, 4096) == [], n
        else:
            assert got == want, n


# ---------------------------------------------------------------------------
# the JAX package's train-loop cases, on the port
# ---------------------------------------------------------------------------

def test_tied_embedding_covariable(tied_cfg):
    s = make_sess(tied_cfg)
    s.attach(seed=0)
    key = tuple(sorted([EMBED, HEAD]))
    assert key in s.kishu.covs
    assert s.ns[EMBED] is s.ns[HEAD]


def test_undo_restores_exact_params_and_tie(tied_cfg):
    s = make_sess(tied_cfg)
    s.attach(seed=0)
    c1 = s.train(2)
    snap = _snap(s.ns)
    s.train(2)
    assert exact_dirty_indices(s.ns[EMBED], snap[EMBED], 4096) != []
    st = s.checkout(c1)
    _assert_exact(s.ns, snap)
    assert s.ns[EMBED] is s.ns[HEAD], "checkout broke weight tying"
    assert st.wall_s < 5.0


def test_hparam_delta_is_tiny(tied_cfg):
    s = make_sess(tied_cfg)
    s.attach(seed=0)
    s.train(1)
    snap = _snap(s.ns)
    s.set_lr(5e-4)
    assert s.kishu.last_run.covs_updated == 1
    assert s.kishu.last_run.write.bytes_written < 200
    snap["hparams/lr"] = 5e-4
    _assert_exact(s.ns, snap)


def test_branching_data_mixture(tied_cfg):
    s = make_sess(tied_cfg)
    s.attach(seed=0)
    c1 = s.train(1)
    s.swap_data(seed=100)
    s.train(1)
    la = s.ns[EMBED].clone()
    s.checkout(c1)
    s.swap_data(seed=200)
    s.train(1)
    assert not torch.equal(la, s.ns[EMBED])    # different mixtures diverge


def test_train_replay_determinism(tied_cfg):
    """The same phase from the same state gives bit-identical results —
    the foundation of fallback recomputation for training states."""
    s = make_sess(tied_cfg)
    s.attach(seed=0)
    c1 = s.train(2)
    w_first = s.ns[EMBED].clone()
    s.checkout(s.kishu.graph.nodes[c1].parent)
    s.train(2)
    assert torch.equal(s.ns[EMBED], w_first)


def test_chunk_loss_during_training_falls_back(tied_cfg):
    store = tcore.MemoryStore()
    s = make_sess(tied_cfg, store=store)
    s.attach(seed=0)
    c1 = s.train(1)
    w1 = s.ns[EMBED].clone()
    s.train(1)
    man = s.kishu.graph.manifest_of(tuple(sorted([EMBED, HEAD])), c1)
    for ch in man["base"]["chunks"]:
        store.delete_chunk(ch["key"])
    # drop the shared chunk cache too: it would (correctly) mask the
    # storage incident; this test targets the replay fallback
    s.kishu.chunk_cache.clear()
    s.kishu.chunk_cache.max_bytes = 0
    s.checkout(c1)
    assert torch.equal(s.ns[EMBED], w1)
    assert s.kishu.restorer.replays >= 1


def test_async_checkpointing(tied_cfg):
    s = make_sess(tied_cfg, async_write=True)
    s.attach(seed=0)
    c1 = s.train(1)
    s.train(1)
    s.checkout(c1)               # flushes the writer first
    assert s.ns is not None
    s.close()


def test_crash_resume(tied_cfg):
    store = tcore.MemoryStore()
    s = make_sess(tied_cfg, store=store)
    s.attach(seed=0)
    s.train(2)
    s.set_lr(7e-4)
    head = s.kishu.head
    snap = _snap(s.ns)
    s.close()
    del s
    s2 = resume(treduced(tget("qwen3-1.7b"), n_layers=2),
                AdamWConfig(lr=1e-3), store, global_batch=2, seq_len=16,
                device="cpu")
    assert s2.kishu.head == head
    _assert_exact(s2.ns, snap)
    assert s2.ns["hparams/lr"] == 7e-4
    assert s2.ns[EMBED] is s2.ns[HEAD]
    s2.train(1)                  # continues fine


def test_namespace_types(tied_cfg):
    """The leaf types the JAX package writes, so commit docs match."""
    s = make_sess(tied_cfg)
    s.attach(seed=0)
    s.train(1)
    s.evaluate(1)
    ns = s.ns
    assert type(ns["hparams/lr"]) is float
    assert type(ns["data/seed"]) is int and type(ns["data/step"]) is int
    assert type(ns["metrics/last_loss"]) is float
    assert type(ns["metrics/eval_loss"]) is float
    for name in ("state/step", "state/opt/count"):
        assert ns[name].dtype == torch.int32 and ns[name].dim() == 0
    assert ns["state/rng"].dtype == torch.uint32
    assert ns[EMBED].device.type == "cpu"


def test_defaults_to_cuda_and_raises_without_a_card(tied_cfg, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ManagedTrainingSession(tied_cfg, AdamWConfig(), tcore.MemoryStore())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resume(tied_cfg, AdamWConfig(), tcore.MemoryStore())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--reduced", "--steps", "1", "--phase-steps", "1"])


# ---------------------------------------------------------------------------
# the two packages against each other
# ---------------------------------------------------------------------------

def _cfgs(n_layers=2):
    return (jreduced(jget("smollm-360m"), n_layers=n_layers),
            treduced(tget("smollm-360m"), n_layers=n_layers))


def _jax_sess(cfg, store):
    return jloop.ManagedTrainingSession(cfg, JAdamW(lr=1e-3), store,
                                        global_batch=2, seq_len=16,
                                        chunk_bytes=CB)


def _torch_sess(cfg, store):
    return ManagedTrainingSession(cfg, AdamWConfig(lr=1e-3), store,
                                  global_batch=2, seq_len=16, chunk_bytes=CB,
                                  device="cpu")


def _carry_init(monkeypatch, jcfg):
    """The port's init returns the JAX package's init (seed 0), carried."""
    jstate = jstep.init_train_state(jcfg, jax.random.key(0), JAdamW(lr=1e-3))
    carried = jax.tree.map(np.asarray, jstate)
    monkeypatch.setattr(
        tstep, "init_train_state",
        lambda cfg, seed, opt_cfg, device=None:
        train_state_to_torch(carried, device))


def _commit_docs(store):
    out = {}
    for name in store.list_meta("commit/"):
        doc = dict(store.get_meta(name))
        doc.pop("timestamp", None)
        doc.pop("stats", None)
        out[name] = doc
    return out


def _ns_bytes(ns):
    out = {}
    for n in ns.names():
        v = ns[n]
        if isinstance(v, torch.Tensor):
            out[n] = v.reshape(-1).contiguous().view(torch.uint8).numpy() \
                .tobytes()
        elif hasattr(v, "dtype") and hasattr(v, "shape"):
            out[n] = np.ascontiguousarray(np.asarray(v)).tobytes()
        else:
            out[n] = v
    return out


def test_attach_commit_matches_jax(monkeypatch):
    jcfg, tcfg = _cfgs()
    _carry_init(monkeypatch, jcfg)
    js, ts = jcore.MemoryStore(), tcore.MemoryStore()
    jsess, tsess = _jax_sess(jcfg, js), _torch_sess(tcfg, ts)
    jc, tc = jsess.attach(seed=0), tsess.attach(seed=0)
    assert jc == tc
    assert js.chunks == ts.chunks                 # keys and stored bytes
    assert jsess.kishu.graph.nodes[jc].manifests \
        == tsess.kishu.graph.nodes[tc].manifests
    assert _commit_docs(js) == _commit_docs(ts)
    assert _ns_bytes(jsess.ns) == _ns_bytes(tsess.ns)
    # an LR-only commit writes no tensor chunk in either package: the one
    # new chunk is the pickled float of hparams/lr
    before = set(ts.chunks)
    jsess.set_lr(5e-4)
    c_lr = tsess.set_lr(5e-4)
    man = tsess.kishu.graph.manifest_of(("hparams/lr",), c_lr)
    assert set(ts.chunks) - before == {c["key"] for c in man["base"]["chunks"]}
    assert man["base"]["meta"]["kind"] == "object"
    assert tsess.kishu.last_run.covs_updated == 1
    assert js.chunks == ts.chunks
    assert _commit_docs(js) == _commit_docs(ts)


def test_port_resumes_jax_store_and_trains_on(tmp_path):
    jcfg, tcfg = _cfgs()
    url = f"dir://{tmp_path}/cas"
    jsess = _jax_sess(jcfg, jcore.open_store(url))
    jsess.attach(seed=0)
    jsess.train(2)
    c2 = jsess.train(2)
    want = _ns_bytes(jsess.ns)
    jsess.train(2)                                # the reference phase
    loss_ref = jsess.ns["metrics/last_loss"]
    jsess.checkout(c2)                            # HEAD back at phase 2
    jsess.close()

    tsess = resume(tcfg, AdamWConfig(lr=1e-3), tcore.open_store(url),
                   global_batch=2, seq_len=16, chunk_bytes=CB, device="cpu")
    assert tsess.kishu.head == c2
    assert _ns_bytes(tsess.ns) == want
    assert tsess.ns[EMBED] is tsess.ns[HEAD]
    tsess.train(2)
    np.testing.assert_allclose(tsess.ns["metrics/last_loss"], loss_ref,
                               rtol=1e-4)
    tsess.close()


def test_jax_resumes_port_store_and_trains_on(tmp_path, monkeypatch):
    jcfg, tcfg = _cfgs()
    _carry_init(monkeypatch, jcfg)
    url = f"dir://{tmp_path}/cas"
    tsess = _torch_sess(tcfg, tcore.open_store(url))
    tsess.attach(seed=0)
    tsess.train(2)
    c2 = tsess.train(2)
    want = _ns_bytes(tsess.ns)
    tsess.train(2)
    loss_ref = tsess.ns["metrics/last_loss"]
    tsess.checkout(c2)
    tsess.close()

    jsess = jloop.resume(jcfg, JAdamW(lr=1e-3), jcore.open_store(url),
                         global_batch=2, seq_len=16, chunk_bytes=CB)
    assert jsess.kishu.head == c2
    assert _ns_bytes(jsess.ns) == want
    assert jsess.ns[EMBED] is jsess.ns[HEAD]
    assert isinstance(jsess.ns[EMBED], jax.Array)
    jsess.train(2)
    np.testing.assert_allclose(jsess.ns["metrics/last_loss"], loss_ref,
                               rtol=1e-4)
    jsess.close()


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_main_on_cpu(capsys, tmp_path):
    tlaunch.main(["--reduced", "--device", "cpu", "--steps", "4",
                  "--phase-steps", "2", "--store", f"dir://{tmp_path}/cas"])
    out = capsys.readouterr().out
    assert "phase   1" in out and "final eval loss" in out
    tlaunch.main(["--reduced", "--device", "cpu", "--steps", "2",
                  "--phase-steps", "2", "--store", f"dir://{tmp_path}/cas",
                  "--resume"])
    assert "resumed at c0000" in capsys.readouterr().out
