"""Kishu core over torch tensors — time-traveling for notebook sessions.

The paper's contribution (incremental checkpoint & checkout over a
Checkpoint Graph at co-variable granularity) as a composable library:

    from repro_torch.core import KishuSession, open_store
    s = KishuSession(open_store("dir:///tmp/ckpt"))      # on "cuda"
    s.register("train", train_command)
    s.init_state({"params": params, "opt": opt_state})
    c1 = s.run("train", steps=100)
    c2 = s.run("train", steps=100)
    s.checkout(c1)          # loads only diverged co-variables

Not ported yet: the storage fabric (``fabric://``), the checkout planner
and the paper's baselines.
"""
from repro_torch.core.chunkstore import (ChunkCache, ChunkStore,
                                         CompressedStore, DirectoryStore,
                                         FaultInjectedStore,
                                         FaultInjectingStore, InjectedCrash,
                                         MemoryStore, SQLiteStore,
                                         available_codecs, open_store)
from repro_torch.core.txn import FsckReport, TxnEngine, TxnError, fsck, recover
from repro_torch.core.covariable import (CovKey, LeafRecord, RecordBuilder,
                                         StateDelta, cov_key, detect_delta,
                                         group_covariables)
from repro_torch.core.graph import CheckpointGraph, CheckoutPlan, CommitNode
from repro_torch.core.namespace import (Namespace, TrackedNamespace,
                                        flatten_tree, unflatten_tree)
from repro_torch.core.serialize import (ChunkMissingError, OpaqueLeaf,
                                        SerializationError)
from repro_torch.core.session import KishuSession, RunStats

__all__ = [
    "ChunkCache", "ChunkStore", "CompressedStore", "DirectoryStore",
    "FaultInjectedStore", "MemoryStore", "SQLiteStore", "available_codecs",
    "open_store", "CovKey", "LeafRecord", "RecordBuilder",
    "StateDelta", "cov_key", "detect_delta", "group_covariables",
    "CheckpointGraph", "CheckoutPlan", "CommitNode", "Namespace",
    "TrackedNamespace", "flatten_tree", "unflatten_tree",
    "ChunkMissingError", "OpaqueLeaf", "SerializationError", "KishuSession",
    "RunStats", "FaultInjectingStore", "InjectedCrash", "FsckReport",
    "TxnEngine", "TxnError", "fsck", "recover",
]
