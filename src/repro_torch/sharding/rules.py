"""Divisibility-aware sharding rules for all architectures and meshes: the
port of the JAX package's ``sharding/rules.py`` onto DTensor placements.

Scheme (MaxText-style 2-D + optional pod axis):
  - FSDP: parameter d_model-like dims sharded over ("pod","data") / ("data",)
  - TP:   heads / ff / vocab dims sharded over "model"
  - EP:   expert dim sharded over "data" (experts per group), ff over "model"
  - activations: batch over ("pod","data"); decode caches shard the *sequence*
    dim over "model"

Every choice is guarded by a divisibility check with a deterministic
fallback (head-TP -> head_dim-TP -> replicate), exactly as in the JAX
package.  Specs are derived from parameter *path names*, so they apply
equally to optimizer moments (same tree structure).

A :class:`Spec` is the reference's ``PartitionSpec``: one entry per tensor
dim (``None``, a mesh axis name, or a tuple of names, major first).
:meth:`ShardingRules.placements` turns it into DTensor placements over the
rules' named ``DeviceMesh``, one per mesh dim: ``Shard(i)`` on every mesh
dim that tensor dim ``i`` names, ``Replicate()`` elsewhere.  A dim over
``("pod", "data")`` shards over pod first, then data, as JAX lays it out.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

from torch.distributed.tensor import Placement, Replicate, Shard

from repro_torch.core.namespace import flatten_tree, unflatten_tree
from repro_torch.models.config import ArchConfig

Placements = Tuple[Placement, ...]


class Spec(tuple):
    """A ``PartitionSpec`` stand-in: ``Spec(None, "model", ("pod",
    "data"))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def _shape(x: Any) -> Tuple[int, ...]:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def spec_placements(spec: Spec, mesh_dim_names: Tuple[str, ...]
                    ) -> Placements:
    """DTensor placements of ``spec`` over a mesh with these dim names."""
    out = []
    for name in mesh_dim_names:
        dims = [i for i, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        if len(dims) > 1:
            raise ValueError(f"{spec}: mesh axis {name} on dims {dims}")
        out.append(Shard(dims[0]) if dims else Replicate())
    for e in spec:
        if isinstance(e, tuple) and \
                list(e) != [n for n in mesh_dim_names if n in e]:
            raise ValueError(f"{spec}: axes {e} not in mesh order "
                             f"{mesh_dim_names}")
    return tuple(out)


def _divides(n: int, by: int) -> bool:
    return by > 0 and n % by == 0


class ShardingRules:
    """Sharding policy over a named ``DeviceMesh`` (dims among "pod",
    "data", "model").  Tunables, with the JAX package's meanings and
    divisibility rules:

    - ``fsdp_pods``: fold the pod axis into the FSDP group.
    - ``expert_pod_shard``: shard the MoE expert dim over ("pod","data")
      instead of "data" alone (halves expert params/moments per device on
      the multi-pod mesh when n_experts divides pod*data).
    - ``attn_fallback``: when n_heads doesn't divide the model axis —
      "head_dim" shards head_dim over model (TP with per-layer reductions);
      "replicate" keeps attention weights replicated and data-parallel only
      (kills the per-layer attention collectives; costs memory).
    - ``seq_shard_activations``: constrain the residual stream to
      Spec(batch, "model", None) between stages (Megatron-SP style RS/AG
      instead of all-reduce).
    - ``expert_fsdp_pod``: also shard the expert d_model dim over "pod"
      (gathered at use: ``sharding/context.py``).
    - ``moe_dispatch_shard``: constrain the MoE dispatch buffers to
      expert-sharded layouts.
    - ``dp_only``: every axis data-parallel, parameters fully sharded over
      the flat rank space, no tensor parallelism.
    """

    def __init__(self, cfg: ArchConfig, mesh, *,
                 fsdp_pods: bool = True,
                 expert_pod_shard: bool = False,
                 attn_fallback: str = "head_dim",
                 seq_shard_activations: bool = False,
                 expert_fsdp_pod: bool = False,
                 moe_dispatch_shard: bool = False,
                 dp_only: bool = False):
        self.cfg = cfg
        self.mesh = mesh
        self.expert_pod_shard = expert_pod_shard
        self.expert_fsdp_pod = expert_fsdp_pod
        self.moe_dispatch_shard = moe_dispatch_shard
        self.attn_fallback = attn_fallback
        self.seq_shard_activations = seq_shard_activations
        self.dp_only = dp_only
        names = tuple(mesh.mesh_dim_names or ())
        sizes = dict(zip(names, mesh.shape))
        self.axis_names = names
        self.model_axis = "model" if "model" in names else None
        self.data_axis = "data" if "data" in names else None
        self.pod_axis = "pod" if "pod" in names else None
        self.model_size = sizes.get("model", 1)
        self.data_size = sizes.get("data", 1)
        self.pod_size = sizes.get("pod", 1)
        # FSDP group: pod axis folds into FSDP for huge models
        if dp_only:
            # ZeRO-3 regime: every axis is data-parallel; params/moments
            # fully sharded over the flat device space; no tensor parallel.
            axes = [a for a in (self.pod_axis, self.data_axis,
                                self.model_axis) if a]
            self.fsdp = tuple(axes)
            self.fsdp_size = self.pod_size * self.data_size * self.model_size
            self.batch_axes = tuple(axes)
            self.batch_size_div = self.fsdp_size
            self.model_axis = None
            self.model_size = 1
            return
        if self.pod_axis and fsdp_pods:
            self.fsdp: Any = (self.pod_axis, self.data_axis)
            self.fsdp_size = self.pod_size * self.data_size
        else:
            self.fsdp = self.data_axis
            self.fsdp_size = self.data_size
        self.batch_axes: Any = ((self.pod_axis, self.data_axis)
                                if self.pod_axis else self.data_axis)
        self.batch_size_div = self.pod_size * self.data_size

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def placements(self, spec: Spec) -> Placements:
        return spec_placements(spec, self.axis_names)

    def _fsdp_if(self, dim: int):
        return self.fsdp if _divides(dim, self.fsdp_size) else None

    def _model_if(self, dim: int):
        return self.model_axis if _divides(dim, self.model_size) else None

    def _batch_if(self, dim: int):
        if _divides(dim, self.batch_size_div):
            return self.batch_axes
        if _divides(dim, self.data_size):
            return self.data_axis
        return None

    # ------------------------------------------------------------------
    # parameters (and optimizer moments — same paths)
    # ------------------------------------------------------------------
    def param_spec(self, path: str, shape: Tuple[int, ...]) -> Placements:
        """The placements of the parameter (or moment) at ``path``."""
        return self.placements(self.param_axes(path, shape))

    def param_axes(self, path: str, shape: Tuple[int, ...]) -> Spec:
        """The reference's ``PartitionSpec`` for ``path`` as a
        :class:`Spec`."""
        cfg = self.cfg
        leaf = path.split("/")[-1]
        parent = path.split("/")[-2] if "/" in path else ""

        if leaf in ("scale", "conv_b", "dt_bias", "A_log", "D"):
            return Spec()
        if leaf == "conv_w":
            lead = (None,) * (len(shape) - 2)
            return Spec(*lead, None, self._model_if(shape[-1]))
        if leaf == "embed":
            return Spec(self._model_if(shape[0]), self._fsdp_if(shape[1]))
        if leaf == "lm_head":
            return Spec(self._fsdp_if(shape[0]), self._model_if(shape[1]))
        if leaf == "router":
            lead = (None,) * (len(shape) - 2)
            return Spec(*lead, self._fsdp_if(shape[-2]), None)

        # MoE expert-stacked weights [*, E, d, f] / [*, E, f, d]
        if leaf in ("w_gate", "w_up", "w_down") and parent == "moe" or \
                (leaf in ("w_gate", "w_up", "w_down") and len(shape) >= 3
                 and "moe" in path):
            lead = (None,) * (len(shape) - 3)      # stacked n_units dims
            e, a, b = shape[-3], shape[-2], shape[-1]
            if self.expert_pod_shard and \
                    _divides(e, self.pod_size * self.data_size) and \
                    self.pod_axis:
                espec: Any = (self.pod_axis, self.data_axis)
            elif _divides(e, self.data_size):
                espec = self.data_axis
            else:
                espec = None
            # optional ZeRO-style pod-sharding of the expert d_model dim:
            # keeps the 16-way dispatch pattern, halves expert memory on the
            # multi-pod mesh at the cost of a small per-layer weight gather
            dpod = (self.pod_axis if self.expert_fsdp_pod and self.pod_axis
                    else None)
            if leaf == "w_down":                   # [E, f, d]
                d_ok = dpod if dpod and _divides(b, self.pod_size) else None
                return Spec(*lead, espec, self._model_if(a), d_ok)
            d_ok = dpod if dpod and _divides(a, self.pod_size) else None
            return Spec(*lead, espec, d_ok, self._model_if(b))

        # dense MLP [*, d, f] / [*, f, d]
        if leaf in ("w_gate", "w_up"):
            lead = (None,) * (len(shape) - 2)
            return Spec(*lead, self._fsdp_if(shape[-2]), self._model_if(shape[-1]))
        if leaf == "w_down":
            lead = (None,) * (len(shape) - 2)
            return Spec(*lead, self._model_if(shape[-2]), self._fsdp_if(shape[-1]))

        # attention projections [*, d, H, hd] / wo [*, H, hd, d]
        if leaf in ("wq", "wk", "wv"):
            lead = (None,) * (len(shape) - 3)
            d, h, hd = shape[-3], shape[-2], shape[-1]
            if _divides(h, self.model_size):
                return Spec(*lead, self._fsdp_if(d), self.model_axis, None)
            if self.attn_fallback == "head_dim" and \
                    _divides(hd, self.model_size):
                return Spec(*lead, self._fsdp_if(d), None, self.model_axis)
            return Spec(*lead, self._fsdp_if(d), None, None)
        if leaf == "wo":
            lead = (None,) * (len(shape) - 3)
            h, hd, d = shape[-3], shape[-2], shape[-1]
            if _divides(h, self.model_size):
                return Spec(*lead, self.model_axis, None, self._fsdp_if(d))
            if self.attn_fallback == "head_dim" and \
                    _divides(hd, self.model_size):
                return Spec(*lead, None, self.model_axis, self._fsdp_if(d))
            return Spec(*lead, None, None, self._fsdp_if(d))

        # MLA
        if leaf in ("wq_a", "wkv_a"):
            lead = (None,) * (len(shape) - 2)
            return Spec(*lead, self._fsdp_if(shape[-2]), None)
        if leaf in ("wq_b", "wkv_b"):
            lead = (None,) * (len(shape) - 3)
            return Spec(*lead, None, self._model_if(shape[-2]), None)

        # SSM projections [*, d, K] / out_proj [*, d_in, d]
        if leaf == "in_proj":
            lead = (None,) * (len(shape) - 2)
            return Spec(*lead, self._fsdp_if(shape[-2]), None)
        if leaf == "out_proj":
            lead = (None,) * (len(shape) - 2)
            return Spec(*lead, self._model_if(shape[-2]), self._fsdp_if(shape[-1]))
        if leaf == "proj":                          # mtp [2d, d]
            lead = (None,) * (len(shape) - 2)
            return Spec(*lead, self._fsdp_if(shape[-2]), self._model_if(shape[-1]))

        # default: replicate
        return Spec()

    def param_shardings(self, params) -> Any:
        """The placements of every leaf of a parameter (or moment) tree
        of tensors, meta tensors or shapes, in the same tree."""
        flat = flatten_tree(params)
        return unflatten_tree({k: self.param_spec(k, _shape(v))
                               for k, v in flat.items()})

    # ------------------------------------------------------------------
    # activations / batches / caches
    # ------------------------------------------------------------------
    def batch_spec(self, batch_tree) -> Any:
        def spec(x):
            if not hasattr(x, "shape") or x.ndim == 0:
                return self.placements(Spec())
            b = self._batch_if(x.shape[0])
            return self.placements(Spec(b, *([None] * (x.ndim - 1))))
        return _tree_map(spec, batch_tree)

    def cache_spec(self, caches_tree, batch: int) -> Any:
        """Decode caches: batch over data axes, *sequence* dim over model.

        Cache leaves are stacked [n_units, ...]; leaf kinds are identified by
        rank/shape (k/v: [U,B,S,H,hd]; c_kv: [U,B,S,r]; k_rope: [U,B,S,1,hd];
        ssm state: [U,B,H,P,N]; conv: [U,B,W,C]; index: [U])."""
        bspec = self._batch_if(batch)

        def spec(x):
            if not hasattr(x, "shape") or x.ndim <= 1:
                return self.placements(Spec())
            s = list(x.shape)
            if x.ndim == 5 and s[1] == batch:       # k/v cache [U,B,S,H,hd]
                seq_ax = self._model_if(s[2])
                if s[3] == 1:                        # k_rope single head
                    return self.placements(Spec(None, bspec, seq_ax, None, None))
                return self.placements(Spec(None, bspec, seq_ax, None, None))
            if x.ndim == 4 and s[1] == batch:
                # c_kv [U,B,S,r] or ssm state [U,B,H,P] won't occur (state is 5D
                # with U); treat dim2 as seq/heads: shard over model if divisible
                return self.placements(Spec(None, bspec, self._model_if(s[2]), None))
            if x.ndim == 3 and s[1] == batch:        # conv [U,B? ...]
                return self.placements(Spec(None, bspec, None))
            if x.ndim >= 2 and s[0] == batch:        # enc_out [B,S,d]
                return self.placements(Spec(bspec, *([None] * (x.ndim - 1))))
            return self.placements(Spec())
        return _tree_map(spec, caches_tree)

    def logits_spec(self, batch: int) -> Placements:
        return self.placements(
            Spec(self._batch_if(batch), None,
                 self._model_if(self.cfg.padded_vocab)))

    def replicated(self) -> Placements:
        return self.placements(Spec())

    # activation constraint used at stage boundaries inside the model
    def hidden_spec(self, batch: int, seq: int = 0) -> Placements:
        if self.seq_shard_activations and seq and \
                _divides(seq, self.model_size):
            return self.placements(
                Spec(self._batch_if(batch), self.model_axis, None))
        return self.placements(Spec(self._batch_if(batch), None, None))


def distribute_tree(tree: Any, mesh, placements: Any) -> Any:
    """Every tensor leaf of ``tree`` as a DTensor on ``mesh`` with the
    placements at the same path of ``placements`` (the JAX package's
    ``device_put(tree, shardings)``); each rank keeps its own shard."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, dict):
        return {k: distribute_tree(v, mesh, placements[k])
                for k, v in tree.items()}
    return distribute_tensor(tree, mesh, list(placements))


def shard_train_state(state: dict, rules: "ShardingRules") -> dict:
    """A train state with params and AdamW moments as DTensors under
    ``rules.param_shardings`` (the moments share the params' paths, so
    their placements); ``count``, ``step`` and ``rng`` stay plain."""
    pl = rules.param_shardings(state["params"])
    return {"params": distribute_tree(state["params"], rules.mesh, pl),
            "opt": {"mu": distribute_tree(state["opt"]["mu"], rules.mesh, pl),
                    "nu": distribute_tree(state["opt"]["nu"], rules.mesh, pl),
                    "count": state["opt"]["count"]},
            "step": state["step"], "rng": state["rng"]}


def shard_caches(caches: dict, rules: "ShardingRules", batch: int) -> dict:
    """A plain decode cache tree (``models.lm.init_caches``) as DTensors
    under ``rules.cache_spec`` (the JAX package's ``device_put(caches,
    cache_spec)``): K/V and MLA's ``c_kv``/``k_rope`` sharded on the
    sequence over ``model``, SSM ``state`` on its heads, ``conv`` and
    ``enc_out`` on the batch, ``index`` replicated; batch dims over the
    data axes where they divide ``batch``."""
    return distribute_tree(caches, rules.mesh,
                           rules.cache_spec(caches, batch))
