"""Session namespace with access tracking — the Patched Namespace (§4.3).

The session state is a flat mapping ``name -> leaf`` where names are
"/"-joined paths (e.g. ``params/stages/stage_0/sub_0/attn/wq``).  Commands
execute against a :class:`TrackedNamespace`, whose get/set/delete hooks
record *accessed* names; by Lemma 1, only co-variables intersecting the
accessed set can have been updated, so delta detection is pruned to those.

Tree helpers convert nested pytrees (params, optimizer state) to and from
flat names, which is how the training substrate plugs into the paper's
variable model.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Iterator, List, MutableMapping, Set

SEP = "/"


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts -> flat {path: leaf}. Non-dict values are leaves."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            sub = prefix + SEP + str(k) if prefix else str(k)
            out.update(flatten_tree(tree[k], sub))
    else:
        out[prefix] = tree
    return out


def unflatten_tree(flat: Dict[str, Any]) -> Any:
    root: Dict[str, Any] = {}
    for path, leaf in flat.items():
        parts = path.split(SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return root


class Namespace(MutableMapping):
    """Flat name -> leaf mapping with pytree conveniences."""

    def __init__(self, init: Dict[str, Any] | None = None):
        self._d: Dict[str, Any] = dict(init or {})

    # -- MutableMapping --
    def __getitem__(self, name: str) -> Any:
        return self._d[name]

    def __setitem__(self, name: str, value: Any) -> None:
        self._d[name] = value

    def __delitem__(self, name: str) -> None:
        del self._d[name]

    def __iter__(self) -> Iterator[str]:
        return iter(self._d)

    def __len__(self) -> int:
        return len(self._d)

    # -- trees --
    def get_tree(self, prefix: str) -> Any:
        pre = prefix + SEP
        sub = {k[len(pre):]: v for k, v in self._d.items() if k.startswith(pre)}
        if not sub:
            if prefix in self._d:
                return self._d[prefix]
            raise KeyError(prefix)
        return unflatten_tree(sub)

    def set_tree(self, prefix: str, tree: Any) -> List[str]:
        """Replace the subtree under ``prefix``; returns names written."""
        pre = prefix + SEP
        stale = [k for k in self._d if k.startswith(pre) or k == prefix]
        flat = flatten_tree(tree, prefix)
        for k in stale:
            if k not in flat:
                del self._d[k]
        self._d.update(flat)
        return list(flat)

    def names(self) -> List[str]:
        return sorted(self._d)


class TrackedNamespace(MutableMapping):
    """Records get/set/delete accesses on a Namespace (the §4.3 patch).

    ``accessed`` = any touch; ``written`` / ``deleted`` / ``created`` refine
    it for delta bookkeeping.  ``pause()`` suspends tracking (used by the
    checkout path, which replaces data *without* marking it accessed).
    """

    def __init__(self, base: Namespace):
        self.base = base
        self.accessed: Set[str] = set()
        self.read: Set[str] = set()     # data reads only — a pure overwrite
                                        # (ns["x"] = v) touches ``accessed``
                                        # but not ``read``, so replay deps
                                        # can skip pre-images the command
                                        # never looks at
        self.written: Set[str] = set()
        self.deleted: Set[str] = set()
        self._paused = False

    # -- tracking core --
    def _touch(self, name: str) -> None:
        if not self._paused:
            self.accessed.add(name)

    def __getitem__(self, name: str) -> Any:
        self._touch(name)
        if not self._paused:
            self.read.add(name)
        return self.base[name]

    def __setitem__(self, name: str, value: Any) -> None:
        self._touch(name)
        if not self._paused:
            self.written.add(name)
            self.deleted.discard(name)
        self.base[name] = value

    def __delitem__(self, name: str) -> None:
        self._touch(name)
        if not self._paused:
            self.deleted.add(name)
            self.written.discard(name)
        del self.base[name]

    def __iter__(self) -> Iterator[str]:
        # iteration (e.g. listing) does not count as data access
        return iter(self.base)

    def __len__(self) -> int:
        return len(self.base)

    # -- trees --
    def get_tree(self, prefix: str) -> Any:
        pre = prefix + SEP
        touched = [k for k in self.base if k.startswith(pre) or k == prefix]
        for k in touched:
            self._touch(k)
            if not self._paused:
                self.read.add(k)
        return self.base.get_tree(prefix)

    def set_tree(self, prefix: str, tree: Any) -> None:
        pre = prefix + SEP
        before = {k for k in self.base if k.startswith(pre) or k == prefix}
        names = self.base.set_tree(prefix, tree)
        if not self._paused:
            for k in names:
                self.accessed.add(k)
                self.written.add(k)
                self.deleted.discard(k)
            for k in before.difference(names):
                self.accessed.add(k)
                self.deleted.add(k)
                self.written.discard(k)

    def names(self) -> List[str]:
        return self.base.names()

    # -- control --
    def pause(self):
        class _P:
            def __enter__(_s):
                self._paused = True
            def __exit__(_s, *a):
                self._paused = False
        return _P()

    def reset(self) -> None:
        self.accessed.clear()
        self.read.clear()
        self.written.clear()
        self.deleted.clear()
