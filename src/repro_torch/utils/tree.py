"""Pytree flatten / unflatten with ``jax.tree_util``'s leaf order.

Everything that reaches the pool follows the JAX package's leaf order:
``.cxl0`` frame payloads, the leaf->shard assignment of
``partition_leaves``, the paged block slices.  So the port's trees must
flatten exactly as ``jax.tree_util`` does:

* ``dict``        — children in SORTED key order (unflatten rebuilds the
  dict in that order);
* ``list`` / ``tuple`` — children in order;
* ``NamedTuple``  — children in field order, rebuilt by its own type
  (``KVCache(k, v)``);
* ``None``        — a node with no leaves (``{}`` likewise: an empty dict);
* anything else   — a leaf (tensors, numpy arrays, numbers, descriptors).

``torch.utils._pytree`` keeps dicts in INSERTION order, so it is not used
for anything that is written to the pool.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

IsLeaf = Optional[Callable[[Any], bool]]


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


class TreeDef:
    """The structure of a flattened tree (the counterpart of ``PyTreeDef``)."""

    __slots__ = ("kind", "aux", "children", "num_leaves")

    def __init__(self, kind: str, aux: Any = None,
                 children: Tuple["TreeDef", ...] = ()):
        self.kind = kind            # leaf | none | dict | list | tuple | namedtuple
        self.aux = aux              # dict: sorted keys; namedtuple: its type
        self.children = children
        self.num_leaves = (1 if kind == "leaf"
                           else sum(c.num_leaves for c in children))

    def __eq__(self, other) -> bool:
        return (isinstance(other, TreeDef) and self.kind == other.kind
                and self.aux == other.aux and self.children == other.children)

    def __hash__(self):
        return hash((self.kind, self.children))

    def __repr__(self) -> str:
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        inner = ", ".join(repr(c) for c in self.children)
        if self.kind == "dict":
            return "{" + ", ".join(f"{k!r}: {c!r}" for k, c in
                                   zip(self.aux, self.children)) + "}"
        if self.kind == "list":
            return f"[{inner}]"
        if self.kind == "tuple":
            return f"({inner})"
        return f"{self.aux.__name__}({inner})"

    def unflatten(self, leaves) -> Any:
        leaves = list(leaves)
        if len(leaves) != self.num_leaves:
            raise ValueError(f"tree has {self.num_leaves} leaves, got "
                             f"{len(leaves)}")
        it = iter(leaves)
        return self._build(it)

    def _build(self, it) -> Any:
        if self.kind == "leaf":
            return next(it)
        if self.kind == "none":
            return None
        kids = [c._build(it) for c in self.children]
        if self.kind == "dict":
            return dict(zip(self.aux, kids))
        if self.kind == "list":
            return kids
        if self.kind == "tuple":
            return tuple(kids)
        return self.aux(*kids)

    def flatten_up_to(self, tree: Any) -> List[Any]:
        """Leaves of ``tree`` taken at THIS structure's leaf positions
        (whatever sits there is one leaf, even a subtree) — how
        ``tree_map`` pairs a second tree with the first."""
        out: List[Any] = []
        self._up_to(tree, out)
        return out

    def _up_to(self, tree: Any, out: List[Any]):
        if self.kind == "leaf":
            out.append(tree)
            return
        if self.kind == "none":
            if tree is not None:
                raise ValueError(f"expected None, got {type(tree).__name__}")
            return
        if self.kind == "dict":
            if not isinstance(tree, dict) or sorted(tree) != list(self.aux):
                raise ValueError("dict keys differ from the tree structure")
            kids = [tree[k] for k in self.aux]
        else:
            if not isinstance(tree, (list, tuple)) \
                    or len(tree) != len(self.children):
                raise ValueError("sequence differs from the tree structure")
            kids = list(tree)
        for c, t in zip(self.children, kids):
            c._up_to(t, out)


def _flatten(tree: Any, is_leaf: IsLeaf, out: List[Any]) -> TreeDef:
    if is_leaf is not None and is_leaf(tree):
        out.append(tree)
        return TreeDef("leaf")
    if tree is None:
        return TreeDef("none")
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return TreeDef("dict", keys,
                       tuple(_flatten(tree[k], is_leaf, out) for k in keys))
    if _is_namedtuple(tree):
        return TreeDef("namedtuple", type(tree),
                       tuple(_flatten(c, is_leaf, out) for c in tree))
    if isinstance(tree, (list, tuple)):
        return TreeDef("list" if isinstance(tree, list) else "tuple", None,
                       tuple(_flatten(c, is_leaf, out) for c in tree))
    out.append(tree)
    return TreeDef("leaf")


def tree_flatten(tree: Any, is_leaf: IsLeaf = None
                 ) -> Tuple[List[Any], TreeDef]:
    leaves: List[Any] = []
    treedef = _flatten(tree, is_leaf, leaves)
    return leaves, treedef


def tree_unflatten(treedef: TreeDef, leaves) -> Any:
    return treedef.unflatten(leaves)


def tree_leaves(tree: Any, is_leaf: IsLeaf = None) -> List[Any]:
    return tree_flatten(tree, is_leaf)[0]


def tree_structure(tree: Any, is_leaf: IsLeaf = None) -> TreeDef:
    return tree_flatten(tree, is_leaf)[1]


def tree_map(fn: Callable, tree: Any, *rest: Any, is_leaf: IsLeaf = None
             ) -> Any:
    leaves, treedef = tree_flatten(tree, is_leaf)
    others = [treedef.flatten_up_to(r) for r in rest]
    return treedef.unflatten(fn(*xs) for xs in zip(leaves, *others))
