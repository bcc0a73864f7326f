"""Trees of tensors — nested dicts, tuples, lists and NamedTuples — in
`jax.tree_util`'s order, which the optimizers, the gradient compressor
and the checkpoints of the port walk.

`flatten` lists the leaves as `jax.tree_util.tree_flatten` does: a dict's
values by *sorted* key, a tuple's, list's or NamedTuple's in order; None
is an empty subtree (no leaf); anything else is a leaf.
`torch.utils._pytree` keeps a dict's insertion order instead, so it would
number a checkpoint's leaves otherwise than the reference.  `unflatten`
rebuilds a tree from its `TreeDef` and leaves; `tree_map` applies a
function leaf by leaf over trees of one structure; `transpose` turns a
tree of k-tuples into k trees.
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Sequence, Tuple


class TreeDef(NamedTuple):
    """A tree's structure: ``kind`` is "leaf", "none", "dict" (``meta`` the
    sorted keys), "seq" (``meta`` the tuple, list or NamedTuple type);
    ``children`` the subtrees' defs."""
    kind: str
    meta: Any
    children: Tuple["TreeDef", ...]

    def __str__(self) -> str:
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        inner = ", ".join(str(c) for c in self.children)
        if self.kind == "dict":
            return "{" + ", ".join(f"{k!r}: {c}" for k, c in
                                   zip(self.meta, self.children)) + "}"
        if self.meta is list:
            return f"[{inner}]"
        if self.meta is tuple:
            return f"({inner},)" if len(self.children) == 1 else f"({inner})"
        return f"{self.meta.__name__}({inner})"


_LEAF = TreeDef("leaf", None, ())
_NONE = TreeDef("none", None, ())


def _node(tree) -> Tuple[TreeDef, List]:
    """(the node's def without children, its subtrees in order), or None
    for a leaf."""
    if tree is None:
        return _NONE, []
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return TreeDef("dict", keys, ()), [tree[k] for k in keys]
    if isinstance(tree, (tuple, list)):
        return TreeDef("seq", type(tree), ()), list(tree)
    return None


def flatten(tree) -> Tuple[List[Any], TreeDef]:
    """(leaves in `jax.tree_util.tree_flatten`'s order, the tree's def)."""
    leaves: List[Any] = []

    def walk(t) -> TreeDef:
        node = _node(t)
        if node is None:
            leaves.append(t)
            return _LEAF
        head, subs = node
        return head._replace(children=tuple(walk(c) for c in subs))
    return leaves, walk(tree)


def unflatten(treedef: TreeDef, leaves: Sequence[Any]):
    """The tree of ``treedef`` with ``leaves`` in flatten order."""
    it = iter(leaves)

    def build(d: TreeDef):
        if d.kind == "leaf":
            return next(it)
        if d.kind == "none":
            return None
        subs = [build(c) for c in d.children]
        if d.kind == "dict":
            return dict(zip(d.meta, subs))
        if d.meta in (tuple, list):
            return d.meta(subs)
        return d.meta(*subs)                       # a NamedTuple
    out = build(treedef)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree has")
    return out


def leaves(tree) -> List[Any]:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied to the leaves of ``tree`` and the matching leaves of
    each tree in ``rest`` (all of one structure)."""
    flat, treedef = flatten(tree)
    others = []
    for other in rest:
        o, d = flatten(other)
        if d != treedef:
            raise ValueError(f"tree structures differ: {treedef} and {d}")
        others.append(o)
    return unflatten(treedef, [fn(*xs) for xs in zip(flat, *others)])


def transpose(treedef: TreeDef, k: int, tuples: Sequence[Tuple]) -> Tuple:
    """k trees of ``treedef`` from its leaves' k-tuples (in flatten order):
    the i-th tree holds every tuple's i-th entry."""
    return tuple(unflatten(treedef, [t[i] for t in tuples])
                 for i in range(k))
