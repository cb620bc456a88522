"""The port's pytree flatten order equals ``jax.tree_util``'s.

Frame payloads, shard assignment and paged block slices follow leaf
order, so a pool is only shared between the packages if both flatten the
same trees the same way: dict keys sorted, NamedTuples in field order,
lists in order, ``None`` and ``{}`` as nodes with no leaves.
"""
from typing import NamedTuple

import jax
import numpy as np
import pytest

from repro_torch.utils import tree


class Pair(NamedTuple):
    b: object
    a: object


TREES = {
    "unsorted_dict": {"zeta": 1, "alpha": 2, "mid": {"y": 3, "x": 4}},
    "empty_nodes": {"norm1": {}, "attn": {"wq": 5, "wk": 6}, "none": None,
                    "norm2": {}},
    "namedtuple_field_order": [Pair(b=7, a=8), Pair(b=None, a=[9, 10])],
    "nested_lists": [[1, [2, 3]], [], [[[4]]], (5, (6,))],
    "cache_layout": [{"blocks": [Pair(b=np.zeros(2), a=np.ones(3))]}],
    "model_like": {"embed": {"tok": 1}, "final_norm": {},
                   "groups": [{"blocks": [{"norm1": {}, "norm2": {},
                                           "mlp": {"w_up": 2, "w_down": 3,
                                                   "w_gate": 4},
                                           "attn": {"wv": 5, "wq": 6}}]}]},
}


def _key(x):
    return ("arr", tuple(np.asarray(x).ravel())) if isinstance(
        x, np.ndarray) else x


@pytest.mark.parametrize("name", sorted(TREES))
def test_flatten_order_equals_jax(name):
    t = TREES[name]
    ours, _ = tree.tree_flatten(t)
    theirs = jax.tree_util.tree_leaves(t)
    assert [_key(x) for x in ours] == [_key(x) for x in theirs]


@pytest.mark.parametrize("name", sorted(TREES))
def test_unflatten_round_trip_equals_jax(name):
    t = TREES[name]
    leaves, td = tree.tree_flatten(t)
    tagged = [f"leaf{i}" for i in range(len(leaves))]
    ours = td.unflatten(tagged)
    jl, jtd = jax.tree_util.tree_flatten(t)
    theirs = jax.tree_util.tree_unflatten(jtd, tagged)
    assert ours == theirs
    assert type(ours) is type(theirs)
    # dicts come back in sorted key order, NamedTuples as their own type
    assert repr(ours) == repr(theirs)


def test_structure_and_tree_map_with_second_tree():
    t = TREES["cache_layout"]
    axes = tree.tree_map(lambda _: 1, t)
    out = tree.tree_map(lambda a, ax: (a.shape, ax), t, axes)
    jout = jax.tree_util.tree_map(lambda a, ax: (a.shape, ax), t, axes)
    assert out == jout
    assert tree.tree_structure(t) == tree.tree_structure(axes)
    with pytest.raises(ValueError):
        tree.tree_structure(t).unflatten([1])


def test_is_leaf_stops_descent_like_jax():
    t = {"b": Pair(b=1, a=2), "a": [3, Pair(b=4, a=5)]}
    is_pair = lambda x: isinstance(x, Pair)        # noqa: E731
    ours = tree.tree_leaves(t, is_leaf=is_pair)
    theirs = jax.tree_util.tree_leaves(t, is_leaf=is_pair)
    assert ours == theirs
