"""Nested trees of tensors: the port's stand-in for ``jax.tree``.

A tree is a dict of trees, a list of tensors, a list of dicts or a leaf.
A list of tensors is a layer stack: the reference keeps it as ONE array
with a leading ``L`` axis, the port as one tensor a layer, so that each
layer's weight is a tensor of its own (no gather, no scatter of the stack
in a step).  ``leaves`` counts each list element as a leaf.  A list of
dicts is a Python list in the reference's tree too (an MLP's layers,
``models.recsys``): each element is a subtree, kept as it is.

The layer-stack rule between the two layouts lives here and nowhere else:
:func:`to_numpy` stacks each list into the reference's one array,
:func:`from_numpy` splits it again; :func:`gather` / :func:`scatter` move
between a module's named parameters and a tree.  The numpy carry-over of
weights and training state and the checkpoint's arrays all go through them.

Leaves come in ``jax.tree.leaves``' order: dict keys sorted, lists in
order.  The optimizer's global norm sums them in that order.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping

import numpy as np
import torch


def leaves(tree) -> list:
    """The leaves of ``tree`` in the reference's order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def unflatten(template, flat: list):
    """``flat`` (as ``leaves(template)`` orders them) in ``template``'s shape."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [build(n) for n in node]
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn: Callable[..., Any], tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of each tree of ``rest``,
    which share its shape)."""
    cols = [leaves(tree)] + [leaves(r) for r in rest]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("trees of different shapes")
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)])


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def to_numpy(tree):
    """``tree`` in the reference's layout as numpy: every tensor copied to
    the host, every list (a layer stack) stacked into one array with a
    leading ``L`` axis."""
    if isinstance(tree, Mapping):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        if any(isinstance(x, Mapping) for x in tree):  # a list of subtrees
            return [to_numpy(x) for x in tree]
        return np.stack([_host(x) for x in tree])
    return _host(tree)


def _like(a, leaf):
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(np.array(a)).to(leaf.device)  # a writable copy
    return np.asarray(a)


def from_numpy(arrays: Mapping, like, path: str = ""):
    """The inverse of :func:`to_numpy`: the numpy tree ``arrays`` (the
    reference's layout) in ``like``'s structure.  Where ``like`` holds a
    list, the array splits along its leading axis into one tensor a layer;
    a tensor leaf of ``like`` gives the device the array goes to; any
    other leaf of ``like`` keeps the array as numpy.  Keys of ``arrays``
    that ``like`` lacks are left out."""
    if isinstance(like, Mapping):
        return {k: from_numpy(arrays[k], v, f"{path}/{k}" if path else k) for k, v in like.items()}
    if isinstance(like, list) and any(isinstance(x, Mapping) for x in like):
        # a list of subtrees: a list, or a dict keyed "0", "1", ... (a checkpoint's)
        items = [arrays[str(i)] for i in range(len(like))] if isinstance(arrays, Mapping) \
            else list(arrays)
        if len(items) != len(like):
            raise ValueError(f"{path}: {len(items)} subtrees, expected {len(like)}")
        return [from_numpy(a, v, f"{path}/{i}") for i, (a, v) in enumerate(zip(items, like))]
    if isinstance(like, list):
        a = np.asarray(arrays)
        if a.shape[0] != len(like):
            raise ValueError(f"{path}: {a.shape[0]} layers, expected {len(like)}")
        return [_like(x, leaf) for x, leaf in zip(a, like)]
    return _like(arrays, like)


def tensors(tree, device):
    """A numpy tree as tensors on ``device``, its structure kept as it is
    (a list stays a list: nothing is stacked or split), value for value."""
    if isinstance(tree, Mapping):
        return {k: tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tensors(v, device) for v in tree]
    return torch.from_numpy(np.array(tree)).to(device)


def place(tree, placement):
    """``tree``'s leaves (tensors or numpy arrays) as tensors on new
    devices: ``placement`` is one device for every leaf, or a tree of
    devices in ``tree``'s shape (``distributed.sharding.tree_shardings``'s
    output).  The values are unchanged."""
    if not isinstance(placement, (dict, list)):
        placement = tree_map(lambda _: placement, tree)

    def put(x, dev):
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
        return t.to(dev)

    return tree_map(put, tree, placement)


def gather(named: Mapping[str, Any], paths: Mapping) -> dict:
    """Named leaves (e.g. a module's parameters) as a tree.  ``paths`` maps
    each name to ``(path in the tree, index in its layer stack or None)``."""
    tree: dict = {}
    for name, (path, layer) in paths.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        if layer is None:
            node[path[-1]] = named[name]
        else:
            stack = node.setdefault(path[-1], [])
            stack.extend([None] * (layer + 1 - len(stack)))
            stack[layer] = named[name]
    return tree


def scatter(tree: Mapping, paths: Mapping) -> dict:
    """The inverse of :func:`gather`: ``{name: leaf}`` for each name of
    ``paths`` (leaves of ``tree`` that ``paths`` does not name are left
    out)."""
    out = {}
    for name, (path, layer) in paths.items():
        node = tree
        for key in path:
            node = node[key]
        out[name] = node if layer is None else node[layer]
    return out
