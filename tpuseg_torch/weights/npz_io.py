"""The JAX package's npz params (the port's copy of
``tpuseg/engine/trainer.py::save_params_npz`` and ``load_params_npz``).

A param tree of nested dicts and lists is stored flat: one array per leaf,
keyed by its dotted path, a list's items by their index in digits
(``backbone.stage0.blocks.1.conv1.conv.weight``); ``None`` leaves are not
stored. The JAX reader walks a template tree to find the keys; the port's
rebuilds the tree from the keys alone (a level whose keys are all digits is
a list), with numpy. ``weights/from_jax.py`` maps such a tree onto the
port's state_dicts and back.
"""
from __future__ import annotations

import os

import numpy as np


def flatten_params(tree, prefix: str = "") -> dict:
    """{dotted path: np.ndarray} of the tree's leaves, ``None`` left out."""
    flat = {}

    def rec(t, pre):
        if isinstance(t, dict):
            for k, v in t.items():
                rec(v, f"{pre}{k}.")
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                rec(v, f"{pre}{i}.")
        elif t is not None:
            flat[pre[:-1]] = np.asarray(t)

    rec(tree, prefix)
    return flat


def unflatten_params(flat: dict):
    """The inverse of :func:`flatten_params`: nested dicts, and lists where
    every key of a level is a digit string (a missing index is ``None``)."""
    root: dict = {}
    for key, value in flat.items():
        node = root
        *parents, leaf = key.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            out = [None] * (max(map(int, node)) + 1)
            for k, v in node.items():
                out[int(k)] = v
            return out
        return node

    return lists(root)


def save_params_npz(path: str, tree) -> None:
    """Write the tree as the JAX package's ``save_params_npz`` does
    (``np.savez``, which adds ``.npz`` to a path without it)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flatten_params(tree))


def load_params_npz(path: str):
    """An npz of flat dotted keys -> the param tree, numpy leaves."""
    with np.load(path) as data:
        return unflatten_params({k: data[k] for k in data.files})
