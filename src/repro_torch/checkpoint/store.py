"""Flat-key npz checkpoints of nested trees of tensors (counterpart of
``repro.checkpoint.store``).

A tree is nested dicts (keys in sorted order, as ``jax.tree.flatten``
orders them), lists and tuples whose leaves are tensors, numpy arrays or
numbers.  ``save_pytree`` writes the reference's file pair: ``<path>.npz``
with the leaves as ``leaf_0, leaf_1, ...`` and ``<path>.meta.json`` with
the leaf count, each leaf's dtype (bfloat16 stored as a ``uint16`` view
and tagged) and a description of the tree.  ``load_pytree`` restores into
the structure of ``like``, raising where the leaf count or a shape does
not fit.  Model parameters go in as ``dict(model.named_parameters())``.
"""
from __future__ import annotations

import json
import os
from typing import Any, List

import numpy as np
import torch

_BF16_TAG = "__bf16__"


def _leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _describe(tree: Any) -> str:
    if isinstance(tree, dict):
        return "{" + ",".join(f"{k}:{_describe(tree[k])}"
                              for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ",".join(_describe(v) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"


def _rebuild(like: Any, it) -> Any:
    if isinstance(like, dict):
        return {k: _rebuild(like[k], it) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, it) for v in like)
    return next(it)


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_pytree(path: str, tree: Any) -> None:
    path = _npz(path)
    leaves = _leaves(tree)
    arrays, dtypes = {}, []
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().cpu()
            if t.dtype == torch.bfloat16:
                dtypes.append(_BF16_TAG)
                arr = t.view(torch.int16).numpy().view(np.uint16)
            else:
                arr = t.numpy()
                dtypes.append(str(arr.dtype))
        else:
            arr = np.asarray(leaf)
            dtypes.append(str(arr.dtype))
        arrays[f"leaf_{i}"] = arr
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **arrays)
    with open(path.removesuffix(".npz") + ".meta.json", "w") as f:
        json.dump({"treedef": _describe(tree), "n": len(leaves),
                   "dtypes": dtypes}, f)


def load_pytree(path: str, like: Any) -> Any:
    """Restore into the structure of ``like``: a tensor leaf of ``like``
    becomes a tensor on its device, any other leaf a numpy array; dtypes
    are the checkpoint's.  Raises ``ValueError`` where the leaf count or a
    leaf's shape differs from ``like``."""
    path = _npz(path)
    with open(path.removesuffix(".npz") + ".meta.json") as f:
        meta = json.load(f)
    refs = _leaves(like)
    if meta["n"] != len(refs):
        raise ValueError(f"checkpoint has {meta['n']} leaves, target has "
                         f"{len(refs)}")
    out = []
    with np.load(path) as data:
        for i, ref in enumerate(refs):
            arr = data[f"leaf_{i}"]
            if tuple(arr.shape) != tuple(np.shape(ref)):
                raise ValueError(f"leaf {i}: checkpoint {arr.shape} != "
                                 f"target {tuple(np.shape(ref))}")
            if not isinstance(ref, torch.Tensor):
                out.append(arr)
                continue
            if meta["dtypes"][i] == _BF16_TAG:
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            out.append(t.to(ref.device))
    return _rebuild(like, iter(out))
