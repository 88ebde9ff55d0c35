"""Checkpoints of a tree of tensors, with no dependency beyond numpy.

Format (the reference's ``repro.checkpoint.ckpt``): a directory per
checkpoint with one ``.npy`` file per leaf, named by the leaf's path in
the tree, and a ``manifest.json`` listing the leaves.  A tree is nested
dicts (keys in sorted order), NamedTuples, tuples and lists whose leaves
are tensors, numpy arrays or Python numbers; ``None`` is an empty
subtree.  Writes are atomic (a temporary directory renamed into place),
so a crash mid-write leaves no partial checkpoint behind.  ``restore``
rebuilds the structure of a target tree and places each tensor on the
device of the target's leaf.  A bfloat16 tensor is stored bit-cast to
``uint16`` with ``"dtype": "bfloat16"`` in the manifest (numpy has no
bfloat16), as the reference stores it, and restored bit for bit.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile

import numpy as np
import torch

MANIFEST = "manifest.json"
_NUMBERS = (bool, int, float)


def _children(tree):
    """``(name, child)`` pairs of an inner node, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def flatten(tree, prefix: str = "") -> list:
    """``(path, leaf)`` pairs in tree order; paths join names with '.'."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix or "root", tree)]
    out = []
    for name, child in kids:
        out.extend(flatten(child, f"{prefix}.{name}" if prefix else name))
    return out


def _rebuild(target, leaves):
    if target is None:
        return None
    kids = _children(target)
    if kids is None:
        return next(leaves)
    values = [_rebuild(child, leaves) for _, child in kids]
    if isinstance(target, dict):
        return dict(zip((name for name, _ in kids), values))
    if hasattr(target, "_fields"):
        return type(target)(*values)
    return type(target)(values)


def _fname(key: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", key) + ".npy"


def host_leaves(tree) -> list:
    """``(path, numpy array, dtype name)`` copies of every leaf, taken now:
    the tree may change after this returns without changing what is
    written.  A bfloat16 tensor's array holds its bits as ``uint16``."""
    out = []
    for key, leaf in flatten(tree):
        if torch.is_tensor(leaf):
            t = leaf.detach().cpu()
            if t.dtype == torch.bfloat16:
                arr = t.view(torch.int16).numpy().view(np.uint16)
                out.append((key, np.array(arr, copy=True), "bfloat16"))
                continue
            arr = t.numpy()
        elif isinstance(leaf, (np.ndarray, np.generic) + _NUMBERS):
            arr = np.asarray(leaf)
        else:
            raise TypeError(f"checkpoint leaf {key!r} is a "
                            f"{type(leaf).__name__}")
        out.append((key, np.array(arr, copy=True), str(arr.dtype)))
    return out


def write(path: str, leaves) -> None:
    """Atomically write :func:`host_leaves` output to directory ``path``."""
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=parent, prefix=".ckpt-tmp-")
    manifest = {"leaves": []}
    for key, arr, dtype in leaves:
        entry = {"key": key, "file": _fname(key), "dtype": dtype}
        np.save(os.path.join(tmp, entry["file"]), arr, allow_pickle=False)
        manifest["leaves"].append(entry)
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        backup = path + ".old"
        os.replace(path, backup)
        os.replace(tmp, path)
        shutil.rmtree(backup, ignore_errors=True)
    else:
        os.replace(tmp, path)


def save(path: str, tree) -> None:
    """Atomically write ``tree`` to directory ``path``."""
    write(path, host_leaves(tree))


def restore(path: str, target):
    """The checkpoint at ``path`` in the structure of ``target``: tensor
    leaves land on the device of the target's leaf, Python-number leaves
    come back as the target's type.  A missing leaf raises ``KeyError``,
    a shape or dtype other than the target's ``ValueError``."""
    with open(os.path.join(path, MANIFEST)) as f:
        by_key = {e["key"]: e for e in json.load(f)["leaves"]}
    out = []
    for key, leaf in flatten(target):
        if key not in by_key:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = np.load(os.path.join(path, by_key[key]["file"]),
                      allow_pickle=False)
        if torch.is_tensor(leaf):
            t = torch.from_numpy(arr)
            if by_key[key]["dtype"] == "bfloat16":
                t = t.view(torch.int16).view(torch.bfloat16)
            if tuple(t.shape) != tuple(leaf.shape) or t.dtype != leaf.dtype:
                raise ValueError(
                    f"leaf {key}: checkpoint {t.dtype}{tuple(t.shape)} vs "
                    f"target {leaf.dtype}{tuple(leaf.shape)}")
            out.append(t.to(leaf.device))
        elif isinstance(leaf, _NUMBERS):
            if arr.shape != ():
                raise ValueError(f"leaf {key}: checkpoint shape "
                                 f"{arr.shape} for a number")
            out.append(type(leaf)(arr.item()))
        else:
            out.append(arr)
    return _rebuild(target, iter(out))
