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

A tree of DTensors (a state placed on a mesh) is saved as full arrays:
every rank of the mesh gathers each sharded leaf (a collective, so every
rank calls ``save``), the mesh's first rank writes, and no rank returns
before the checkpoint is on disk.  ``restore(..., shardings=)`` places
each leaf by a :class:`~repro_torch.distributed.sharding.NamedSharding`
of any mesh, so leaves saved under one mesh land resharded on another
(the reference's elastic re-mesh).
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


def rebuild(target, leaves):
    """``target``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if target is None:
        return None
    kids = _children(target)
    if kids is None:
        return next(leaves)
    values = [rebuild(child, leaves) for _, child in kids]
    if isinstance(target, dict):
        return dict(zip((name for name, _ in kids), values))
    if hasattr(target, "_fields"):
        return type(target)(*values)
    return type(target)(values)


def _fname(key: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", key) + ".npy"


def dtensor_mesh(tree):
    """The mesh of the tree's first DTensor leaf, or None."""
    from torch.distributed.tensor import DTensor
    for _, leaf in flatten(tree):
        if isinstance(leaf, DTensor):
            return leaf.device_mesh
    return None


def writes_here(mesh) -> bool:
    """Whether this process writes a checkpoint of a tree on ``mesh``
    (None: a tree of plain tensors, written by its process): the mesh's
    first rank does."""
    if mesh is None:
        return True
    coord = mesh.get_coordinate()
    return coord is not None and not any(coord)


def mesh_barrier(mesh) -> None:
    """Return on no rank of ``mesh`` before every rank has reached it (a
    sum over each mesh axis in turn, waited for); nothing without a
    mesh."""
    if mesh is None:
        return
    from torch.distributed.tensor import DTensor, Partial
    from repro_torch.launch.mesh import mesh_device
    one = torch.ones(1, device=mesh_device(mesh))
    DTensor.from_local(one, mesh, [Partial()] * mesh.ndim,
                       run_check=False).full_tensor().item()


def host_leaves(tree) -> list:
    """``(path, numpy array, dtype name)`` copies of every leaf, taken now:
    the tree may change after this returns without changing what is
    written.  A bfloat16 tensor's array holds its bits as ``uint16``; a
    DTensor is gathered whole (every rank of its mesh takes part)."""
    from torch.distributed.tensor import DTensor
    out = []
    for key, leaf in flatten(tree):
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()
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
    """Atomically write ``tree`` to directory ``path`` (a tree on a mesh:
    gathered by every rank, written by the first, on disk before any
    rank returns)."""
    mesh = dtensor_mesh(tree)
    leaves = host_leaves(tree)
    if writes_here(mesh):
        write(path, leaves)
    mesh_barrier(mesh)


def _placed(t: torch.Tensor, leaf, sharding):
    """A restored full tensor where the target's leaf says: by
    ``sharding`` where one is given, else as the leaf is placed (a
    DTensor's mesh and placements, a tensor's device; the CPU for a meta
    leaf)."""
    if sharding is not None:
        return sharding.place(t)
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(leaf, DTensor):
        return distribute_tensor(t.to(leaf.device), leaf.device_mesh,
                                 leaf.placements, src_data_rank=None)
    return t if leaf.device.type == "meta" else t.to(leaf.device)


def restore(path: str, target, shardings=None):
    """The checkpoint at ``path`` in the structure of ``target`` (tensors,
    DTensors or meta tensors): tensor leaves land as :func:`_placed` says,
    Python-number leaves come back as the target's type.  ``shardings``:
    a tree shaped as ``target`` whose leaves are
    :class:`~repro_torch.distributed.sharding.NamedSharding` (None, or a
    missing subtree: the leaf's own placement).  A missing leaf raises
    ``KeyError``, a shape or dtype other than the target's
    ``ValueError``."""
    with open(os.path.join(path, MANIFEST)) as f:
        by_key = {e["key"]: e for e in json.load(f)["leaves"]}
    where = dict(flatten(shardings)) if shardings is not None else {}
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
            out.append(_placed(t, leaf, where.get(key)))
        elif isinstance(leaf, _NUMBERS):
            if arr.shape != ():
                raise ValueError(f"leaf {key}: checkpoint shape "
                                 f"{arr.shape} for a number")
            out.append(type(leaf)(arr.item()))
        else:
            out.append(arr)
    return rebuild(target, iter(out))
