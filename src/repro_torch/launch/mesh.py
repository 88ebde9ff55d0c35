"""Device meshes (``repro.launch.mesh``).

Functions, not module-level constants: importing this module touches no
device and no process group, as the reference's keeps jax's device state
untouched until a mesh is asked for.

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` (a rank per
device, the axes named ``("data", "model")`` or ``("pod", "data",
"model")``) or, where no process group of the mesh's size exists, an
:class:`AbstractMesh`: the axis names and sizes alone, which is all the
sharding rules read (:mod:`repro_torch.distributed.sharding`).
"""
from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.distributed as dist

from repro_torch import resolve_device

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes without devices or ranks: the
    sharding rules accept it as they accept a ``DeviceMesh``."""
    shape: tuple
    mesh_dim_names: tuple

    def size(self, mesh_dim: int | None = None) -> int:
        return (math.prod(self.shape) if mesh_dim is None
                else self.shape[mesh_dim])


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def ensure_process_group(device=None) -> torch.device:
    """Start the default process group if none is up: from the
    environment ``torch.distributed.run`` sets (``WORLD_SIZE``, ``RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``), else a group of one rank over an
    in-process store.  NCCL on the card, gloo on the CPU.  Returns the
    rank's device (on the card ``cuda:LOCAL_RANK``, modulo the cards
    there are)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(_backend(dev))
        else:
            dist.init_process_group(_backend(dev), store=dist.HashStore(),
                                    rank=0, world_size=1)
    return dev


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``: the current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def make_host_mesh(data: int = 1, model: int = 1, device=None):
    """A ``("data", "model")`` DeviceMesh of ``data x model`` ranks over
    the default process group, started by :func:`ensure_process_group`
    where none is up (a group of one rank when ``data * model`` is 1 and
    no launcher set the environment).  The group's size must be ``data *
    model``."""
    dev = ensure_process_group(device)
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"a {data} x {model} mesh needs {data * model} "
                         f"ranks; the process group has {world}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, (data, model), mesh_dim_names=AXES)


def make_mesh(ranks, shape, names=AXES, device_type: str = "cpu"):
    """A DeviceMesh of ``shape`` over the given ranks of the default group
    (row-major).  Every rank of the default group calls it, those outside
    the mesh too: forming a mesh's groups is collective over the world."""
    from torch.distributed.device_mesh import DeviceMesh
    grid = torch.tensor(list(ranks), dtype=torch.int64).reshape(shape)
    return DeviceMesh(device_type, grid, mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """The reference's production meshes: 16 x 16 = 256 ranks ``("data",
    "model")``, or two pods of them, 2 x 16 x 16 ``("pod", "data",
    "model")``.

    Where the default process group has exactly that many ranks (a real
    job, or the fake backend's ``world_size`` under the dry-run's
    ``FakeStore``), the caller gets a DeviceMesh over it on
    ``device_type`` (default: ``cuda`` where a card is visible, else
    ``cpu``).  Anywhere else (one process, no group, the sharding tests)
    the caller gets an :class:`AbstractMesh` of the same names and sizes,
    which the sharding rules take as they take a DeviceMesh."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = POD_AXES if multi_pod else AXES
    if dist.is_initialized() and dist.get_world_size() == math.prod(shape):
        from torch.distributed.device_mesh import init_device_mesh
        if device_type is None:
            device_type = "cuda" if torch.cuda.is_available() else "cpu"
        return init_device_mesh(device_type, shape, mesh_dim_names=names)
    return AbstractMesh(shape, names)


def _rank_main(rank, world, store_path, fn, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, store_dir: str, *args) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` new processes on this
    machine, each rank of one gloo group on the CPU (one thread each),
    met through a ``FileStore`` under ``store_dir`` (no network port).
    Returns when all have ended; raises if one failed.  ``fn`` must be
    importable by name (a module-level function)."""
    import tempfile
    import torch.multiprocessing as mp
    os.makedirs(store_dir, exist_ok=True)
    path = tempfile.mktemp(prefix="store-", dir=store_dir)
    mp.spawn(_rank_main, args=(world, path, fn, args), nprocs=world,
             join=True)
