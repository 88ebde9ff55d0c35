"""Dry-run: trace every (arch x shape x mesh) cell's step on a fake
process group and count its roofline terms (``repro.launch.dryrun``).

For each cell the process starts PyTorch's fake process-group backend
with the production mesh's ranks (16 x 16 = 256, or 2 x 16 x 16 = 512;
one mesh size a process, since a fake world's size is fixed), builds the
state, batch and cache as DTensors whose local shards are fake tensors
(``FakeTensorMode``: shapes and types, no memory, no launch) placed by
``steps.train_shardings`` / ``serve_shardings``, runs the train, prefill
or decode step once under :class:`~repro_torch.launch.roofline.Counter`,
and writes the roofline terms to ``reports/dryrun_torch/*.json``.  The
step is the program the card runs, rank 0's share of it: the kernels
K3-K6 are registered ops whose fake implementations give their outputs'
shapes and whose formulas give their work.  The fake tensors lie on the
card's device type where PyTorch has CUDA, else on the CPU (autograd
needs the device's guard, which a CPU-only build lacks for CUDA); no
path of the program reads the device type but the kernel ops'
dispatch, and the counts are the same on both (``tests/
test_torch_dryrun.py``).  The eager trace runs every layer (the
reference lowers two unrolled depths because XLA counts a scan's body
once), but for RWKV-6's train cells, whose backward steps the recurrence
token by token: those are traced at 2 and 3 superblocks and
extrapolated, which a test shows exact.

A decode cell writes its token at the cache's last row and attends over
all of it, the work of the reference's masked full-cache attention.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
import traceback
import types

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs.shapes import SHAPES, applicable_shapes
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import roofline, steps
from repro_torch.models import transformer

REPORT_DIR = "reports/dryrun_torch"
MESHES = {False: ((16, 16), mesh_lib.AXES, "pod16x16"),
          True: ((2, 16, 16), mesh_lib.POD_AXES, "pod2x16x16")}


def device_type() -> str:
    """The fake tensors' device type: the card's where PyTorch has CUDA."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def fake_world(world: int) -> None:
    """Start a fake process group of ``world`` ranks (this process rank
    0), or check that the running group has that many."""
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"the process group has "
                               f"{dist.get_world_size()} ranks, not {world}:"
                               f" one mesh size a process")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def make_mesh(shape: tuple, names: tuple, dev: str):
    """A DeviceMesh of ``shape`` over a fake world of its size."""
    fake_world(math.prod(shape))
    return mesh_lib.make_mesh(range(math.prod(shape)), shape, names, dev)


def fake_mode():
    """The one ``FakeTensorMode`` a process traces under (constants the
    model caches, such as rotary tables, outlive a cell)."""
    global _FAKE
    if _FAKE is None:
        from torch._subclasses.fake_tensor import FakeTensorMode
        _FAKE = FakeTensorMode(allow_non_fake_inputs=True)
    return _FAKE


_FAKE = None


def local_shape(shape, sharding) -> tuple:
    """A rank's shard of ``shape`` under ``sharding`` (a
    :class:`~repro_torch.distributed.sharding.NamedSharding` on a mesh or
    an abstract mesh): each dimension divided by the sizes of the mesh
    axes it is split over (the rules split only where they divide)."""
    local = list(shape)
    for axis, p in enumerate(sharding.placements()):
        if p.is_shard():
            n = sharding.mesh.size(axis)
            if local[p.dim] % n:
                raise ValueError(f"{tuple(shape)} does not split evenly "
                                 f"over {sharding.spec}")
            local[p.dim] //= n
    return tuple(local)


def placed(t: torch.Tensor, sharding, dev: str):
    """A fake tensor of ``t``'s shape and type (``t`` on the meta device)
    on ``sharding``'s mesh as a DTensor of this rank's shard; a 0-d
    tensor stays the plain (fake) tensor every rank holds."""
    from torch.distributed.tensor import DTensor
    with fake_mode():
        if t.dim() == 0:
            return torch.zeros((), dtype=t.dtype, device=dev)
        local = torch.empty(local_shape(t.shape, sharding), dtype=t.dtype,
                            device=dev)
        return DTensor.from_local(local, sharding.mesh,
                                  sharding.placements(), run_check=False,
                                  shape=t.shape, stride=t.stride())


def shard_meta(t: torch.Tensor, sharding) -> torch.Tensor:
    """A rank's shard of ``t`` on the meta device (no mesh needed: the
    byte arithmetic of a cell's arguments)."""
    return torch.empty(local_shape(t.shape, sharding), dtype=t.dtype,
                       device="meta")


def _tree(tree, shardings, leaf):
    from repro_torch.checkpoint import ckpt
    where = dict(ckpt.flatten(shardings))
    leaves = [leaf(v, where[k]) if torch.is_tensor(v) else v
              for k, v in ckpt.flatten(tree)]
    return ckpt.rebuild(tree, iter(leaves))


def _params(params, shardings: dict, leaf):
    """``params`` (a meta module) with every parameter replaced by
    ``leaf(parameter, its sharding)``, ``requires_grad`` kept."""
    for name, p in list(params.named_parameters()):
        mod_name, _, attr = name.rpartition(".")
        setattr(params.get_submodule(mod_name), attr, torch.nn.Parameter(
            leaf(p, shardings[name]), requires_grad=p.requires_grad))
    return params


def arguments(cfg, spec, mesh, leaf) -> tuple:
    """The arguments of a cell's step, each tensor made by ``leaf(meta
    tensor, NamedSharding)`` from the shapes of ``steps.train_state_specs``
    / ``input_specs`` / ``cache_specs`` and the shardings of
    ``steps.train_shardings`` / ``serve_shardings``: ``(state, batch)``
    for a train cell, ``(params, batch)`` for a prefill, ``(params, cache,
    batch, pos)`` for a decode, whose token goes to the cache's last row.
    Serving parameters are float32, cast at use, as the reference's."""
    from repro_torch.checkpoint import ckpt
    batch = steps.input_specs(cfg, spec)
    if spec.kind == "train":
        state_sh, batch_sh = steps.train_shardings(cfg, mesh, spec)
        state = steps.train_state_specs(cfg)
        rest = {k: v for k, v in state.items() if k != "params"}
        return ({"params": _params(state["params"], state_sh["params"],
                                   leaf),
                 **_tree(rest, {k: state_sh[k] for k in rest}, leaf)},
                _tree(batch, batch_sh, leaf))
    p_sh, c_sh, b_sh = steps.serve_shardings(cfg, mesh, spec)
    params = _params(transformer.init_params(
        cfg, torch.Generator().manual_seed(0), "meta"), p_sh, leaf)
    batch = _tree(batch, b_sh, leaf)
    if spec.kind == "prefill":
        return params, batch
    cache = steps.cache_specs(cfg, spec)
    leaves = [leaf(t, sh) for (_, t), (_, sh) in zip(ckpt.flatten(cache),
                                                     c_sh)]
    return (params, ckpt.rebuild(cache, iter(leaves)), batch,
            spec.seq_len - 1)


def lower_cell(arch: str, shape: str, multi_pod: bool = False, cfg=None,
               spec=None, mesh_shape: tuple | None = None):
    """Build one cell on the fake backend under :func:`fake_mode`:
    ``(step, args, cfg, spec, mesh)``, ``step(*args)`` the cell's step.
    ``cfg`` and ``spec`` replace the arch's config and the shape's spec,
    ``mesh_shape`` the production mesh by another ``(data, model)`` or
    ``(pod, data, model)`` shape (the tests' smoke cells and small
    meshes)."""
    cfg = cfg or get_arch(arch)
    spec = spec or SHAPES[shape]
    shape_, names, _ = MESHES[multi_pod]
    if mesh_shape is not None:
        shape_ = tuple(mesh_shape)
        names = mesh_lib.POD_AXES if len(shape_) == 3 else mesh_lib.AXES
    dev = device_type()
    mesh = make_mesh(shape_, names, dev)
    args = arguments(cfg, spec, mesh, lambda t, sh: placed(t, sh, dev))
    if spec.kind == "train":
        step = steps.make_train_step(cfg)
    elif spec.kind == "prefill":
        step = steps.make_prefill_step(cfg, max_len=spec.seq_len)
    else:
        step = steps.make_decode_step(cfg)
    return step, args, cfg, spec, mesh


def count_step(step, args, *, track_memory: bool = True):
    """``step(*args)`` once under a :class:`~repro_torch.launch.roofline.
    Counter` (inside the fake mode when ``args`` are fake); returns the
    counter."""
    counter = roofline.Counter(track_memory=track_memory)
    fake = any(_is_fake(t) for t in _local_leaves(args))
    with (fake_mode() if fake else contextlib.nullcontext()), counter:
        out = step(*args)
        del out
    return counter


def count_cell(cfg, spec, multi_pod: bool = False, *,
               mesh_shape: tuple | None = None, track_memory: bool = True,
               depth: tuple | None = None):
    """A cell's counts (``flops``, ``bytes``, ``coll``, ``kernels``,
    ``peak_bytes``) and its mesh: one trace of the config's depth, or,
    with ``depth = (a, b)``, traces at ``a`` and ``b`` superblocks (and
    the tail) extrapolated to the config's ``n_super`` (superblocks are
    identical, so each count grows by the same step a superblock: exact
    from 2 superblocks on, ``tests/test_torch_dryrun.py``)."""
    if depth is None:
        step, args, _, _, mesh = lower_cell(None, None, multi_pod, cfg=cfg,
                                            spec=spec, mesh_shape=mesh_shape)
        return count_step(step, args, track_memory=track_memory), mesh
    pattern, n_super, tail = transformer.superblock_layout(cfg)
    got = []
    for k in depth:
        step, args, _, _, mesh = lower_cell(
            None, None, multi_pod, cfg=cfg.replace(
                n_layers=k * len(pattern) + tail),
            spec=spec, mesh_shape=mesh_shape)
        got.append(count_step(step, args, track_memory=track_memory))
    (a, ca), (b, cb) = zip(depth, got)
    ex = lambda x, y: x + (y - x) * (n_super - a) // (b - a)
    merged = lambda d1, d2: {k: ex(d1.get(k, 0), d2.get(k, 0))
                             for k in set(d1) | set(d2)}
    return types.SimpleNamespace(
        flops=ex(ca.flops, cb.flops), bytes=ex(ca.bytes, cb.bytes),
        coll=merged(ca.coll, cb.coll),
        kernels=merged(ca.kernels, cb.kernels),
        peak_bytes=ex(ca.peak_bytes, cb.peak_bytes)), mesh


def _local_leaves(tree):
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves
    leaves = []
    for a in tree_leaves(tree, is_leaf=lambda x: isinstance(
            x, torch.nn.Module)):
        if isinstance(a, torch.nn.Module):
            leaves.extend(a.parameters())
        elif isinstance(a, torch.Tensor):
            leaves.append(a)
    return [t.to_local() if isinstance(t, DTensor) else t for t in leaves]


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def argument_bytes(args) -> int:
    """This rank's bytes of the step's arguments (state, cache, batch)."""
    return roofline.local_bytes(_local_leaves(args))


def run_cell(arch: str, shape: str, multi_pod: bool = False,
             with_cost: bool = True, report_dir: str = REPORT_DIR) -> dict:
    """Trace one cell and write its JSON: the reference's roofline fields,
    ``kernel_launches`` (each kernel op's launches in the step, on rank
    0), ``trace_seconds``, ``depth_extrapolated`` (the superblock counts
    traced, or None for the full depth) and the fake tensors'
    ``device_type``.  Without
    ``with_cost`` the trace only proves that the step runs on the mesh:
    the counts are taken, the peak of live bytes is not (0)."""
    t0 = time.time()
    mesh_name = MESHES[multi_pod][2]
    cfg, spec = get_arch(arch), SHAPES[shape]
    depth = EXTRAPOLATED_DEPTHS if _slow_to_trace(cfg, spec) else None
    counter, mesh = count_cell(cfg, spec, multi_pod,
                               track_memory=with_cost, depth=depth)
    chips = mesh.size()
    traced = time.time() - t0
    args = arguments(cfg, spec, mesh, shard_meta)
    terms = roofline.RooflineTerms(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=float(counter.flops) * chips,
        hlo_bytes=float(counter.bytes) * chips,
        coll_bytes=float(sum(counter.coll.values())),
        coll_breakdown=dict(counter.coll),
        model_flops=roofline.model_flops_for(cfg, spec),
        bytes_per_device=float(argument_bytes(args) + counter.peak_bytes),
    )
    out = terms.to_dict()
    out.update(kernel_launches=dict(counter.kernels), trace_seconds=traced,
               peak_traced=with_cost, depth_extrapolated=depth,
               device_type=device_type())
    os.makedirs(report_dir, exist_ok=True)
    path = os.path.join(report_dir, f"{arch}__{shape}__{mesh_name}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"--- {arch} x {shape} x {mesh_name} (trace {traced:.1f}s)")
    print(f"T_comp={terms.t_comp * 1e3:.3f}ms T_mem="
          f"{terms.t_mem * 1e3:.3f}ms T_coll={terms.t_coll * 1e3:.3f}ms "
          f"dominant={terms.dominant} useful={terms.useful_ratio:.2f} "
          f"bytes/device={terms.bytes_per_device / 2**30:.2f}GiB "
          f"kernels={dict(counter.kernels)} -> {path}", flush=True)
    return out


# RWKV-6's training backward is its plain recurrence recomputed, stepped
# token by token: at 4,096 tokens its trace takes minutes a layer on one
# CPU core, so such a cell is counted at 2 and 3 superblocks and
# extrapolated
EXTRAPOLATED_DEPTHS = (2, 3)


def _slow_to_trace(cfg, spec) -> bool:
    return spec.kind == "train" and cfg.family == "ssm"


def all_cells(include_multipod: bool = True):
    cells = []
    for arch, cfg in ARCHS.items():
        for spec in applicable_shapes(cfg.family):
            cells.append((arch, spec.name, False))
            if include_multipod:
                cells.append((arch, spec.name, True))
    return cells


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-cost", action="store_true",
                    help="trace-proof only (no peak of live bytes)")
    ap.add_argument("--report-dir", default=REPORT_DIR)
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("--arch/--shape or --all")

    failed_multi = False
    if args.mesh == "both":
        # a fake world's size is fixed: the multi-pod cells in a process
        # of their own
        which = (["--all"] if args.all
                 else ["--arch", args.arch, "--shape", args.shape])
        flags = [f for f, on in (("--skip-existing", args.skip_existing),
                                 ("--no-cost", args.no_cost)) if on]
        proc = subprocess.run([sys.executable, "-m",
                               "repro_torch.launch.dryrun", *which,
                               "--mesh", "multi", "--report-dir",
                               args.report_dir, *flags])
        args.mesh = "single"
        failed_multi = proc.returncode != 0
    multi = args.mesh == "multi"
    if args.all:
        cells = [(a, s, multi) for a, s, _ in all_cells(False)]
    else:
        cells = [(args.arch, args.shape, multi)]

    failures = []
    for arch, shape, mp in cells:
        mesh_name = MESHES[mp][2]
        path = os.path.join(args.report_dir,
                            f"{arch}__{shape}__{mesh_name}.json")
        if args.skip_existing and os.path.exists(path):
            print(f"skip {arch} x {shape} x {mesh_name} (cached)")
            continue
        try:
            run_cell(arch, shape, mp, with_cost=not args.no_cost,
                     report_dir=args.report_dir)
        except Exception as e:  # noqa: BLE001 -- report and continue
            traceback.print_exc()
            failures.append((arch, shape, mesh_name, str(e)))
    if failures or failed_multi:
        print(f"\n{len(failures)} FAILURES"
              + (" (and the multi-pod process failed)" if failed_multi
                 else "") + ":")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("\nall requested dry-run cells traced OK")


if __name__ == "__main__":
    main()
