"""Which process groups carry a DTensor program on a machine with one card.

NCCL refuses two ranks on one device, so a mesh of two ranks on one card
could only run over gloo.  This probe starts two ranks on ``cuda:0``
over gloo (a ``FileStore`` in a temporary directory) and tries, on CUDA
tensors, each collective DTensor issues: ``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_reduce`` and ``batch_isend_irecv``, each
value checked; then a DTensor round trip on a (2, 1) and a (1, 2) mesh
(distribute, a product with a model-split weight, a partial sum
reduce-scattered, ``full_tensor``).  Last, in this process, a one-rank
NCCL group: the same DTensor round trip on a (1, 1) mesh.  Prints one
JSON object.

    python -m benchmarks.torch_mesh_probe
"""
from __future__ import annotations

import datetime
import json
import os
import sys
import tempfile
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 2


def _try(out: dict, name: str, fn, log: str | None = None) -> None:
    """Run ``fn`` and record ``ok`` or its error under ``name``; with
    ``log``, the outcomes so far are written there first, the step
    marked as started, so a collective that aborts the process (gloo
    handed device memory does) leaves its name behind."""
    if log is not None:
        with open(log, "w") as f:
            json.dump({**out, name: "started; the process died in it"}, f)
    try:
        fn()
        out[name] = "ok"
    except Exception as e:  # each outcome is the probe's result
        out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:300]}"
    if log is not None:
        with open(log, "w") as f:
            json.dump(out, f)


def _collectives(rank: int, dev: torch.device, out: dict, log) -> None:
    def gather():
        t = torch.full((4,), float(rank), device=dev)
        o = torch.empty(4 * WORLD, device=dev)
        dist.all_gather_into_tensor(o, t)
        want = torch.arange(WORLD, device=dev).repeat_interleave(4).float()
        assert torch.equal(o, want), o

    def scatter():
        t = torch.arange(4 * WORLD, device=dev, dtype=torch.float32)
        o = torch.empty(4, device=dev)
        dist.reduce_scatter_tensor(o, t)
        want = WORLD * torch.arange(4 * rank, 4 * rank + 4, device=dev)
        assert torch.equal(o, want.float()), o

    def reduce():
        t = torch.full((8,), rank + 1.0, device=dev)
        dist.all_reduce(t)
        assert torch.equal(t, torch.full_like(t, WORLD * (WORLD + 1) / 2))

    def p2p():
        peer = (rank + 1) % WORLD
        src = (rank - 1) % WORLD
        send = torch.full((8,), float(rank), device=dev)
        recv = torch.empty(8, device=dev)
        ops = [dist.P2POp(dist.isend, send, peer),
               dist.P2POp(dist.irecv, recv, src)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        assert torch.equal(recv, torch.full_like(recv, float(src)))

    for name, fn in (("all_gather_into_tensor", gather),
                     ("reduce_scatter_tensor", scatter),
                     ("all_reduce", reduce),
                     ("batch_isend_irecv", p2p)):
        _try(out, name, fn, log)
        torch.cuda.synchronize(dev)


def _dtensor_round_trip(mesh, dev: torch.device) -> None:
    """distribute, a product with a model-split weight, the partial sum
    reduce-scattered over data, and the full value against one device's."""
    from torch.distributed.tensor import (Partial, Replicate, Shard,
                                          distribute_tensor)
    gen = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn(8, 16, generator=gen).to(dev)
    w = torch.randn(16, 32, generator=gen).to(dev)
    data = [Shard(0), Replicate()]
    dx = distribute_tensor(x, mesh, data, src_data_rank=None)
    dw = distribute_tensor(w, mesh, [Replicate(), Shard(1)],
                           src_data_rank=None)
    y = dx @ dw
    got = y.full_tensor()
    assert torch.allclose(got, x @ w, rtol=1e-5, atol=1e-5)
    s = (dx * 2).sum(0, keepdim=True)           # partial over data
    s = s.redistribute(mesh, [Replicate(), Replicate()])
    assert torch.allclose(s.full_tensor(), (x * 2).sum(0, keepdim=True),
                          rtol=1e-5, atol=1e-5)
    part = distribute_tensor(x, mesh, [Partial(), Replicate()],
                             src_data_rank=None)
    rs = part.redistribute(mesh, [Shard(0), Replicate()])
    assert torch.allclose(rs.full_tensor(), x * mesh.size(0))
    torch.cuda.synchronize(dev)


def _rank(rank: int, store_path: str, result_path: str) -> None:
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out: dict = {}
    log = result_path if rank == 0 else None
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
            world_size=WORLD, timeout=datetime.timedelta(seconds=60))
        _collectives(rank, dev, out, log)
        from torch.distributed.device_mesh import init_device_mesh
        for shape in ((2, 1), (1, 2)):
            _try(out, f"dtensor_{shape[0]}x{shape[1]}",
                 lambda: _dtensor_round_trip(init_device_mesh(
                     "cuda", shape, mesh_dim_names=("data", "model")), dev),
                 log)
        dist.destroy_process_group()
    except Exception:
        out["setup"] = traceback.format_exc()[-1000:]
        if log is not None:
            with open(log, "w") as f:
                json.dump(out, f)


def probe() -> dict:
    """The two-rank gloo results (a step the processes died in is named
    so, the later ones are absent) and the one-rank NCCL round trip."""
    with tempfile.TemporaryDirectory() as tmp:
        result = os.path.join(tmp, "result.json")
        procs = [mp.get_context("spawn").Process(
            target=_rank, args=(r, os.path.join(tmp, "store"), result))
            for r in range(WORLD)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=240)
            if p.is_alive():
                p.kill()
                p.join()
        gloo = {}
        if os.path.exists(result):
            with open(result) as f:
                gloo = json.load(f)
        gloo["exit_codes"] = [p.exitcode for p in procs]
        out = {"gloo_two_ranks_one_card": gloo}
    one: dict = {}
    from repro_torch.launch import mesh as mesh_lib
    fresh = not dist.is_initialized()
    _try(one, "dtensor_1x1", lambda: _dtensor_round_trip(
        mesh_lib.make_host_mesh(1, 1), torch.device("cuda", 0)))
    if fresh and dist.is_initialized():
        dist.destroy_process_group()
    out["nccl_one_rank"] = one
    names = ("all_gather_into_tensor", "reduce_scatter_tensor",
             "all_reduce", "batch_isend_irecv", "dtensor_2x1", "dtensor_1x2")
    out["two_ranks_on_one_card"] = (all(gloo.get(n) == "ok" for n in names)
                                    and gloo["exit_codes"] == [0] * WORLD)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(json.dumps(probe()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
