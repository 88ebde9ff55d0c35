"""The collectives one train step issues under a (data, model) mesh, by
kind, counted with DTensor's ``CommDebugMode`` (counts, not times).

Runs 4 gloo ranks on the CPU (a ``FileStore`` in a temporary directory)
and, for each smoke config and mesh named, one warm-up step and then one
counted step of ``launch.steps.make_train_step`` on a state placed by
``train_shardings`` (a batch of 4 x 16 tokens).  Prints one JSON object:
``{config: {mesh: {collective: count}}}``.

    PYTHONPATH=src python -m benchmarks.torch_mesh_collectives \\
        [--arch qwen3-8b,granite-moe-3b-a800m] [--mesh 2x2,4x1,1x4]
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

SEQ, BATCH = 16, 4


def _rank(rank, world, archs, meshes, out_path):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.configs import smoke_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data.synthetic import DataConfig, host_batch
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps

    out: dict = {}
    for shape in meshes:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data",
                                                              "model"))
        for arch in archs:
            cfg = smoke_config(arch)
            state_sh, batch_sh = steps.train_shardings(
                cfg, mesh, ShapeSpec("t", "train", SEQ, BATCH))
            state = steps.place_state(steps.make_train_state(cfg, 0, "cpu"),
                                      state_sh)
            step = steps.make_train_step(cfg)
            batch = shd.place({k: torch.from_numpy(v) for k, v in host_batch(
                cfg, DataConfig(SEQ, BATCH), 0).items()}, batch_sh)
            state, _ = step(state, batch)
            with CommDebugMode() as comm:
                state, _ = step(state, batch)
            counts = {str(k).split(".")[-1]: v
                      for k, v in comm.get_comm_counts().items()}
            out.setdefault(arch, {})[f"{shape[0]}x{shape[1]}"] = counts
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(out, f)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b,granite-moe-3b-a800m")
    ap.add_argument("--mesh", default="2x2,4x1,1x4")
    args = ap.parse_args(argv)
    from repro_torch.launch import mesh as mesh_lib
    meshes = tuple(tuple(int(x) for x in m.split("x"))
                   for m in args.mesh.split(","))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out.json")
        mesh_lib.spawn_ranks(_rank, 4, tmp, tuple(args.arch.split(",")),
                             meshes, out)
        with open(out) as f:
            result = json.load(f)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
