"""End-to-end training driver (``repro.launch.train``).

A training loop on the card (or the CPU with ``--device cpu``): the
synthetic data pipeline with prefetch, the train step, asynchronous
checkpoints with retention and resume, straggler bookkeeping, optional
Cohmeleon memory-mode autotuning (``--autotune``) and int8
error-feedback gradient compression (``--compress``).  With
``--data-mesh``/``--model-mesh`` the step runs as a DTensor program on a
(data, model) mesh (:mod:`repro_torch.launch.steps`): at 1 x 1 in this
process, on a group of one rank; above that one process a rank under
``torch.distributed.run``, each rank building only its own rows of the
batch.  Without them the step runs on plain tensors, as it always has.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \
        --smoke --device cpu --steps 20
    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 4 -m repro_torch.launch.train --arch qwen3-8b \
        --smoke --device cpu --steps 4 --data-mesh 2 --model-mesh 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-vl-2b \
        --steps 6 --batch 4 --seq 2048 --log-every 1
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \
        --smoke --steps 200 --autotune
"""
from __future__ import annotations

import argparse
import time

from repro_torch import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_arch, smoke_config
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.data.pipeline import PrefetchIterator
from repro_torch.data.synthetic import DataConfig, batch_iterator
from repro_torch.distributed.fault import StragglerDetector
from repro_torch.launch import steps as steps_lib


def run(cfg: ArchConfig, *, steps: int, batch: int, seq: int,
        ckpt_dir: str | None = None, ckpt_every: int = 50,
        resume: bool = False, compress: bool = False,
        autotune: bool = False, log_every: int = 10, device=None,
        timed: bool = False, grads_hook=None,
        data_mesh: int | None = None, model_mesh: int | None = None) -> dict:
    """The training loop; returns ``losses`` per step run, with AdamW
    ``grad_norms`` (before clipping), ``step_s`` (each step's seconds,
    after a synchronize on the card), with
    ``timed`` each step's ``phases`` (forward, backward, optimizer), the
    ``start_step`` and, with ``autotune``, the ``decisions``.
    ``grads_hook`` is passed to each (unautotuned) step.  With
    ``data_mesh``/``model_mesh`` (either given) the state is built on
    every rank from the same seed, then placed by ``train_shardings`` on a
    :func:`~repro_torch.launch.mesh.make_host_mesh` of that shape, and
    ``out["mesh"]`` is the mesh; metrics are the global values."""
    spec = ShapeSpec("cli", "train", seq, batch)
    mesh = None
    if data_mesh or model_mesh:
        from repro_torch.launch import mesh as mesh_lib
        mesh = mesh_lib.make_host_mesh(data_mesh or 1, model_mesh or 1,
                                       device)
        dev = mesh_lib.mesh_device(mesh)
    else:
        dev = resolve_device(device)
    state = steps_lib.make_train_state(cfg, 0, dev)
    if compress:
        from repro_torch.optim import compress as compress_lib
        state["ef"] = compress_lib.init_ef(dict(
            state["params"].named_parameters()))
    state_sh = batch_sh = None
    host, n_hosts = 0, 1
    if mesh is not None:
        state_sh, batch_sh = steps_lib.train_shardings(
            cfg, mesh, spec, grad_compress=compress)
        state = steps_lib.place_state(state, state_sh)
        host, n_hosts = data_rows(mesh)

    manager = None
    start_step = 0
    if ckpt_dir:
        manager = CheckpointManager(ckpt_dir, keep=3)
        if resume and manager.latest_step() is not None:
            start_step = manager.latest_step()
            state = steps_lib.load_state_tree(
                state, manager.restore(steps_lib.state_tree(state),
                                       shardings=state_sh))
            print(f"resumed from step {start_step}")

    if autotune:
        from repro_torch.core.autotune import MemoryModeOrchestrator
        orch = MemoryModeOrchestrator(cfg, spec, mesh, seed=0,
                                      total_steps=steps)
    else:
        step_fn = steps_lib.make_train_step(cfg, grad_compress=compress,
                                            total_steps=steps)

    data = PrefetchIterator(
        batch_iterator(cfg, DataConfig(seq, batch), host=host,
                       n_hosts=n_hosts, start_step=start_step),
        depth=2, device=dev, sharding=batch_sh)
    straggler = StragglerDetector()

    out = {"losses": [], "grad_norms": [], "step_s": [], "phases": [],
           "start_step": start_step, "mesh": mesh}
    losses = out["losses"]
    t_start = time.time()
    for step in range(start_step, steps):
        b = next(data)
        t0 = time.time()
        if autotune:
            state, metrics = orch.step(state, b)
        else:
            phases = {} if timed else None
            state, metrics = step_fn(state, b, phases, grads_hook)
            if timed:
                out["phases"].append(phases)
        losses.append(float(metrics["loss"]))
        if "grad_norm" in metrics:
            out["grad_norms"].append(float(metrics["grad_norm"]))
        dt = time.time() - t0
        out["step_s"].append(dt)
        straggler.record(0, dt)
        if (step + 1) % log_every == 0:
            print(f"step {step + 1:5d} loss {losses[-1]:.4f} "
                  f"({dt * 1e3:.0f} ms/step)")
        if manager and (step + 1) % ckpt_every == 0:
            manager.save(step + 1, steps_lib.state_tree(state))
    if manager:
        manager.save(steps, steps_lib.state_tree(state))
        manager.wait()

    wall = time.time() - t_start
    print(f"done: {steps - start_step} steps in {wall:.1f}s; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if autotune:
        out["decisions"] = orch.decision_counts()
        print("autotune decisions:", out["decisions"])
    return out


def data_rows(mesh) -> tuple:
    """``(host, n_hosts)`` of this rank's rows of the global batch: its
    place along the batch's (pod, data) axes; ranks that differ only
    along model build the same rows."""
    names = list(mesh.mesh_dim_names)
    host, n_hosts = 0, 1
    for axis in ("pod", "data"):
        if axis in names:
            i = names.index(axis)
            host = host * mesh.size(i) + mesh.get_local_rank(i)
            n_hosts *= mesh.size(i)
    return host, n_hosts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress", action="store_true",
                    help="int8 + error-feedback gradient compression")
    ap.add_argument("--autotune", action="store_true",
                    help="Cohmeleon Q-learning over memory modes")
    ap.add_argument("--data-mesh", type=int, default=None,
                    help="ranks along the mesh's data axis (FSDP and data "
                         "parallel); with --model-mesh, the step runs on "
                         "a mesh")
    ap.add_argument("--model-mesh", type=int, default=None,
                    help="ranks along the mesh's model axis (tensor and "
                         "expert parallel)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    cfg = smoke_config(args.arch) if args.smoke else get_arch(args.arch)
    return run(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
               ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
               resume=args.resume, compress=args.compress,
               autotune=args.autotune, log_every=args.log_every,
               device=args.device, data_mesh=args.data_mesh,
               model_mesh=args.model_mesh)["losses"]


if __name__ == "__main__":
    main()
