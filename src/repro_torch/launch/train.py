"""End-to-end training driver (``repro.launch.train``).

A training loop on the card (or the CPU with ``--device cpu``): the
synthetic data pipeline with prefetch, the train step, asynchronous
checkpoints with retention and resume, straggler bookkeeping, optional
Cohmeleon memory-mode autotuning (``--autotune``) and int8
error-feedback gradient compression (``--compress``).  The reference's
``--data-mesh``/``--model-mesh`` are not ported yet.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \
        --smoke --device cpu --steps 20
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
        timed: bool = False, grads_hook=None) -> dict:
    """The training loop; returns ``losses`` per step run, with AdamW
    ``grad_norms`` (before clipping), ``step_s`` (each step's seconds,
    after a synchronize on the card), with
    ``timed`` each step's ``phases`` (forward, backward, optimizer), the
    ``start_step`` and, with ``autotune``, the ``decisions``.
    ``grads_hook`` is passed to each (unautotuned) step."""
    spec = ShapeSpec("cli", "train", seq, batch)
    dev = resolve_device(device)
    state = steps_lib.make_train_state(cfg, 0, dev)
    if compress:
        from repro_torch.optim import compress as compress_lib
        state["ef"] = compress_lib.init_ef(dict(
            state["params"].named_parameters()))

    manager = None
    start_step = 0
    if ckpt_dir:
        manager = CheckpointManager(ckpt_dir, keep=3)
        if resume and manager.latest_step() is not None:
            start_step = manager.latest_step()
            state = steps_lib.load_state_tree(
                state, manager.restore(steps_lib.state_tree(state)))
            print(f"resumed from step {start_step}")

    if autotune:
        from repro_torch.core.autotune import MemoryModeOrchestrator
        orch = MemoryModeOrchestrator(cfg, spec, seed=0, total_steps=steps)
    else:
        step_fn = steps_lib.make_train_step(cfg, grad_compress=compress,
                                            total_steps=steps)

    data = PrefetchIterator(
        batch_iterator(cfg, DataConfig(seq, batch), start_step=start_step),
        depth=2, device=dev)
    straggler = StragglerDetector()

    out = {"losses": [], "grad_norms": [], "step_s": [], "phases": [],
           "start_step": start_step}
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
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    cfg = smoke_config(args.arch) if args.smoke else get_arch(args.arch)
    return run(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
               ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
               resume=args.resume, compress=args.compress,
               autotune=args.autotune, log_every=args.log_every,
               device=args.device)["losses"]


if __name__ == "__main__":
    main()
