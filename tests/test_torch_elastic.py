"""``repro_torch.distributed.fault.ElasticRunner`` and resharded restores
(``tests/test_checkpoint_fault.py``'s two elastic tests, mirrored), then
elastic training: Qwen3's smoke config on a (2, 2) mesh of 4 gloo ranks
(a ``FileStore`` under ``tmp_path``), a checkpoint every 2 steps and a
failure injected at step 5; the 2 surviving ranks form a (2, 1) mesh,
restore step 4 resharded onto it and run steps 5-8.  Held against an
uninterrupted (2, 2) run of the same 8 steps: the parameters within 1e-5
of max(|p|, 1e-2) of each leaf (measured on the CPU: 1.8e-7; steps 5-8
sum their partial gradients over another mesh), the recovery counted
once and the step count 8."""
import json
import os

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.distributed.fault import ElasticRunner
from repro_torch.launch import mesh as mesh_lib

SEQ, BATCH, STEPS, FAIL_AT, EVERY = 16, 4, 8, 5, 2
PARAM_TOL = 1e-5


def test_elastic_runner_recovers_from_injected_failure(tmp_path):
    """Full loop: train, checkpoint, inject node loss, re-mesh, resume."""
    mgr = CheckpointManager(str(tmp_path), keep=3, async_write=False)

    def build(devices):
        return (lambda state: {"x": state["x"] + 1.0}), None

    runner = ElasticRunner(build, mgr, ckpt_every=5)
    final, step = runner.run({"x": torch.tensor(0.0)}, n_steps=20,
                             devices=["cpu"], inject_failure_at=12,
                             surviving_devices=["cpu"])
    assert runner.recoveries == 1
    assert step == 20
    # after recovery we resumed from step 10's checkpoint and re-ran
    assert float(final["x"]) == 20.0


def _rank_reshard(rank, world, path, out_path):
    from repro_torch.distributed import sharding as shd
    rows = mesh_lib.make_mesh(range(world), (world,), ("data",))
    cols = mesh_lib.make_mesh(range(world), (world,), ("model",))
    full = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    t = {"w": shd.NamedSharding(rows, ("data",)).place(full)}
    ckpt.save(path, t)
    back = ckpt.restore(path, t, {"w": shd.NamedSharding(cols,
                                                         (None, "model"))})
    w, n = back["w"], 4 // world
    ok = (torch.equal(w.full_tensor(), full)
          and torch.equal(w.to_local(), full[:, rank * n:(rank + 1) * n]))
    res = [None] * world
    torch.distributed.all_gather_object(res, bool(ok))
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)


def test_elastic_restore_across_meshes(tmp_path):
    """Save under one mesh (rows split over "data"), restore under another
    (columns split over "model"): each rank holds its columns."""
    out = str(tmp_path / "res.json")
    mesh_lib.spawn_ranks(_rank_reshard, 2, str(tmp_path),
                         str(tmp_path / "s"), out)
    with open(out) as f:
        assert json.load(f) == [True, True]


# ------------------------------------------------------ elastic training
def _trainer(cfg, spec):
    """``build(ranks)`` for the runner: a (2, 2) mesh over 4 ranks, a
    (2, 1) over 2; the step reads its batch by the optimizer's step."""
    from repro_torch.data.synthetic import DataConfig, host_batch
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps

    def build(ranks):
        ranks = list(ranks)
        shape = (2, 2) if len(ranks) == 4 else (2, 1)
        mesh = mesh_lib.make_mesh(ranks, shape)
        if mesh.get_coordinate() is None:
            return None, None
        state_sh, batch_sh = steps.train_shardings(cfg, mesh, spec)
        holder = steps.place_state(steps.make_train_state(cfg, 0, "cpu"),
                                   state_sh)
        train_step = steps.make_train_step(cfg, total_steps=STEPS)

        def step_fn(tree):
            state = steps.load_state_tree(holder, tree)
            i = int(tree["opt"].step)
            b = {k: torch.from_numpy(v) for k, v in host_batch(
                cfg, DataConfig(SEQ, BATCH), i).items()}
            state, _ = train_step(state, shd.place(b, batch_sh))
            return steps.state_tree(state)

        return step_fn, state_sh

    return build


def _rank_elastic(rank, world, work, out_path):
    from repro_torch.configs import smoke_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import steps

    cfg = smoke_config("qwen3-8b")
    spec = ShapeSpec("t", "train", SEQ, BATCH)
    build = _trainer(cfg, spec)
    start = lambda: steps.state_tree(steps.make_train_state(cfg, 0, "cpu"))

    whole = ElasticRunner(build, CheckpointManager(
        os.path.join(work, "whole"), keep=3, async_write=False),
        ckpt_every=EVERY)
    w_state, w_step = whole.run(start(), STEPS, devices=range(4))
    want = {k: v.full_tensor() for k, v in w_state["params"].items()}

    runner = ElasticRunner(build, CheckpointManager(
        os.path.join(work, "cut"), keep=3, async_write=False),
        ckpt_every=EVERY)
    state, step = runner.run(start(), STEPS, devices=range(4),
                             inject_failure_at=FAIL_AT,
                             surviving_devices=[0, 1])
    if state is None:           # a lost rank: it left at the failure
        return
    err = max(float((state["params"][k].full_tensor() - w).abs().max()
                    / w.abs().max().clamp_min(1e-2))
              for k, w in want.items() if w.numel())
    shapes = {tuple(v.device_mesh.shape) for v in state["params"].values()}
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(dict(err=err, step=step, whole_step=w_step,
                           recoveries=runner.recoveries,
                           meshes=sorted(shapes),
                           opt_step=int(state["opt"].step)), f)


def test_elastic_training_resumes_on_the_survivors(tmp_path):
    out = str(tmp_path / "res.json")
    mesh_lib.spawn_ranks(_rank_elastic, 4, str(tmp_path), str(tmp_path),
                         out)
    with open(out) as f:
        r = json.load(f)
    assert r["recoveries"] == 1
    assert r["step"] == r["whole_step"] == STEPS
    assert r["opt_step"] == STEPS
    assert r["meshes"] == [[2, 1]]
    assert r["err"] <= PARAM_TOL, r
    assert np.isfinite(r["err"])
