"""The optimizers, the launcher, the data pipeline, the autotuner and the
checkpoints under a (data, model) mesh, on 4 gloo ranks on the CPU (a
``FileStore`` under ``tmp_path``).

* Two train steps on a placed state against the same two steps of the
  port's single-process step, at (2, 2), (4, 1) and (1, 4): AdamW
  (Qwen3's smoke config), int8 error-feedback compression (Qwen3), and
  Adafactor (arctic, whose state is replicated).  Bounds,
  ``tests/test_torch_train.py``'s: the losses within 1e-5 and the
  gradient norm within 1e-6 relative (measured on the CPU: 9.5e-7 and
  1.2e-7), the parameters and optimizer state within 1e-5 of max(|x|,
  1e-2) of each leaf (4.4e-7; a zero-initialised norm has moved ~1e-6).
  Under compression a gradient within its float32 gap of a rounding
  boundary rounds to the next int8 level, so there the moments are held
  within one level, 1/127 of the leaf's largest magnitude (1.3e-3), and
  the residuals within one quantization step, twice their largest
  magnitude (0.93, at (1, 4)).
* ``launch.train.run`` at 2 x 2: each rank builds only its rows, the
  step-1 loss is the single-process step's on the rows of both hosts
  stacked (within 1e-5); a run killed in step 3 and resumed from its
  step-2 checkpoint ends bitwise as an uninterrupted one.
* ``PrefetchIterator(sharding=)`` hands each rank its host's rows as the
  pieces of the global batch; ``MemoryModeOrchestrator(cfg, spec, mesh)``
  steps a placed state through each of its arms.
* A checkpoint saved at (2, 2) restores resharded at (4, 1) and (1, 4),
  every leaf equal.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.launch import mesh as mesh_lib

MESHES = ((2, 2), (4, 1), (1, 4))
SEQ, BATCH = 16, 4
LOSS_TOL, NORM_TOL, STATE_TOL = 1e-5, 1e-6, 1e-5
LEVEL_TOL = 1.0 / 127.0   # one int8 level of a gradient block
EF_TOL = 2.0              # one quantization step: twice the largest |r|
CASES = (("qwen3-8b", False), ("qwen3-8b", True), ("arctic-480b", False))


def _rel(a, b, floor: float = 1e-2) -> float:
    a, b = a.detach().float(), b.detach().float()
    if a.numel() == 0:
        return 0.0
    return float((a - b).abs().max() / b.abs().max().clamp_min(floor))


def _tensors(tree, prefix=""):
    from repro_torch.checkpoint import ckpt
    return {k: v for k, v in ckpt.flatten(tree) if torch.is_tensor(v)}


def _whole(x):
    from repro_torch.distributed import sharding as shd
    return x.full_tensor() if shd.is_dtensor(x) else x


def _steps_case(cfg, compress, mesh):
    """Two steps placed on ``mesh`` and two plain; the largest errors."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data.synthetic import DataConfig, host_batch
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.optim import compress as comp

    def state():
        s = steps.make_train_state(cfg, 0, "cpu")
        if compress:
            s["ef"] = comp.init_ef(dict(s["params"].named_parameters()))
        return s

    state_sh, batch_sh = steps.train_shardings(
        cfg, mesh, ShapeSpec("t", "train", SEQ, BATCH), grad_compress=compress)
    plain, placed = state(), steps.place_state(state(), state_sh)
    f0 = steps.make_train_step(cfg, grad_compress=compress)
    f1 = steps.make_train_step(cfg, grad_compress=compress)
    err = dict(loss=0.0, norm=0.0)
    for i in range(2):
        b = {k: torch.from_numpy(v) for k, v in
             host_batch(cfg, DataConfig(SEQ, BATCH, seed=0), i).items()}
        plain, m0 = f0(plain, b)
        placed, m1 = f1(placed, shd.place(b, batch_sh))
        err["loss"] = max(err["loss"], abs(float(m1["loss"])
                                           - float(m0["loss"])))
        if "grad_norm" in m0:
            err["norm"] = max(err["norm"], abs(
                float(m1["grad_norm"]) / float(m0["grad_norm"]) - 1))
    want = _tensors(steps.state_tree(plain))
    got = _tensors(steps.state_tree(placed))
    assert set(want) == set(got)
    for part in ("params", "opt", "ef"):
        keys = [k for k in want if k.startswith(part + ".")]
        floor = 1e-2 if part == "params" or not compress else 1e-30
        err[part] = max((_rel(_whole(got[k]), want[k], floor)
                         for k in keys), default=0.0)
    return err


def _rank_steps(rank, world, out_path):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import smoke_config
    results = {}
    for shape in MESHES:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data",
                                                              "model"))
        for arch, compress in CASES:
            key = f"{arch}{'-compress' if compress else ''}"
            results.setdefault(key, {})[f"{shape[0]}x{shape[1]}"] = (
                _steps_case(smoke_config(arch), compress, mesh))
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(results, f)


@pytest.fixture(scope="module")
def step_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_optim")
    out = str(tmp / "results.json")
    mesh_lib.spawn_ranks(_rank_steps, 4, str(tmp), out)
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("mesh", [f"{a}x{b}" for a, b in MESHES])
@pytest.mark.parametrize("case", ["qwen3-8b", "qwen3-8b-compress",
                                  "arctic-480b"])
def test_two_steps_equal_single_process_steps(step_results, case, mesh):
    r = step_results[case][mesh]
    assert r["loss"] <= LOSS_TOL, r
    assert r["norm"] <= NORM_TOL, r
    assert r["params"] <= STATE_TOL, r
    compressed = case.endswith("-compress")
    assert r["opt"] <= (LEVEL_TOL if compressed else STATE_TOL), r
    assert r["ef"] <= EF_TOL, r


# ------------------------------------------------ launcher, data, autotune
def _rank_launcher(rank, world, work, out_path):
    import torch.distributed as dist
    from repro_torch.configs import smoke_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.core.autotune import MODES, MemoryModeOrchestrator
    from repro_torch.data.pipeline import PrefetchIterator
    from repro_torch.data.synthetic import (DataConfig, batch_iterator,
                                            host_batch)
    from repro_torch.launch import steps, train

    cfg = smoke_config("qwen3-8b")
    out = {}
    # step 1 of the launcher at 2 x 2 against the plain step on the rows
    # of both hosts stacked
    got = train.run(cfg, steps=1, batch=BATCH, seq=SEQ, log_every=100,
                    device="cpu", data_mesh=2, model_mesh=2)
    mesh = got["mesh"]
    rows = [host_batch(cfg, DataConfig(SEQ, BATCH), 0, h, 2)
            for h in range(2)]
    whole = {k: torch.from_numpy(np.concatenate([r[k] for r in rows]))
             for k in rows[0]}
    _, m = steps.make_train_step(cfg, total_steps=1)(
        steps.make_train_state(cfg, 0, "cpu"), whole)
    out["launcher_loss_err"] = abs(got["losses"][0] - float(m["loss"]))

    # the data pipeline hands each rank its host's rows
    _, batch_sh = steps.train_shardings(cfg, mesh,
                                        ShapeSpec("t", "train", SEQ, BATCH))
    host, n_hosts = train.data_rows(mesh)
    it = PrefetchIterator(batch_iterator(cfg, DataConfig(SEQ, BATCH),
                                         host=host, n_hosts=n_hosts),
                          sharding=batch_sh)
    b = next(it)
    mine = host_batch(cfg, DataConfig(SEQ, BATCH), 0, host, n_hosts)
    out["prefetch_rows_ok"] = all(
        np.array_equal(b[k].to_local().numpy(), mine[k]) for k in mine)
    out["prefetch_whole_ok"] = np.array_equal(
        b["tokens"].full_tensor().numpy(), whole["tokens"].numpy())

    # the autotuner's arms on a placed state
    state_sh, _ = steps.train_shardings(cfg, mesh,
                                        ShapeSpec("t", "train", SEQ, BATCH))
    orch = MemoryModeOrchestrator(cfg, ShapeSpec("t", "train", SEQ, BATCH),
                                  mesh, seed=0, total_steps=8)
    state = steps.place_state(steps.make_train_state(cfg, 0, "cpu"),
                              state_sh)
    losses = {}
    for mode in MODES:
        state, metrics = orch._variants[mode](state, b)
        losses[mode] = float(metrics["loss"])
    out["autotune_losses"] = losses

    # killed in step 3, resumed from step 2: bitwise the uninterrupted run
    args = dict(steps=4, batch=BATCH, seq=SEQ, ckpt_every=2, log_every=100,
                device="cpu", data_mesh=2, model_mesh=2)
    whole_run = train.run(cfg, ckpt_dir=os.path.join(work, "whole"),
                          **args)["losses"]
    real = steps.make_train_step

    class Killed(Exception):
        pass

    def dying(*a, **kw):
        step, calls = real(*a, **kw), [0]

        def run_(*s):
            calls[0] += 1
            if calls[0] == 3:
                raise Killed()
            return step(*s)
        return run_

    # the killed run writes its checkpoints before it goes on
    real_manager = train.CheckpointManager
    train.steps_lib.make_train_step = dying
    train.CheckpointManager = lambda d, keep: real_manager(
        d, keep, async_write=False)
    try:
        train.run(cfg, ckpt_dir=os.path.join(work, "cut"), **args)
        out["killed"] = False
    except Killed:
        out["killed"] = True
    finally:
        train.steps_lib.make_train_step = real
        train.CheckpointManager = real_manager
    dist.barrier()
    resumed = train.run(cfg, ckpt_dir=os.path.join(work, "cut"),
                        resume=True, **args)
    out["resume"] = dict(start=resumed["start_step"],
                         equal=resumed["losses"] == whole_run[2:])
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(out, f)


@pytest.fixture(scope="module")
def launcher_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_launcher")
    out = str(tmp / "results.json")
    mesh_lib.spawn_ranks(_rank_launcher, 4, str(tmp), str(tmp), out)
    with open(out) as f:
        return json.load(f)


def test_launcher_step_equals_single_process_step(launcher_results):
    assert launcher_results["launcher_loss_err"] <= LOSS_TOL


def test_prefetch_places_each_hosts_rows(launcher_results):
    assert launcher_results["prefetch_rows_ok"]
    assert launcher_results["prefetch_whole_ok"]


def test_autotuner_arms_step_a_placed_state(launcher_results):
    losses = launcher_results["autotune_losses"]
    assert sorted(losses) == sorted(["remat_none", "remat_dots",
                                     "remat_full", "microbatch2"])
    assert all(np.isfinite(v) for v in losses.values())


def test_launcher_resumes_bitwise_on_the_mesh(launcher_results):
    assert launcher_results["killed"]
    assert launcher_results["resume"] == {"start": 2, "equal": True}


# ------------------------------------------------------------ checkpoints
def _rank_reshard(rank, world, work, out_path):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import smoke_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import steps

    cfg = smoke_config("granite-moe-3b-a800m")
    spec = ShapeSpec("t", "train", SEQ, BATCH)
    meshes = {s: init_device_mesh("cpu", s, mesh_dim_names=("data",
                                                            "model"))
              for s in MESHES}
    plain = steps.state_tree(steps.make_train_state(cfg, 0, "cpu"))
    sh22 = steps.train_shardings(cfg, meshes[(2, 2)], spec)[0]
    from repro_torch.distributed import sharding as shd
    placed = shd.place(plain, sh22)
    path = os.path.join(work, "ck")
    ckpt.save(path, placed)
    out = {}
    for s in ((4, 1), (1, 4)):
        sh = steps.train_shardings(cfg, meshes[s], spec)[0]
        back = ckpt.restore(path, placed, shardings=sh)
        want = _tensors(plain)
        got = _tensors(back)
        same = all(torch.equal(_whole(got[k]), want[k]) for k in want)
        moved = all(tuple(got[k].placements) == sh_leaf.placements()
                    for k, sh_leaf in ckpt.flatten(sh)
                    if shd.is_dtensor(got.get(k)))
        out[f"{s[0]}x{s[1]}"] = dict(equal=same, placed=moved,
                                     leaves=len(want))
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(out, f)


def test_checkpoint_saved_on_one_mesh_restores_on_another(tmp_path):
    out = str(tmp_path / "results.json")
    mesh_lib.spawn_ranks(_rank_reshard, 4, str(tmp_path), str(tmp_path),
                         out)
    with open(out) as f:
        res = json.load(f)
    for mesh in ("4x1", "1x4"):
        assert res[mesh]["leaves"] > 0
        assert res[mesh]["equal"], res
        assert res[mesh]["placed"], res
