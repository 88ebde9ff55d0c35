"""The train step under a (data, model) mesh, a DTensor program on 4 gloo
ranks on the CPU (a ``FileStore`` under ``tmp_path``), at (2, 2), (4, 1)
and (1, 4), against the reference's single-device ``loss_fn`` and
``jax.value_and_grad``: the step-1 loss, cross-entropy and MoE auxiliary
loss, and every gradient leaf (the port's per-layer gradients, gathered
whole, stacked into the reference's leaves by ``models/convert.py``),
from the reference's parameters moved by 0.02 N(0, 1) from a seed, on a
batch of 4 x 16 tokens.  The state is placed by ``train_shardings`` and
each rank's local shard of every parameter must have the shape its spec
gives (a replicate-everything shortcut fails there).

Bounds, ``tests/test_torch_train_archs.py``'s: the losses within 1e-5,
every gradient leaf within 1e-5 of the leaf's largest magnitude; rwkv6's
within 2e-4.  Measured on the CPU (the largest over the three meshes):
losses 4.8e-7, the MoE auxiliary loss 1.8e-7; gradients 3.5e-6
(recurrentgemma's ``rg.wa`` at (4, 1); its others <= 1.9e-6, every
other config's <= 1.1e-6); rwkv6 1.28e-4
at (2, 2) (``ln1``, a sum over every token with heavy cancellation: the
single-process port lies 8.2e-5 from the reference on this batch, and
the data split sums the rows' partial gradients in another order).

This file runs the dense configurations; ``test_torch_mesh_train_moe.py``
and ``test_torch_mesh_train_recurrent.py`` the others, through
:func:`run_archs` here.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.data.synthetic import DataConfig, host_batch
from repro.models import transformer as jt
from repro_torch.launch import mesh as mesh_lib

MESHES = ((2, 2), (4, 1), (1, 4))
SEQ, BATCH = 16, 4
LOSS_TOL = 1e-5
GRAD_TOL = {"rwkv6-3b": 2e-4}
GRAD_TOL_DEFAULT = 1e-5
ARCHS = ("qwen3-8b", "yi-34b", "gemma2-9b", "gemma2-27b")


def _perturbed_params(jcfg):
    p = jt.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(np.asarray(a, np.float32)
                             + 0.02 * rng.normal(size=a.shape), np.float32),
        p)


def _reference(arch: str, path: str) -> None:
    """The reference's parameters, batch, loss and gradients to ``path``
    (an ``.npz``; keys ``p:``/``g:`` + leaf path, ``b:`` + batch key)."""
    from repro_torch.models import convert
    jcfg = j_smoke(arch)
    ref = _perturbed_params(jcfg)
    batch = host_batch(jcfg, DataConfig(SEQ, BATCH, seed=0), 0)
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jt.loss_fn(jcfg, p, b), has_aux=True))(
        ref, {k: jnp.asarray(v) for k, v in batch.items()})
    out = {f"p:{k}": v for k, v in convert.flat_tree(ref).items()}
    out.update({f"g:{k}": np.asarray(v) for k, v in convert.flat_tree(
        jax.tree_util.tree_map(np.asarray, grads)).items()})
    out.update({f"b:{k}": v for k, v in batch.items()})
    out.update(loss=np.asarray(loss), ce=np.asarray(aux["ce"]),
               moe=np.asarray(aux["moe_aux_loss"]))
    np.savez(path, **out)


def local_shape_faults(cfg, named: dict, shardings: dict, mesh) -> list:
    """``(name, local shape, expected)`` of every parameter whose local
    shard is not the shape its spec gives on ``mesh``."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    out = []
    for k, p in named.items():
        want = list(p.shape)
        for d, ax in enumerate(shardings[k].spec):
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                if a is not None:
                    want[d] //= sizes[a]
        got = list(p.to_local().shape)
        if got != want:
            out.append((k, got, want))
    return out


def _rank(rank, world, archs, data_dir, out_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import smoke_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.models import convert, transformer
    from repro_torch.optim import adafactor, adamw

    results = {}
    for shape in MESHES:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data",
                                                              "model"))
        for arch in archs:
            cfg = smoke_config(arch)
            d = np.load(os.path.join(data_dir, f"{arch}.npz"))
            flat = {k[2:]: d[k] for k in d.files if k.startswith("p:")}
            params = transformer.trainable(convert.params_from_numpy(
                cfg, convert._nest(flat)))
            named = dict(params.named_parameters())
            opt = (adafactor.init(named) if cfg.optimizer == "adafactor"
                   else adamw.init(named))
            batch = {k[2:]: torch.from_numpy(d[k]) for k in d.files
                     if k.startswith("b:")}
            state_sh, batch_sh = steps.train_shardings(
                cfg, mesh, ShapeSpec("t", "train", SEQ, BATCH))
            state = steps.place_state({"params": params, "opt": opt},
                                      state_sh)
            faults = local_shape_faults(
                cfg, dict(state["params"].named_parameters()),
                state_sh["params"], mesh)
            grads = {}
            _, metrics = steps.make_train_step(cfg)(
                state, shd.place(batch, batch_sh), None, grads.update)
            whole = {k: g.full_tensor() for k, g in grads.items()}
            groups = convert.leaf_groups(cfg, params)
            got = convert.tree_from_named(groups, whole)
            errs = {}
            for key in groups:
                want = d[f"g:{key}"]
                scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
                errs[key] = float(np.abs(got[key] - want).max(initial=0.0)
                                  ) / scale
            all_faults = [None] * world
            dist.all_gather_object(all_faults, faults)
            worst = max(errs, key=errs.get)
            results.setdefault(arch, {})[f"{shape[0]}x{shape[1]}"] = dict(
                loss_err=abs(float(metrics["loss"]) - float(d["loss"])),
                ce_err=abs(float(metrics["ce"]) - float(d["ce"])),
                moe_err=abs(float(metrics["moe_aux_loss"])
                            - float(d["moe"])) / max(1.0, abs(float(
                                d["moe"]))),
                grad_err=errs[worst], worst_leaf=worst,
                leaves=len(errs), shape_faults=[f for fs in all_faults
                                                for f in fs])
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(results, f)


def run_archs(archs, tmp_path) -> dict:
    """The reference here, the port on 4 ranks; the results by arch and
    mesh."""
    for arch in archs:
        _reference(arch, str(tmp_path / f"{arch}.npz"))
    out = str(tmp_path / "results.json")
    mesh_lib.spawn_ranks(_rank, 4, str(tmp_path), tuple(archs),
                         str(tmp_path), out)
    with open(out) as f:
        return json.load(f)


def check(results, arch, mesh):
    r = results[arch][mesh]
    assert r["shape_faults"] == [], r["shape_faults"]
    assert r["leaves"] > 0
    assert r["loss_err"] <= LOSS_TOL, r
    assert r["ce_err"] <= LOSS_TOL, r
    assert r["moe_err"] <= LOSS_TOL, r
    assert r["grad_err"] <= GRAD_TOL.get(arch, GRAD_TOL_DEFAULT), r


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_archs(ARCHS, tmp_path_factory.mktemp("mesh_train"))


@pytest.mark.parametrize("mesh", [f"{a}x{b}" for a, b in MESHES])
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_step_matches_reference(results, arch, mesh):
    check(results, arch, mesh)
