"""The port's dry-run (``repro_torch.launch.dryrun``) on fake process
groups, each in a subprocess of its own (a fake group's size is fixed for
its process; they run at once).

* (1, 1), one rank: the same smoke train, prefill and decode steps of
  Qwen3-8B's smoke config counted on real CPU tensors and on fake tensors
  give equal FLOPs, bytes, collective bytes and kernel-op counts.  Fake
  tensors lie on the CPU in these tests: a fake CUDA tensor needs
  PyTorch built with CUDA for autograd and for DTensor's indexing, so
  the count on fake CUDA tensors against the card's is
  ``chip_smoke.py``'s.
* (4, 1): each rank's FLOPs times 4 equal the single-process step's;
  an RWKV-6 train cell extrapolated from 2 and 3 superblocks equals its
  full trace at 5.
* (4, 2): the smoke configs of Qwen3-8B, granite, rwkv6, recurrentgemma
  and Gemma-2 trace their train, prefill and decode steps with FLOPs > 0
  and collective bytes > 0 in training; a cell's argument bytes equal the
  shard arithmetic the roofline tests hold against the reference."""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE_ARCHS = ("qwen3-8b", "granite-moe-3b-a800m", "rwkv6-3b",
               "recurrentgemma-9b", "gemma2-9b")
KINDS = ("train", "prefill", "decode")

_HEAD = r"""
import json, sys, torch
torch.set_num_threads(1)
from repro_torch.configs import smoke_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import AbstractMesh

def spec(kind, b=8):
    return ShapeSpec("smoke_" + kind, kind, 32, b)

def counts(c):
    return [c.flops, c.bytes, c.coll, dict(c.kernels)]
"""

_ONE = _HEAD + r"""
from repro_torch.distributed import sharding as shd
cfg = smoke_config("qwen3-8b")
out = {}
for kind in ("train", "prefill", "decode"):
    sp = spec(kind)
    step, fake, _, _, mesh = dryrun.lower_cell(None, None, cfg=cfg, spec=sp,
                                               mesh_shape=(1, 1))
    # the same step on real CPU tensors placed on the same (1, 1) mesh
    gen = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab, v.shape, generator=gen,
                              dtype=v.dtype)
             for k, v in steps.input_specs(cfg, sp).items()}
    if kind == "train":
        sh, b_sh = steps.train_shardings(cfg, mesh, sp)
        state = steps.place_state(steps.make_train_state(cfg, 0, "cpu"), sh)
        real = (state, shd.place(batch, b_sh))
    else:
        from repro_torch.models import transformer
        p_sh, c_sh, b_sh = steps.serve_shardings(cfg, mesh, sp)
        params = transformer.init_params(cfg, gen, "cpu")
        state = steps.place_state({"params": params},
                                  {"params": p_sh})["params"]
        real = (state, shd.place(batch, b_sh))
        if kind == "decode":
            cache = steps.placed_cache(cfg, mesh, sp.global_batch,
                                       sp.seq_len)
            real = (state, cache, real[1], sp.seq_len - 1)
    out[kind] = {"real": counts(dryrun.count_step(step, real)),
                 "fake": counts(dryrun.count_step(step, fake))}
print(json.dumps(out))
"""

_FOUR = _HEAD + r"""
cfg = smoke_config("qwen3-8b")
sp = spec("train")
step, args, _, _, mesh = dryrun.lower_cell(None, None, cfg=cfg, spec=sp,
                                           mesh_shape=(4, 1))
rank = dryrun.count_step(step, args)
# the single-process step: whole fake tensors, no mesh
def whole(t, sh):
    with dryrun.fake_mode():
        return torch.empty(t.shape, dtype=t.dtype)

whole = dryrun.arguments(cfg, sp, AbstractMesh((1, 1), ("data", "model")),
                         whole)
plain = dryrun.count_step(steps.make_train_step(cfg), whole)
# RWKV-6's train cell at 5 superblocks, traced and extrapolated from 2, 3
deep = smoke_config("rwkv6-3b").replace(n_layers=5)
full, _ = dryrun.count_cell(deep, sp, mesh_shape=(4, 1))
ex, _ = dryrun.count_cell(deep, sp, mesh_shape=(4, 1),
                          depth=dryrun.EXTRAPOLATED_DEPTHS)
print(json.dumps({"rank": counts(rank), "plain": counts(plain),
                  "deep": counts(full) + [full.peak_bytes],
                  "extrapolated": counts(ex) + [ex.peak_bytes]}))
"""

_EIGHT = _HEAD + r"""
out = {}
for arch in sys.argv[1].split(","):
    cfg = smoke_config(arch)
    for kind in ("train", "prefill", "decode"):
        step, args, _, sp, mesh = dryrun.lower_cell(
            None, None, cfg=cfg, spec=spec(kind), mesh_shape=(4, 2))
        c = dryrun.count_step(step, args)
        arith = dryrun.argument_bytes(dryrun.arguments(
            cfg, sp, AbstractMesh((4, 2), ("data", "model")),
            dryrun.shard_meta))
        out[f"{arch}|{kind}"] = counts(c) + [
            c.peak_bytes, dryrun.argument_bytes(args), arith]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs():
    """The subprocesses, started together (the 4 x 2 cells in two)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("JAX_PLATFORMS", None)
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", script, *args], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, script, args in (
            ("one", _ONE, ()), ("four", _FOUR, ()),
            ("eight", _EIGHT, (",".join(SMOKE_ARCHS[:3]),)),
            ("eight_b", _EIGHT, (",".join(SMOKE_ARCHS[3:]),)))}
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"{name}: {stderr[-3000:]}"
        out[name] = json.loads(stdout.strip().splitlines()[-1])
    out["eight"].update(out.pop("eight_b"))
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_real_and_fake_tensors_count_the_same(runs, kind):
    got = runs["one"][kind]
    assert got["real"] == got["fake"]
    flops, nbytes, _, kernels = got["real"]
    assert flops > 0 and nbytes > 0 and kernels == {"flash_attention": 2}


def test_four_ranks_split_the_single_process_flops(runs):
    rank, plain = runs["four"]["rank"], runs["four"]["plain"]
    assert rank[0] * 4 == plain[0] > 0
    assert rank[3] == plain[3]               # every rank runs every kernel
    assert sum(rank[2].values()) > 0 and plain[2] == {}


def test_depth_extrapolation_equals_the_full_trace(runs):
    """A train cell counted at 2 and 3 superblocks and extrapolated (the
    dry-run's way with RWKV-6's, whose trace steps the recurrence token
    by token) gives the full trace's FLOPs, bytes, collective bytes,
    kernel launches and peak of live bytes, at smoke width and 5
    superblocks."""
    assert runs["four"]["extrapolated"] == runs["four"]["deep"]
    assert runs["four"]["deep"][3] == {"rwkv6_scan": 5}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_smoke_cells_trace_on_a_4x2_mesh(runs, arch, kind):
    flops, nbytes, coll, kernels, peak, args, arith = runs["eight"][
        f"{arch}|{kind}"]
    assert flops > 0 and nbytes > 0 and peak > 0
    assert args == arith > 0
    if kind == "train":
        assert sum(coll.values()) > 0
        assert set(coll) <= {"all-gather", "all-reduce", "reduce-scatter",
                             "all-to-all"}
