"""The port's roofline (``repro_torch.launch.roofline``) and its table
(``benchmarks/torch_roofline_table.py``) against the reference's.

Mirrors ``tests/test_roofline_parse.py``: the collective counter's bytes
per kind on known functional collectives over an 8-rank fake process
group (in a subprocess: the fake group lives in one process), an async
collective and its wait counted once, nothing for a matmul; the
``RooflineTerms`` arithmetic with the H100 constants; arctic's active-only
MODEL_FLOPS; decode per token.  Then ``model_flops_for`` and
``_attention_score_bytes`` equal to the reference's for every arch and
applicable shape, ``dryrun.all_cells`` equal to the reference's, every
kernel op's FLOP formula and byte count at ``PERF.md`` §6's shapes (on
fake tensors), the counter's rules for views and in-place ops, and each
rank's argument bytes of the ten full configs' train and decode cells on
16 x 16 and 2 x 16 x 16 against the bytes the reference's
``NamedSharding``s imply (the reference in a subprocess over 512 host
devices)."""
import json
import math
import os
import subprocess
import sys

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from benchmarks import roofline_table as ref_table
from benchmarks import torch_roofline_table as table
from repro.configs import get_arch as ref_arch
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.launch import roofline as ref_roofline
from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs.shapes import SHAPES, applicable_shapes
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.kernels.rglru_scan import ops as rg_ops
from repro_torch.kernels.rwkv6_scan import ops as rw_ops
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import AbstractMesh, AXES, POD_AXES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [(a, s.name) for a in sorted(ARCHS)
         for s in applicable_shapes(ARCHS[a].family)]
MESHES = {"16x16": ((16, 16), AXES), "2x16x16": ((2, 16, 16), POD_AXES)}


def _run(script: str, *args, env=None) -> dict:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]), **(env or {}))
    proc = subprocess.run([sys.executable, "-c", script, *args], env=env,
                          capture_output=True, text=True, timeout=600,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


# ------------------------------------------------------ collective counter
_COLLECTIVES = r"""
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch import roofline
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
g = dist.group.WORLD.group_name
f = torch.ops._c10d_functional
wait = f.wait_tensor
out = {}
with roofline.Counter() as c:
    wait(f.all_gather_into_tensor(torch.zeros(128, 256), 8, g))
    wait(f.all_reduce(torch.zeros(512, dtype=torch.bfloat16), "sum", g))
    wait(f.reduce_scatter_tensor(torch.zeros(1024, 64), "sum", 8, g))
    wait(f.all_to_all_single(torch.zeros(4096, dtype=torch.uint8),
                             [512] * 8, [512] * 8, g))
out["kinds"] = c.coll
with roofline.Counter() as c:
    started = f.all_reduce(torch.zeros(256), "sum", g)
    wait(started)
out["pair"] = c.coll
with roofline.Counter() as c:
    torch.zeros(64, 64) @ torch.zeros(64, 64)
out["matmul"] = [c.coll, c.flops]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def collectives():
    return _run(_COLLECTIVES)


def test_collective_bytes_counts_kinds(collectives):
    out = collectives["kinds"]
    assert out["all-gather"] == 1024 * 256 * 4
    assert out["all-reduce"] == 512 * 2
    assert out["reduce-scatter"] == 128 * 64 * 4
    assert out["all-to-all"] == 4096
    assert len(out) == 4


def test_collective_bytes_counts_an_async_collective_once(collectives):
    # the collective op is the start; its wait_tensor counts nothing
    assert collectives["pair"] == {"all-reduce": 256 * 4}


def test_collective_bytes_ignores_noncollectives(collectives):
    assert collectives["matmul"] == [{}, 2 * 64 * 64 * 64]


# ----------------------------------------------------------- the terms
def test_roofline_terms_math():
    t = roofline.RooflineTerms(
        arch="x", shape="train_4k", mesh="m", chips=256,
        hlo_flops=256 * roofline.PEAK_FLOPS,       # exactly 1 s of compute
        hlo_bytes=256 * roofline.HBM_BW * 2.0,     # 2 s of memory
        coll_bytes=roofline.LINK_BW * 0.5,         # 0.5 s of collectives
        coll_breakdown={}, model_flops=256 * roofline.PEAK_FLOPS * 0.8,
        bytes_per_device=1e9)
    assert abs(t.t_comp - 1.0) < 1e-9
    assert abs(t.t_mem - 2.0) < 1e-9
    assert abs(t.t_coll - 0.5) < 1e-9
    assert t.dominant == "memory"
    assert abs(t.roofline_fraction - 0.5) < 1e-9
    assert abs(t.useful_ratio - 0.8) < 1e-9
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989e12, 3.35e12, 450e9)
    assert set(t.to_dict()) == {
        "arch", "shape", "mesh", "chips", "hlo_flops", "hlo_bytes",
        "coll_bytes", "coll_breakdown", "model_flops", "bytes_per_device",
        "t_comp", "t_mem", "t_coll", "dominant", "useful_ratio",
        "roofline_fraction"}


def test_model_flops_counts_active_only_for_moe():
    cfg = get_arch("arctic-480b")
    spec = SHAPES["train_4k"]
    f = roofline.model_flops_for(cfg, spec)
    dense_equiv = 6.0 * cfg.param_count() * spec.global_batch * spec.seq_len
    # top-2 of 128 experts: active flops are a small fraction of total
    assert f < 0.2 * dense_equiv


def test_model_flops_decode_is_per_token():
    cfg = get_arch("qwen3-8b")
    f_dec = roofline.model_flops_for(cfg, SHAPES["decode_32k"])
    f_pre = roofline.model_flops_for(cfg, SHAPES["prefill_32k"])
    # decode: 128 tokens vs prefill: 32*32768 tokens
    assert f_dec < f_pre / 1000


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_and_score_bytes_equal_reference(arch, shape):
    cfg, spec = get_arch(arch), SHAPES[shape]
    rcfg, rspec = ref_arch(arch), REF_SHAPES[shape]
    assert (roofline.model_flops_for(cfg, spec)
            == ref_roofline.model_flops_for(rcfg, rspec))
    assert (table._attention_score_bytes(cfg, spec)
            == ref_table._attention_score_bytes(rcfg, rspec))


# ------------------------------------------------------- the kernel ops
def _count(fn, *shapes):
    """flops, bytes and kernel launches of ``fn`` on fake tensors of
    ``shapes`` ((shape, dtype) pairs), and FlopCounterMode's flops."""
    with FakeTensorMode():
        args = [None if s is None else torch.empty(s[0], dtype=s[1])
                for s in shapes]
        with roofline.Counter() as c:
            fn(*args)
        with FlopCounterMode(display=False) as fc:
            fn(*args)
    return c.flops, c.bytes, dict(c.kernels), fc.get_total_flops()


BF16, F32, I32 = torch.bfloat16, torch.float32, torch.int32
KERNEL_CASES = {
    # PERF.md §6: Qwen3's prefill and decode (137.5 GFLOP, 33.6 MB)
    "k3_qwen3_prefill": (
        lambda q, k, v: fa_ops.flash_attention(q, k, v),
        [((4, 2048, 32, 128), BF16), ((4, 2048, 8, 128), BF16),
         ((4, 2048, 8, 128), BF16)],
        4 * 128 * 4 * 32 * (2048 * 2049 // 2),
        2 * 128 * (2 * 4 * 2048 * 32 + 2 * 4 * 2048 * 8)),
    "k3_qwen3_decode": (
        lambda q, k, v: fa_ops.flash_attention(q, k, v),
        [((4, 1, 32, 128), BF16), ((4, 2049, 8, 128), BF16),
         ((4, 2049, 8, 128), BF16)],
        4 * 128 * 4 * 32 * 2049,
        2 * 128 * (2 * 4 * 1 * 32 + 2 * 4 * 2049 * 8)),
    # a window shorter than the prompt keeps window keys a row past it
    "k3_window": (
        lambda q, k, v: fa_ops.flash_attention(q, k, v, window=64),
        [((1, 256, 4, 64), F32), ((1, 256, 4, 64), F32),
         ((1, 256, 4, 64), F32)],
        4 * 64 * 4 * (64 * 65 // 2 + (256 - 64) * 64),
        4 * 64 * 4 * 256 * 4),
    # the granite prefill's gate/up product over its full capacity
    "k4_granite_prefill": (
        lambda x, w, s: gmm_ops.moe_gmm(x, w, s),
        [((4, 48, 432, 1536), BF16), ((48, 1536, 512), BF16),
         ((4, 48), I32)],
        2 * 4 * 48 * 432 * 1536 * 512,
        2 * (4 * 48 * 432 * 1536 + 48 * 1536 * 512 + 4 * 48 * 432 * 512)
        + 4 * 4 * 48),
    # rwkv6-3b's prefill from a passed state (424.7 MB)
    "k5_rwkv6": (
        lambda r, k, v, lw, u, s0: rw_ops.rwkv6_scan(r, k, v, lw, u, s0),
        [((4, 40, 2048, 64), F32)] * 3 + [((4, 40, 2048, 64), F32),
                                          ((40, 64), F32),
                                          ((4, 40, 64, 64), F32)],
        rw_ops.scan_flops(4, 40, 2048, 64), 424_683_520),
    # recurrentgemma-9b's prefill (402.7 MB)
    "k6_recurrentgemma": (
        lambda a, b: rg_ops.rglru_scan(a, b),
        [((4, 2048, 4096), F32), ((4, 2048, 4096), F32)],
        3 * 4 * 2048 * 4096, 402_718_720),
}


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_kernel_op_formulas_at_perf_shapes(case):
    fn, shapes, flops, nbytes = KERNEL_CASES[case]
    got_flops, got_bytes, kernels, fc_flops = _count(fn, *shapes)
    assert got_flops == flops == fc_flops
    # K5 clamps logw before its op (a read and a write of it)
    extra = 2 * 4 * math.prod(shapes[3][0]) if case == "k5_rwkv6" else 0
    assert got_bytes == nbytes + extra
    assert sum(kernels.values()) == 1


def test_k5_formula_is_perf_md_work():
    # PERF.md §6: 6.46 GFLOP of float64 work at rwkv6-3b's prefill shape
    assert round(rw_ops.scan_flops(4, 40, 2048, 64) / 1e9, 2) == 6.46
    assert round(fa_ops.attention_flops(4, 32, 2048, 2048, 128) / 1e9,
                 1) == 137.5


def test_counter_counts_views_free_and_in_place_once():
    x = torch.zeros(4, 8)
    with roofline.Counter() as c:
        x.view(8, 4).t()
        x.expand(2, 4, 8)
    assert (c.flops, c.bytes) == (0, 0)
    with roofline.Counter() as c:
        x.add_(1.0)
    assert c.bytes == 4 * 32
    with roofline.Counter() as c:
        y = x + x
    assert c.bytes == 3 * 4 * 32 and c.peak_bytes == 4 * 32
    del y


# ------------------------------------------------- cells and arguments
_REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import ARCHS, get_arch
from repro.configs.shapes import DECODE_32K, TRAIN_4K
from repro.launch import dryrun, steps
from repro.models import transformer
devs = np.asarray(jax.devices())


def nbytes(specs, shardings):
    leaves = jax.tree_util.tree_leaves_with_path(specs)
    shs = jax.tree_util.tree_leaves(shardings,
                                    is_leaf=lambda x: hasattr(x, "spec"))
    assert len(leaves) == len(shs)
    # the RG-LRU conv state in float32, the type the reference's prefill
    # returns it in (its zero cache holds the compute type; the port's
    # holds float32 throughout: repro_torch.models.rglru.init_state)
    size = lambda path, x: (4 if "conv" in jax.tree_util.keystr(path)
                            else x.dtype.itemsize)
    return sum(int(np.prod(sh.shard_shape(x.shape))) * size(path, x)
               for (path, x), sh in zip(leaves, shs))


out = {"cells": dryrun.all_cells(), "bytes": {}}
for name, (shape, axes) in json.loads(sys.argv[1]).items():
    mesh = Mesh(devs[:int(np.prod(shape))].reshape(shape), tuple(axes))
    for arch in ARCHS:
        cfg = get_arch(arch)
        state_sh, batch_sh = steps.train_shardings(cfg, mesh, TRAIN_4K)
        train = (nbytes(steps.train_state_specs(cfg), state_sh)
                 + nbytes(steps.input_specs(cfg, TRAIN_4K), batch_sh))
        p_sh, c_sh, b_sh = steps.serve_shardings(cfg, mesh, DECODE_32K)
        params = jax.eval_shape(
            lambda: transformer.init_params(cfg, jax.random.PRNGKey(0)))
        decode = (nbytes(params, p_sh)
                  + nbytes(steps.cache_specs(cfg, DECODE_32K), c_sh)
                  + nbytes(steps.input_specs(cfg, DECODE_32K), b_sh))
        out["bytes"][f"{arch}|{name}"] = [train, decode]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    return _run(_REFERENCE, json.dumps(MESHES),
                env={"JAX_PLATFORMS": "cpu"})


def test_all_cells_equal_reference(reference):
    assert [list(c) for c in dryrun.all_cells()] == reference["cells"]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_argument_bytes_equal_reference_specs(reference, arch, mesh):
    """Each rank's bytes of the train cell's state and batch and of the
    decode cell's parameters, cache and batch, as the dry-run places
    them, equal the bytes the reference's shardings give each device."""
    m = AbstractMesh(*MESHES[mesh])
    cfg = get_arch(arch)
    got = [dryrun.argument_bytes(dryrun.arguments(
        cfg, SHAPES[s], m, dryrun.shard_meta))
        for s in ("train_4k", "decode_32k")]
    assert got == reference["bytes"][f"{arch}|{mesh}"]
