"""The port's sharding rules (``repro_torch.distributed.sharding`` and
``launch.steps``' ``train_shardings`` / ``serve_shardings``) against the
reference's, leaf for leaf, for the full config of all ten architectures
(the port's state and caches on the meta device) on four meshes: (1, 1)
in this process, and (4, 2), 16 x 16 and 2 x 16 x 16 with the reference
run in one subprocess over 512 host devices.  Compared: every parameter,
AdamW moment and Adafactor leaf (a per-layer tensor of a stacked leaf
against the stacked leaf's spec without its layer axis), the batch specs
of the train, prefill and decode shapes (the VLM's ``mrope_positions``
included) and every cache leaf of the decode shape.  Then the three rule
tests of ``tests/test_data_sharding.py``, and ``_fit_spec`` /
``activation_spec`` against the reference's on meshes of any size."""
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from repro.configs import get_arch as j_arch
from repro.configs.shapes import DECODE_32K, PREFILL_32K, TRAIN_4K
from repro.distributed import sharding as jshd
from repro.launch import steps as jsteps
from repro_torch.configs import ARCHS, get_arch, smoke_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as mesh_lib, steps
from repro_torch.models import convert

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIG = {"4x2": ((4, 2), ("data", "model")),
       "16x16": ((16, 16), ("data", "model")),
       "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}

_REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax, numpy as np
from jax.sharding import Mesh
sys.path.insert(0, sys.argv[1])
import test_torch_sharding as t
meshes = json.loads(sys.argv[2])
devs = np.asarray(jax.devices())
out = {}
for name, (shape, axes) in meshes.items():
    mesh = Mesh(devs[:int(np.prod(shape))].reshape(shape), tuple(axes))
    out[name] = {a: t.reference_tables(a, mesh) for a in t.ARCH_NAMES}
print(json.dumps(out))
"""

ARCH_NAMES = sorted(ARCHS)


def _spec(p) -> list:
    """A PartitionSpec (or the port's tuple) as JSON: tuples as lists."""
    return [list(a) if isinstance(a, tuple) else a for a in tuple(p)]


def _flat(tree) -> dict:
    leaves = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: hasattr(x, "spec"))
    return {jshd._path_str(path): _spec(leaf.spec) for path, leaf in leaves}


def reference_tables(arch: str, mesh) -> dict:
    """The reference's specs: the train state and train batch, and the
    prefill and decode batches and the decode cache."""
    cfg = j_arch(arch)
    state, batch = jsteps.train_shardings(cfg, mesh, TRAIN_4K)
    _, _, prefill = jsteps.serve_shardings(cfg, mesh, PREFILL_32K)
    _, cache, decode = jsteps.serve_shardings(cfg, mesh, DECODE_32K)
    return {"state": _flat(state), "batch": _flat(batch),
            "prefill": _flat(prefill), "decode": _flat(decode),
            "cache": _flat(cache)}


@pytest.fixture(scope="module")
def reference():
    """Every mesh's tables: (1, 1) here, the rest in one subprocess."""
    mesh11 = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                  ("data", "model"))
    out = {"1x1": {a: reference_tables(a, mesh11) for a in ARCH_NAMES}}
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, os.path.join(ROOT, "tests"),
         json.dumps(BIG)], env=env, capture_output=True, text=True,
        timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out.update(json.loads(proc.stdout.strip().splitlines()[-1]))
    return out


def _port_mesh(name):
    if name == "1x1":
        return mesh_lib.AbstractMesh((1, 1), ("data", "model"))
    shape, axes = BIG[name]
    return mesh_lib.AbstractMesh(shape, axes)


def _drop_layer_axis(spec: list, stacked: bool) -> list:
    return spec[1:] if stacked else spec


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("mesh_name", ["1x1", "4x2", "16x16", "2x16x16"])
def test_specs_match_reference_leaf_for_leaf(reference, mesh_name, arch):
    ref = reference[mesh_name][arch]
    cfg = get_arch(arch)
    mesh = _port_mesh(mesh_name)
    state_sh, batch_sh = steps.train_shardings(cfg, mesh, TRAIN_4K)
    names = list(state_sh["params"])
    checked = set()

    def want(prefix, name):
        _, key, s = convert._ref_path(cfg, name)
        checked.add(f"{prefix}{key}")
        return _drop_layer_axis(ref["state"][f"{prefix}{key}"],
                                s is not None)

    for n in names:
        assert _spec(state_sh["params"][n].spec) == want("params.", n), n
    opt = state_sh["opt"]
    assert _spec(opt.step.spec) == ref["state"]["opt.step"]
    checked.add("opt.step")
    if cfg.optimizer == "adafactor":
        for n in names:
            for field in ("vr", "vc"):
                got = _spec(getattr(opt.v[n], field).spec)
                _, key, s = convert._ref_path(cfg, n)
                path = f"opt.v.{key}.{field}"
                checked.add(path)
                assert got == _drop_layer_axis(ref["state"][path],
                                               s is not None), (n, field)
    else:
        for n in names:
            assert _spec(opt.mu[n].spec) == want("opt.mu.", n), n
            assert _spec(opt.nu[n].spec) == want("opt.nu.", n), n
    assert checked == set(ref["state"]), set(ref["state"]) ^ checked

    assert {k: _spec(v.spec) for k, v in batch_sh.items()} == ref["batch"]
    for kind, spec in (("prefill", PREFILL_32K), ("decode", DECODE_32K)):
        p_sh, c_sh, b_sh = steps.serve_shardings(cfg, mesh, spec)
        assert {k: _spec(v.spec) for k, v in b_sh.items()} == ref[kind]
        assert {k: _spec(v.spec) for k, v in p_sh.items()} == {
            k: _spec(v.spec) for k, v in state_sh["params"].items()}
    cache = {}
    for path, ns in c_sh:
        stacked = path.startswith("blocks.")
        want_c = _drop_layer_axis(ref["cache"][path], stacked)
        assert _spec(ns.spec) == want_c, path
        cache[path] = True
    assert set(cache) == set(ref["cache"])


def test_placements_follow_the_specs():
    """``NamedSharding.placements``: a split dimension's axis a ``Shard``,
    an axis of size 1 and an unnamed one ``Replicate``."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = mesh_lib.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert shd.placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert shd.placements((None, "data"), mesh) == (
        Replicate(), Shard(1), Replicate())
    one = mesh_lib.AbstractMesh((1, 4), ("data", "model"))
    assert shd.placements(("data", "model"), one) == (Replicate(), Shard(1))
    assert shd.placements((), one) == (Replicate(), Replicate())


# --------------------------------------- tests/test_data_sharding.py's rules
def test_param_rules_embed_vocab_on_model():
    mesh = mesh_lib.AbstractMesh((1, 1), ("data", "model"))
    cfg = smoke_config("qwen3-8b")
    sh = steps.train_shardings(cfg, mesh, TRAIN_4K)[0]["params"]
    assert sh["embed"].spec == ("model", None)
    assert sh["lm_head"].spec == (None, "model")


def test_fit_spec_drops_indivisible():
    mesh = mesh_lib.AbstractMesh((1, 1), ("data", "model"))
    assert shd._fit_spec(("data", "model"), (4, 8), mesh) == ("data",
                                                              "model")
    mesh = mesh_lib.AbstractMesh((4, 3), ("data", "model"))
    assert shd._fit_spec(("data", "model"), (4, 8), mesh) == ("data", None)


@pytest.mark.parametrize("b", [1, 2, 4, 8, 16, 128])
@pytest.mark.parametrize("h", [2, 8, 12, 24, 56])
def test_activation_spec_utilization_rule(b, h):
    mesh = mesh_lib.AbstractMesh((1, 1), ("data", "model"))
    spec = shd.activation_spec(mesh, (b, 16, h, 64), batch_dim=0,
                               head_dim=2)
    assert spec[0] == "data"
    assert spec[2] == "model"


# ------------------------------------ the rules against the reference's
def _meshes(shape, axes):
    ref = SimpleNamespace(axis_names=tuple(axes),
                          devices=np.empty(shape, dtype=object))
    return ref, mesh_lib.AbstractMesh(tuple(shape), tuple(axes))


_AXES = [("data", "model"), ("pod", "data", "model")]


def _check_fit(spec, shape, mesh_shape, axes):
    ref_mesh, mesh = _meshes(mesh_shape, axes)
    assert shd._fit_spec(spec, shape, mesh) == tuple(
        jshd._fit_spec(P(*spec), shape, ref_mesh))


def _check_activation(shape, bd, hd, mesh_shape, axes):
    ref_mesh, mesh = _meshes(mesh_shape, axes)
    assert shd.activation_spec(mesh, shape, batch_dim=bd, head_dim=hd) == (
        tuple(jshd.activation_spec(ref_mesh, shape, batch_dim=bd,
                                   head_dim=hd)))


@pytest.mark.parametrize("axes", _AXES)
def test_fit_and_activation_spec_equal_reference_on_a_grid(axes):
    sizes = [1, 2, 3, 4, 16]
    dims = [1, 2, 3, 8, 12, 16, 24, 100]
    names = [None, "data", "model"] + ([("pod", "data")] if "pod" in axes
                                       else [])
    rng = np.random.default_rng(0)
    pick = lambda xs: xs[int(rng.integers(len(xs)))]
    for _ in range(400):
        mesh_shape = tuple(pick(sizes) for _ in axes)
        shape = tuple(pick(dims) for _ in range(int(rng.integers(1, 5))))
        spec = tuple(pick(names) for _ in range(int(rng.integers(0, 6))))
        _check_fit(spec, shape, mesh_shape, axes)
        if len(shape) >= 2:
            _check_activation(shape, 0, int(rng.integers(1, len(shape))),
                              mesh_shape, axes)


try:
    from hypothesis import given, settings, strategies as st
except ImportError:      # the grid above still runs
    given = None

if given is not None:
    _ax = st.sampled_from([None, "data", "model", ("pod", "data")])

    @settings(max_examples=200, deadline=None)
    @given(mesh_shape=st.tuples(st.integers(1, 32), st.integers(1, 32),
                                st.integers(1, 32)),
           shape=st.lists(st.integers(1, 300), min_size=1, max_size=5),
           spec=st.lists(_ax, max_size=6))
    def test_fit_spec_equals_reference(mesh_shape, shape, spec):
        _check_fit(tuple(spec), tuple(shape), mesh_shape,
                   ("pod", "data", "model"))

    @settings(max_examples=200, deadline=None)
    @given(mesh_shape=st.tuples(st.integers(1, 32), st.integers(1, 32)),
           shape=st.lists(st.integers(1, 300), min_size=3, max_size=4),
           head=st.integers(1, 2), pod=st.booleans(),
           pods=st.integers(1, 4))
    def test_activation_spec_equals_reference(mesh_shape, shape, head, pod,
                                              pods):
        axes = ("pod", "data", "model") if pod else ("data", "model")
        ms = (pods,) + mesh_shape if pod else mesh_shape
        _check_activation(tuple(shape), 0, head, ms, axes)


# ------------------------------------------------------------ launch.mesh
def test_production_mesh_is_abstract_without_its_ranks():
    one = mesh_lib.make_production_mesh()
    two = mesh_lib.make_production_mesh(multi_pod=True)
    assert (one.shape, one.mesh_dim_names) == ((16, 16), ("data", "model"))
    assert (two.shape, two.mesh_dim_names) == ((2, 16, 16),
                                               ("pod", "data", "model"))
    assert two.size() == 512 and two.size(0) == 2


_FAKE = r"""
import torch, torch.distributed as dist
import repro_torch.launch.mesh as mesh_lib
# importing the module started nothing
assert not dist.is_initialized() and not torch.cuda.is_initialized()
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import get_arch
from repro_torch.configs.shapes import TRAIN_4K
from repro_torch.launch import steps
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
m = mesh_lib.make_production_mesh(device_type="cpu")
assert type(m).__name__ == "DeviceMesh" and tuple(m.shape) == (16, 16)
sh, _ = steps.train_shardings(get_arch("qwen2-vl-2b"), m, TRAIN_4K)
w = sh["params"]["layers.0.mlp.w_gate"]
assert w.spec == ("data", "model"), w.spec
from torch.distributed.tensor import Shard
assert w.placements() == (Shard(0), Shard(1)), w.placements()
print("FAKE_OK")
"""


def test_production_mesh_under_the_fake_backend():
    """With a 256-rank fake process group (the dry-run's), the production
    mesh is a DeviceMesh the rules place on; importing ``launch.mesh``
    touches no process group and no card."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", _FAKE], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT)
    assert "FAKE_OK" in proc.stdout, proc.stderr[-2000:]


# -------------------------------------- launch.steps' abstract inputs
def _shape_of(x):
    return [int(d) for d in x.shape], str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_spec_shapes_match_reference(arch):
    """``train_state_specs``, ``input_specs`` and ``cache_specs`` (meta
    tensors) against the reference's ``eval_shape`` trees: every leaf's
    shape and dtype (a per-layer tensor against its stacked leaf's shape
    without the layer axis)."""
    from repro.configs import get_arch as j_get
    from repro.configs.shapes import ALL_SHAPES
    from repro_torch.models import transformer
    jcfg, cfg = j_get(arch), get_arch(arch)
    n_super = transformer.superblock_layout(cfg)[1]
    ref = jsteps.train_state_specs(jcfg)
    state = steps.train_state_specs(cfg)
    jp = {jshd._path_str(p): x for p, x in
          jax.tree_util.tree_leaves_with_path(ref["params"])}
    for name, p in state["params"].named_parameters():
        assert p.device.type == "meta"
        _, key, s = convert._ref_path(cfg, name)
        want = list(jp[key].shape)
        assert list(p.shape) == (want[1:] if s is not None else want), name
        assert want[0] == n_super or s is None
    for spec in ALL_SHAPES:
        jin = jsteps.input_specs(jcfg, spec)
        tin = steps.input_specs(cfg, spec)
        assert {k: _shape_of(v) for k, v in tin.items()} == {
            k: ([int(d) for d in v.shape], str(v.dtype))
            for k, v in jin.items()}
    jc = {jshd._path_str(p): x for p, x in
          jax.tree_util.tree_leaves_with_path(
              jsteps.cache_specs(jcfg, DECODE_32K))}
    leaves = shd.cache_leaves(cfg, steps.cache_specs(cfg, DECODE_32K))
    assert {path for path, _, _ in leaves} == set(jc)
    for path, stacked, leaf in leaves:
        want = [int(d) for d in jc[path].shape]
        assert list(leaf.shape) == (want[1:] if stacked else want), path


def test_prefill_and_decode_steps_are_the_models():
    """``make_prefill_step`` / ``make_decode_step`` run the model's
    prefill and decode (Qwen3's smoke config, bitwise)."""
    import torch
    from repro_torch.models import transformer
    cfg = smoke_config("qwen3-8b")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 8),
                         generator=torch.Generator().manual_seed(1))
    cache, logits = steps.make_prefill_step(cfg, max_len=12)(
        params, {"tokens": toks})
    c2, l2 = transformer.prefill(cfg, params, {"tokens": toks}, max_len=12)
    assert torch.equal(logits, l2)
    nxt = logits.argmax(-1)
    _, d1 = steps.make_decode_step(cfg)(params, cache, {"tokens": nxt}, 8)
    _, d2 = transformer.decode_step(cfg, params, c2, {"tokens": nxt}, 8)
    assert torch.equal(d1, d2)


def test_lane_mesh_spans_the_lanes():
    m = shd.lane_mesh(["cpu", "cpu", "cpu"])
    assert (m.shape, m.mesh_dim_names) == ((3,), ("lanes",))
