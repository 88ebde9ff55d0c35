"""The MLP serve edge grid (``coverage.serve_mlp_edge_case``) through the
port's plain version against the reference's ``fused_serve_episode``
(``src/repro/kernels/soc_step/ops.py``; with a network it runs the
reference's serving scan), on the CPU.

Each case is five streams of 96 requests on ``SOC_MOTIV_PAR``: a learning
network, its frozen copy, a Q-table and NON_COH beside placeholder
networks, and a learning network whose NON_COH value is +inf (its TD
delta is never finite), all under a watchdog that trips and releases.
The networks: the paths' (14, 16, 16, 4) sense network (healthy and under
the grid's fault rows), the one-hot 243-input network and the widest
4-layer sense network the serve kernel's shared memory holds.  Both
packages get the same inputs (the port's case as numpy), the reference
each stream in a ``vmap``.  Integer columns and leaves must equal both
reference builds; every float (the trace, the carry, the trained packs)
must be bitwise the reference compiled without fused multiply-add
(``test_torch_serve.reference_without_fma``) and within ``TOL_FMA`` of
the FMA build (ROADMAP C1).  The card holds K2m against the same plain
version on this grid (``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rewards as jr
from repro.kernels.soc_step import ops as jops, ref as jref
from repro.soc import memsys as jm, nn as jnn
from repro_torch.kernels.soc_step import coverage, ref as tref
from repro_torch.soc import nn as tnn
from test_torch_serve import reference_without_fma

CASES = ("sense", "sense_faulted", "onehot", "widest")
INT_COLS = ("mode", "state_idx", "action", "executed", "retries", "depth",
            "degraded")
INT_LEAVES = ("head", "step", "tripped")
TOL_FMA = dict(rtol=2e-6, atol=1e-6)


def _case(name: str) -> coverage.ServeMlpCase:
    net, _, faulted = name.partition("_")
    return coverage.serve_mlp_edge_case(net, seed=5, faulted=bool(faulted))


def _np(tree):
    return type(tree)(*(None if v is None else np.asarray(v)
                        for v in tree))


def _reference(mc: coverage.ServeMlpCase):
    """The reference's fused_serve_episode on the case, one stream a vmap
    lane, jitted."""
    c = mc.case
    cfg = jnn.MLPConfig(features=mc.mlp.cfg.features,
                        hidden=mc.mlp.cfg.hidden, lr=mc.mlp.cfg.lr)
    s = jm.SoCStatic(*(jnp.float32(v) for v in c.static))

    def one(learned, weights, sp, carry0, xs, t_arr, deadline, priority,
            qfun, lr):
        mlp = jnn.MLPQState(wpack=carry0.wpack, lr=lr, step=carry0.step,
                            frozen=jnp.bool_(False), cfg=cfg)
        return jops.fused_serve_episode(s, learned, weights, sp, carry0, xs,
                                        t_arr, deadline, priority,
                                        qfun=qfun, mlp=mlp)

    run = jax.jit(jax.vmap(one))
    xs = jref.StepInputs(*_np(c.xs))
    carry, ys = run(np.asarray(c.learned), jr.RewardWeights(*_np(c.weights)),
                    jref.ServeParams(*_np(c.sp)),
                    jref.ServeCarry(*_np(c.carry0)), xs, np.asarray(c.t_arr),
                    np.asarray(c.deadline), np.asarray(c.priority),
                    np.asarray(mc.qfun), np.asarray(mc.mlp.lr))
    return carry, ys


def _table(name, carry, ys) -> dict:
    out = {f"{name}/y/{col}": np.asarray(ys)[..., i]
           for i, col in enumerate(tref.SERVE_YCOLS)}
    for f in tref.ServeCarry._fields:
        out[f"{name}/carry/{f}"] = np.asarray(getattr(carry, f))
    return out


def reference_tables() -> dict:
    out = {}
    for name in CASES:
        out.update(_table(name, *_reference(_case(name))))
    return out


def _port_tables() -> dict:
    out = {}
    for name in CASES:
        mc = _case(name)
        c = mc.case
        carry, ys = tref.serve_episode_ref(
            c.static, c.learned, c.weights, c.sp, c.carry0, c.xs, c.t_arr,
            c.deadline, c.priority, qfun=mc.qfun, mlp_lr=mc.mlp.lr,
            mlp_dims=tnn.mlp_dims(mc.mlp.cfg),
            mlp_feats=mc.mlp.cfg.features)
        out.update(_table(name, carry.map(lambda t: t.numpy()), ys.numpy()))
    return out


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """(reference as jitted here, reference without FMA, the port)."""
    here, nofma = reference_without_fma(
        "test_torch_serve_mlp_edges", "reference_tables",
        tmp_path_factory.mktemp("nofma"), meanwhile=reference_tables)
    return here, nofma, _port_tables()


@pytest.mark.parametrize("name", CASES)
def test_mlp_edge_grid_matches_reference(tables, name):
    """Integer columns and leaves equal to both builds, every float bitwise
    the no-FMA build and within TOL_FMA of the FMA build."""
    here, nofma, port = tables
    keys = [k for k in port if k.startswith(name + "/")]
    assert len(keys) == len(tref.SERVE_YCOLS) + len(tref.ServeCarry._fields)
    for k in keys:
        np.testing.assert_array_equal(port[k], nofma[k], err_msg=k)
        f = k.rsplit("/", 1)[1]
        if f in INT_COLS or f in INT_LEAVES:
            np.testing.assert_array_equal(port[k], here[k], err_msg=k)
        else:
            np.testing.assert_allclose(port[k], here[k], err_msg=k,
                                       **TOL_FMA)


def test_mlp_edge_grid_learns_and_gates(tables):
    """The grid does what it is for in both packages: the learning
    network moves, the frozen copy, the placeholders and the +inf
    network stay bitwise, the watchdog degrades some requests."""
    _, nofma, port = tables
    for name in CASES:
        w = port[f"{name}/carry/wpack"]
        w0 = _case(name).case.carry0.wpack.numpy()
        assert not np.array_equal(w[0], w0[0]), name
        for s in (1, 2, 3, 4):
            np.testing.assert_array_equal(w[s], w0[s], err_msg=name)
        assert port[f"{name}/y/degraded"].any(), name
        np.testing.assert_array_equal(nofma[f"{name}/carry/wpack"], w)
