"""MLP-agent serving in the port (plain PyTorch path) against repro's, on
the CPU.

Cases: SoC1 (7 accelerators, 4 memory tiles), ``queue_cap`` 4, the short
two-phase application of ``tests/test_torch_serve.py``, a perturbed
(14, 16, 16, 4) "sense" network made by the port's initialiser (bitwise
the no-FMA reference's, so every build starts from the same pack) and
served by ``ServeEnv.serve`` learning and frozen; a mixed batch through
``serve_specs`` (the learning network, its frozen copy, a Q-table and
fixed NON_COH, the last two given placeholder networks with
``attach_placeholder_mlp``) under an overloading two-tenant stream that
trips the watchdog; two chained chunks; a stream under ``storm(64, 0.7,
PRNGKey(42))``; ``serve_checkpointed`` over three chunks, killed after
one and resumed; ``StackedVecEnv.serve`` with (2 lanes x 2) networks.
Integer columns, visits and steps must equal both reference builds;
every float (traces, carries, the trained packs) must be bitwise the
reference compiled without fused multiply-add
(:func:`test_torch_serve.reference_without_fma`), except the columns
that follow the arrival clock, which the port draws itself and which
agrees to ``MAX_ULP`` (``tests/test_torch_traffic.py``; measured: 1 ULP
in 2 of 64 arrivals, nothing downstream of them moved).  Against the FMA
build (ROADMAP C1) floats lie within ``TOL_FMA`` (measured: the packs
1.19e-7 absolute, every other float 2.3e-7 relative).
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.core import qlearn as jq
from repro.soc import faults as jf, nn as jnn, stacked as jstk
from repro.soc import traffic as jtraffic, vecenv as jvec
from repro.soc.apps import make_application as j_make_app
from repro.soc.config import SOCS as JSOCS
from repro_torch import random as prng
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import qlearn as tq
from repro_torch.soc import faults as tf, nn as tnn, stacked as tstk
from repro_torch.soc import traffic as ttraffic, vecenv as tvec
from repro_torch.soc.apps import make_application as t_make_app
from repro_torch.soc.config import SOCS as TSOCS
from test_torch_serve import reference_without_fma

QCAP, N_REQ, N_CHUNKS = 4, 64, 3
DECAY = 64
UNDER, OVER = 2e-7, 4e-3
STACK_SOCS = ("SoC1", "SoC2")
INT_FIELDS = ("tenant", "mode", "state_idx", "action", "executed",
              "retries", "depth", "degraded", "head", "step", "visits",
              "frozen")
# the arrival clock and what adds to it
CLOCK = ("t_arr", "start", "finish", "fin", "busy", "latency")
MAX_ULP = 2
TOL_FMA = dict(rtol=2e-6, atol=1e-6)


def _ulps(a, b) -> int:
    """Largest distance in float32 ULPs (finite values of one sign)."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max(initial=0))


def _traffic(mod, rate, seed=3):
    return mod.bursty(rate, mix=(0.7, 0.3), deadline=(6000.0, 0.0),
                      priority=(1.0, 0.25), backoff=400.0,
                      overload_frac=0.35, prio_reserve=0.25, seed=seed)


def _pack(seed: int) -> np.ndarray:
    """The port's initial pack from ``seed``, perturbed, as numpy."""
    w = tnn.init_mlp_qstate(prng.PRNGKey(seed)).wpack[0].numpy().copy()
    w += np.random.default_rng(seed).normal(0, 0.3, w.shape).astype(
        np.float32)
    return w


def _mlp(port: bool, seed: int, frozen: bool = False):
    w = _pack(seed)
    if port:
        m = tnn.mlp_from_numpy(w, 0.05, 0, False, tnn.MLPConfig())
        return tnn.freeze(m) if frozen else m
    m = jnn.MLPQState(wpack=jnp.asarray(w), lr=jnp.float32(0.05),
                      step=jnp.int32(0), frozen=jnp.asarray(frozen),
                      cfg=jnn.MLPConfig())
    return m


def _setup(port: bool):
    socs, vec = (TSOCS, tvec) if port else (JSOCS, jvec)
    make_app = t_make_app if port else j_make_app
    soc = socs["SoC1"]
    kw = dict(device="cpu") if port else {}
    env = vec.VecEnv(soc, seed=1, **kw)
    app = vec.compile_app(make_app(soc, seed=50, n_phases=2), soc, seed=4)
    return soc, env, app


def _mixed_specs(port: bool, env, app):
    vec, q = (tvec, tq) if port else (jvec, jq)
    sched = app.schedule
    table = vec.learned_policy_spec(q.init_qstate(q.QConfig()), sched)
    fixed = vec.fixed_policy_spec(env.params, sched, 0)
    return vec.stack_specs([
        vec.mlp_policy_spec(_mlp(port, 7), sched),
        vec.mlp_policy_spec(_mlp(port, 7, frozen=True), sched),
        vec.attach_placeholder_mlp(table), vec.attach_placeholder_mlp(fixed)])


def _key(port: bool, seed: int):
    return prng.PRNGKey(seed) if port else jax.random.PRNGKey(seed)


def _keys(port: bool, n: int):
    return (prng.PRNGKey(np.arange(n)) if port
            else jax.vmap(jax.random.PRNGKey)(jnp.arange(n)))


class _Killer:
    """A manager that dies (before writing) once ``die_after`` saves went
    through, as a killed host would."""

    def __init__(self, inner, die_after: int):
        self._inner, self._left = inner, die_after

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def save(self, step, tree):
        if self._left <= 0:
            raise KeyboardInterrupt("simulated crash")
        self._left -= 1
        self._inner.save(step, tree)
        self._inner.wait()


def _record(out: dict, tag: str, tree, port: bool, unbatch: bool = False):
    for f in tree._fields:
        v = getattr(tree, f)
        if v is None:
            continue
        v = v.numpy() if port else np.asarray(v)
        out[f"{tag}/{f}"] = v[0] if (unbatch and port) else v


def _stacked(port: bool):
    socs, stk, make_app, q = ((TSOCS, tstk, t_make_app, tq) if port
                              else (JSOCS, jstk, j_make_app, jq))
    socs = [socs[n] for n in STACK_SOCS]
    kw = dict(device="cpu") if port else {}
    env = stk.StackedVecEnv(socs, seed=0, **kw)
    st = env.compile([make_app(s, seed=60 + i, n_phases=2)
                      for i, s in enumerate(socs)], seed=4)
    grid = [[_pack(10 + 2 * k + b) for b in range(2)] for k in range(2)]
    w = np.stack([np.stack(row) for row in grid])
    if port:
        mlps = tnn.MLPQState(
            wpack=torch.as_tensor(w), lr=torch.full((2, 2), 0.05),
            step=torch.zeros((2, 2), dtype=torch.int32),
            frozen=torch.zeros((2, 2), dtype=torch.bool),
            cfg=tnn.MLPConfig())
        keys = prng.PRNGKey(np.arange(4)).reshape(2, 2, 2)
    else:
        mlps = jnn.MLPQState(
            wpack=jnp.asarray(w), lr=jnp.full((2, 2), 0.05, jnp.float32),
            step=jnp.zeros((2, 2), jnp.int32),
            frozen=jnp.zeros((2, 2), bool), cfg=jnn.MLPConfig())
        keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(4)).reshape(2, 2, 2)
    specs = env.lower_mlps(st, mlps)
    return env.serve(st, specs, _traffic(ttraffic if port else jtraffic,
                                         OVER, seed=5),
                     q.QConfig(decay_steps=DECAY), keys=keys, queue_cap=QCAP,
                     n_requests=N_REQ // 2)


def _tables(port: bool, ck_dir=None) -> dict:
    soc, env, app = _setup(port)
    vec, q, traffic, faults = ((tvec, tq, ttraffic, tf) if port
                               else (jvec, jq, jtraffic, jf))
    cfg = q.QConfig(decay_steps=DECAY)
    senv = vec.ServeEnv(env, queue_cap=QCAP, n_requests=N_REQ)
    out = {}
    for tag, frozen, rate in (("learn", False, UNDER),
                              ("frozen", True, UNDER),
                              ("learn_over", False, OVER)):
        spec = vec.mlp_policy_spec(_mlp(port, 7, frozen), app.schedule)
        carry, qs, res = senv.serve(app, spec, _traffic(traffic, rate),
                                    cfg=cfg, key=_key(port, 1))
        for name, tree in (("carry", carry), ("qs", qs), ("res", res)):
            _record(out, f"{tag}/{name}", tree, port, unbatch=name != "res")
        if tag == "learn":
            # a second chunk of the same stream, through the carry
            spec2 = spec._replace(qstate=qs)
            c2, q2, r2 = senv.serve(
                app, spec2, traffic.chunk_key(_traffic(traffic, rate), 1),
                cfg=cfg, key=_key(port, 2), carry=carry, t0=res.t_arr[-1])
            for name, tree in (("carry", c2), ("qs", q2), ("res", r2)):
                _record(out, f"chain/{name}", tree, port,
                        unbatch=name != "res")
    carry, qs, res = senv.serve_specs(app, _mixed_specs(port, env, app),
                                      _traffic(traffic, OVER), cfg=cfg,
                                      keys=_keys(port, 4))
    for name, tree in (("carry", carry), ("qs", qs), ("res", res)):
        _record(out, f"mixed/{name}", tree, port)
    spec = vec.mlp_policy_spec(_mlp(port, 7), app.schedule)
    storm = faults.storm(N_REQ, 0.7, _key(port, 42))
    carry, qs, res = senv.serve(app, spec, _traffic(traffic, OVER), cfg=cfg,
                                key=_key(port, 1), faults=storm)
    for name, tree in (("carry", carry), ("qs", qs), ("res", res)):
        _record(out, f"storm/{name}", tree, port, unbatch=name != "res")
    if ck_dir is not None:
        mgr = (CheckpointManager if port else JManager)(
            str(Path(ck_dir) / ("port" if port else "ref")), keep=2)
        carry, qs, res = senv.serve_checkpointed(
            app, spec, _traffic(traffic, OVER, seed=8), mgr,
            n_chunks=N_CHUNKS, cfg=cfg, key=_key(port, 3),
            n_requests=N_REQ // 2)
        for name, tree in (("carry", carry), ("qs", qs), ("res", res)):
            _record(out, f"ckpt/{name}", tree, port, unbatch=name != "res")
    carry, qs, res = _stacked(port)
    for name, tree in (("carry", carry), ("qs", qs), ("res", res)):
        _record(out, f"stacked/{name}", tree, port)
    return out


def reference_tables() -> dict:
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        return _tables(False, d)


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """(reference as jitted here, reference without FMA, the port)."""
    here, nofma = reference_without_fma(
        "test_torch_serve_mlp", "reference_tables",
        tmp_path_factory.mktemp("nofma"), meanwhile=reference_tables)
    return here, nofma, _tables(True, tmp_path_factory.mktemp("ck"))


CASES = ("learn", "frozen", "learn_over", "chain", "mixed", "storm", "ckpt",
         "stacked")


@pytest.mark.parametrize("case", CASES)
def test_mlp_serving_matches_reference(tables, case):
    """Integer leaves equal to both builds, floats bitwise the no-FMA
    build (the clock's columns within MAX_ULP) and within TOL_FMA of the
    FMA build."""
    here, nofma, port = tables
    keys = [k for k in port if k.startswith(case + "/")]
    assert len(keys) >= 25 and f"{case}/carry/wpack" in keys
    for k in keys:
        f = k.rsplit("/", 1)[1]
        if f in CLOCK:
            assert port[k].shape == nofma[k].shape, k
            assert _ulps(port[k], nofma[k]) <= MAX_ULP, k
        else:
            np.testing.assert_array_equal(port[k], nofma[k], err_msg=k)
        if f in INT_FIELDS:
            np.testing.assert_array_equal(port[k], here[k], err_msg=k)
        else:
            np.testing.assert_allclose(port[k], here[k], err_msg=k,
                                       **TOL_FMA)


def test_mlp_serving_does_work(tables):
    """The cases exercise what they name: requests are served and shed,
    the watchdog trips under overload (degrading the network), a
    learning network's pack moves, a frozen one's stays bitwise, the
    placeholder Q-state of MLP specs stays frozen, and the table spec of
    the mixed batch learns its table."""
    port = tables[2]
    w0 = _pack(7)
    assert port["learn/res/executed"].all()
    assert not np.array_equal(port["learn/carry/wpack"], w0)
    np.testing.assert_array_equal(port["frozen/carry/wpack"], w0)
    assert port["learn_over/res/degraded"].any()
    assert not port["learn_over/res/executed"].all()
    assert port["mixed/res/degraded"].any()
    mixed = port["mixed/carry/wpack"]
    assert not np.array_equal(mixed[0], w0)
    np.testing.assert_array_equal(mixed[1], w0)
    assert port["mixed/qs/frozen"][:2].all()
    assert port["mixed/qs/visits"][2].sum() > 0
    assert port["chain/qs/step"] > port["learn/qs/step"]
    assert port["storm/res/executed"].any()
    assert port["stacked/carry/wpack"].shape[:2] == (2, 2)


def test_checkpointed_mlp_serving_resumes_bitwise(tmp_path):
    """A learning network served in three chunks through
    ``serve_checkpointed``, killed after the first chunk's checkpoint and
    resumed, ends bitwise equal to the uninterrupted stream: the pack is
    one more leaf of the checkpoint."""
    _, env, app = _setup(True)
    senv = tvec.ServeEnv(env, queue_cap=QCAP, n_requests=N_REQ // 2)
    spec = tvec.mlp_policy_spec(_mlp(True, 7), app.schedule)
    kw = dict(n_chunks=N_CHUNKS, cfg=tq.QConfig(decay_steps=DECAY),
              key=prng.PRNGKey(3))
    tspec = _traffic(ttraffic, OVER, seed=8)
    whole = senv.serve_checkpointed(
        app, spec, tspec, CheckpointManager(str(tmp_path / "w"), keep=2),
        **kw)
    with pytest.raises(KeyboardInterrupt):
        senv.serve_checkpointed(app, spec, tspec, _Killer(
            CheckpointManager(str(tmp_path / "r"), keep=2), 1), **kw)
    resumed = senv.serve_checkpointed(
        app, spec, tspec, CheckpointManager(str(tmp_path / "r"), keep=2),
        **kw)
    for a, b in zip(whole, resumed):
        for f in a._fields:
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None and y is None) or torch.equal(x, y), f
    assert whole[0].wpack is not None


def test_serve_carries_and_trains_the_weights():
    """The port's mirror of
    ``tests/test_soc_nn.py::test_serve_carries_and_trains_the_weights``:
    a served stream trains the network in the carry (finite, moved), and
    a frozen network's stream leaves the weights bitwise untouched."""
    soc = TSOCS["SoC-motiv-par"]
    rng = np.random.default_rng(6)
    from repro_torch.soc.apps import make_phase
    from repro_torch.soc.des import Application
    phases = [make_phase(rng, soc, name=f"p{i}", n_threads=2,
                         size_classes=[c], chain_len=3, loops=2)
              for i, c in enumerate(("S", "M", "L"))]
    app = tvec.compile_app(Application(name="chain2", phases=phases), soc,
                           seed=7)
    env = tvec.VecEnv(soc, seed=0, device="cpu")
    senv = tvec.ServeEnv(env, n_requests=64)
    tspec = ttraffic.poisson(0.001, key=prng.PRNGKey(3))
    mlp = tnn.init_mlp_qstate(prng.PRNGKey(7))
    spec = tvec.mlp_policy_spec(mlp, app.schedule)
    carry, _, res = senv.serve(app, spec, tspec, cfg=tq.QConfig(
        decay_steps=64), key=prng.PRNGKey(1))
    assert int(res.executed.sum()) > 0
    assert bool(torch.isfinite(carry.wpack).all())
    assert bool((carry.wpack != mlp.wpack).any())
    fr = tvec.mlp_policy_spec(tnn.freeze(mlp), app.schedule)
    carry_f, _, _ = senv.serve(app, fr, tspec, key=prng.PRNGKey(1))
    assert torch.equal(carry_f.wpack, mlp.wpack)
