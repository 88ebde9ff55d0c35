"""The port's stacked multi-SoC environment and vecenv profiling against
repro's, on the CPU.

Three deliberately different lanes — SOC_MOTIV_ISO, SoC1, SoC2 (12/7/9
accelerators, 2/4/2 memory tiles) — run two-thread applications of
different phase counts and lengths, so every padding axis is real.  The
pad and bucket helpers must be exact; stacked episodes (a mixed policy
suite), batched training with per-lane decay horizons, frozen evaluation
and stacked serving must give equal integer traces and floats within
rtol = atol = 2e-5; the profiled heterogeneous assignment must be equal.
Every result is held against the reference compiled without fused
multiply-add (``test_torch_serve.reference_without_fma``, ROADMAP C1), and
its integer traces, visits, steps and assignments also against the
reference as jitted on this host: there two Q-table entries of the
training run differ by up to 0.06 through a contracted reward, while
every integer column is equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import orchestrator as jorch, qlearn as jq, rewards as jr
from repro.core import policies as jpol
from repro.soc import stacked as jstk, traffic as jtraffic
from repro.soc.apps import make_phase as j_make_phase
from repro.soc.config import SOCS as JSOCS
from repro.soc.des import Application as JApp, SoCSimulator
from repro_torch import random as prng
from repro_torch.core import orchestrator as torch_orch, qlearn as tq
from repro_torch.core import policies as tpol, rewards as tr
from repro_torch.soc import stacked as tstk, traffic as ttraffic, vecenv as tvec
from repro_torch.soc.apps import make_phase as t_make_phase
from repro_torch.soc.config import SOCS as TSOCS
from repro_torch.soc.des import Application as TApp
from test_torch_serve import reference_without_fma

TOL = dict(rtol=2e-5, atol=2e-5)
NAMES = ["SoC-motiv-iso", "SoC1", "SoC2"]
N_PHASES = (2, 3, 2)
ITERS = 2
N_REQ = 32
PROFILED = ("SoC1", "SoC3")
SERVE_KW = dict(rate=2e-5, mix=(0.7, 0.3), deadline=(20000.0, 0.0),
                priority=(1.0, 0.25), backoff=500.0, overload_frac=0.35,
                prio_reserve=0.25, seed=5)
W = [(0.675, 0.075, 0.25), (0.2, 0.2, 0.6)]


def _apps(make_phase, app_cls, socs):
    apps = []
    for i, (soc, n_ph) in enumerate(zip(socs, N_PHASES)):
        rng = np.random.default_rng(20 + i)
        phases = [make_phase(rng, soc, name=f"p{j}", n_threads=2,
                             size_classes=[c], chain_len=2, loops=1 + i % 2)
                  for j, c in enumerate(("S", "M", "L")[:n_ph])]
        apps.append(app_cls(name=f"{soc.name}-stk", phases=phases))
    return apps


def _assert_tree(port, ref, name, ints_only=False):
    """``ref`` is a NamedTuple, or a dict of arrays keyed by ``port``'s
    field names; ``ints_only`` compares the integer fields alone."""
    fields = port._fields if isinstance(ref, dict) else ref._fields
    for f in fields:
        a = getattr(port, f)
        a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
        b = np.asarray(ref[f] if isinstance(ref, dict) else getattr(ref, f))
        if np.issubdtype(b.dtype, np.floating):
            if not ints_only:
                np.testing.assert_allclose(a, b, err_msg=f"{name}.{f}",
                                           **TOL)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{name}.{f}")


@pytest.fixture(scope="module")
def envs():
    jsocs = [JSOCS[n] for n in NAMES]
    tsocs = [TSOCS[n] for n in NAMES]
    jenv = jstk.StackedVecEnv.from_simulators(
        [SoCSimulator(s, seed=1) for s in jsocs])
    tenv = tstk.StackedVecEnv(tsocs, seed=1, device="cpu")
    return (jsocs, jenv, _apps(j_make_phase, JApp, jsocs),
            tsocs, tenv, _apps(t_make_phase, TApp, tsocs))


def test_pad_and_bucket_helpers_exact(envs):
    jsocs, jenv, japps, tsocs, tenv, tapps = envs
    js, ts = jenv.compile(japps, seed=[4, 5, 6]), tenv.compile(tapps,
                                                               [4, 5, 6])
    _assert_tree(ts.schedule, js.schedule, "schedule")
    assert ts.n_steps == js.n_steps and ts.n_threads == js.n_threads
    assert (ts.n_phases, ts.n_tiles) == (js.n_phases, js.n_tiles)
    np.testing.assert_array_equal(ts.phase_mask.numpy(),
                                  np.asarray(js.phase_mask))
    assert tstk.padded_waste(ts) == jstk.padded_waste(js)
    _assert_tree(tstk.pad_compiled(ts.compiled[1], 80, 3, 5),
                 jstk.pad_compiled(js.compiled[1], 80, 3, 5), "pad")
    rng = np.random.default_rng(0)
    for _ in range(40):
        lens = rng.integers(1, 400, rng.integers(1, 12)).tolist()
        for mb in (1, 2, 3, 5):
            assert (tstk.length_buckets(lens, max_buckets=mb, min_gain=0.02)
                    == jstk.length_buckets(lens, max_buckets=mb,
                                           min_gain=0.02))
    jb = jstk.compile_apps_bucketed(japps, jsocs, seed=3, max_buckets=3,
                                    min_gain=0.0)
    tb = tstk.compile_apps_bucketed(tapps, tsocs, seed=3, max_buckets=3,
                                    min_gain=0.0)
    assert [g for g, _ in tb] == [g for g, _ in jb]
    for (_, t), (_, j) in zip(tb, jb):
        _assert_tree(t.schedule, j.schedule, "bucket")
    groups = [g for g, _ in jb]
    parts = [{"x": rng.normal(size=(len(g), 3)).astype(np.float32)}
             for g in groups]
    np.testing.assert_array_equal(
        tstk.reassemble_lanes(groups, [{"x": torch.from_numpy(p["x"])}
                                       for p in parts])["x"],
        np.asarray(jstk.reassemble_lanes(groups, parts)["x"]))
    with pytest.raises(ValueError):
        tstk.reassemble_lanes([[0], [0]], parts[:2])


def _suites(pol, modes, envs_k):
    """Per lane: the 4 fixed modes, a heterogeneous assignment, random
    and manual."""
    return [[pol.FixedHomogeneous(modes(m)) for m in range(4)]
            + [pol.FixedHeterogeneous({p.name: modes(3 if i % 2 else 1)
                                       for i, p in enumerate(e.profiles)}),
               pol.RandomPolicy(), pol.ManualPolicy()]
            for e in envs_k]


def _flat(prefix, tree, out):
    for f in tree._fields:
        out[f"{prefix}/{f}"] = np.asarray(getattr(tree, f))


def _sub(tab, prefix):
    return {k[len(prefix) + 1:]: v for k, v in tab.items()
            if k.startswith(prefix + "/")}


def reference_tables() -> dict:
    """The reference's stacked episodes, training, evaluation, serving and
    profiling on this file's lanes, as numpy arrays."""
    from repro.core.modes import CoherenceMode
    jsocs = [JSOCS[n] for n in NAMES]
    jenv = jstk.StackedVecEnv.from_simulators(
        [SoCSimulator(s, seed=1) for s in jsocs])
    japps = _apps(j_make_phase, JApp, jsocs)
    out = {}
    js = jenv.compile(japps, seed=4)
    specs = jenv.lower(js, _suites(jpol, CoherenceMode, jenv.envs))
    _flat("ep", jenv.episodes(js, specs), out)
    iters = [jenv.compile(japps, seed=it) for it in range(ITERS)]
    ev = jenv.compile(japps, seed=9)
    cfg = jq.QConfig(decay_steps=jnp.asarray(
        [s * ITERS for s in iters[0].n_steps], jnp.int32))
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(6)).reshape(3, 2, 2)
    qs, hist = jenv.train_batched(iters, cfg, jr.stack_weights(W), keys,
                                  eval_stacked=ev)
    _flat("train", qs, out)
    out["hist/t"], out["hist/m"] = map(np.asarray, hist)
    out["eval/t"], out["eval/m"] = map(np.asarray,
                                       jenv.evaluate_batched(ev, qs, cfg))
    _, sq, sres = jenv.serve(ev, jenv.lower_qstates(ev, qs, freeze=False),
                             jtraffic.bursty(**SERVE_KW), cfg, queue_cap=4,
                             n_requests=N_REQ)
    _flat("serve", sres, out)
    _flat("serveq", sq, out)
    for name in PROFILED:
        het = jorch.profile_fixed_heterogeneous(
            SoCSimulator(JSOCS[name], seed=1), backend="vecenv")
        out[f"profile/{name}"] = np.array(
            [f"{k}={int(v)}" for k, v in sorted(het.assignment.items())])
    return out


def port_results(envs) -> dict:
    """The port's side of every comparison below, on the same lanes."""
    _, _, _, _, tenv, tapps = envs
    out = {}
    ts = tenv.compile(tapps, seed=4)
    out["ep"] = tenv.episodes(ts, tenv.lower(ts, _suites(tpol, int,
                                                         tenv.envs)))
    iters = [tenv.compile(tapps, seed=it) for it in range(ITERS)]
    ev = tenv.compile(tapps, seed=9)
    cfg = tq.QConfig(decay_steps=torch.tensor(
        [s * ITERS for s in iters[0].n_steps], dtype=torch.int32))
    keys = prng.PRNGKey(np.arange(6)).reshape(3, 2, 2)
    qs, out["hist"] = tenv.train_batched(iters, cfg, tr.stack_weights(W),
                                         keys, eval_stacked=ev)
    out["train"] = qs
    out["eval"] = tenv.evaluate_batched(ev, qs, cfg)
    _, out["serveq"], out["serve"] = tenv.serve(
        ev, tenv.lower_qstates(ev, qs, freeze=False),
        ttraffic.bursty(**SERVE_KW), cfg, queue_cap=4, n_requests=N_REQ)
    out["calls"] = dict(tenv.calls)
    for name in PROFILED:
        out[f"suite/{name}"] = torch_orch.standard_policy_suite(
            tvec.VecEnv(TSOCS[name], seed=1, device="cpu"))
    return out


@pytest.fixture(scope="module")
def runs(envs, tmp_path_factory):
    """(port results, reference tables without FMA, reference tables as
    jitted here); the last two are computed concurrently."""
    (port, here), nofma = reference_without_fma(
        "test_torch_stacked", "reference_tables",
        tmp_path_factory.mktemp("nofma"),
        meanwhile=lambda: (port_results(envs), reference_tables()))
    return port, nofma, here


def _assert_both(port, nofma, here, prefix, name):
    """All fields against the no-FMA build, integer fields also against
    the reference as jitted here."""
    _assert_tree(port, _sub(nofma, prefix), name)
    _assert_tree(port, _sub(here, prefix), f"{name} (FMA)", ints_only=True)


def test_episodes_match_reference(runs):
    port, nofma, here = runs
    _assert_both(port["ep"], nofma, here, "ep", "episodes")
    # the suite, training's baseline, evaluation's baseline and agents
    assert port["calls"]["episodes"] == 4


def test_train_batched_matches_reference(runs):
    port, ref, here = runs
    qs, hist = port["train"], port["hist"]
    _assert_both(qs, ref, here, "train", "qstate")
    assert int(qs.step.min()) > 0
    np.testing.assert_allclose(hist[0].numpy(), ref["hist/t"], **TOL)
    np.testing.assert_allclose(hist[1].numpy(), ref["hist/m"], **TOL)
    assert port["calls"]["train"] == 1


def test_evaluate_batched_matches_reference(runs):
    port, ref, _ = runs
    nt, nm = port["eval"]
    np.testing.assert_allclose(nt.numpy(), ref["eval/t"], **TOL)
    np.testing.assert_allclose(nm.numpy(), ref["eval/m"], **TOL)


def test_serve_matches_reference(runs):
    """Stacked serving of the trained agents, still learning: rows sampled
    over each lane's real length, one offered stream for every lane."""
    port, nofma, here = runs
    _assert_both(port["serve"], nofma, here, "serve", "serve")
    _assert_both(port["serveq"], nofma, here, "serveq", "serve.qstate")
    assert 0 < float(port["serve"].executed.float().mean()) < 1.0
    assert port["calls"]["serve"] == 1


@pytest.mark.parametrize("name", PROFILED)
def test_profile_fixed_heterogeneous_matches_reference(name, runs):
    port, nofma, here = runs
    suite = port[f"suite/{name}"]
    assert [p.name for p in suite] == [
        tpol.FixedHomogeneous(m).name for m in range(4)] + [
            "fixed-heterogeneous", "random", "manual"]
    got = [f"{k}={int(v)}" for k, v in sorted(suite[4].assignment.items())]
    assert got == nofma[f"profile/{name}"].tolist()
    assert got == here[f"profile/{name}"].tolist()


def test_faults_and_mlp_raise(envs):
    """(Named when MLP serving raised.)  MLP agents lower onto the lanes
    (``lower_mlps``) and run episodes and serving (their agreement with the
    reference is in ``tests/test_torch_nn.py`` and
    ``tests/test_torch_serve_mlp.py``); fault specs, which raised before A9 was
    ported, are taken by every stacked and serving entry point: a zero
    spec gives the healthy result bitwise (the storm cases are in
    ``tests/test_torch_faults.py``)."""
    from repro_torch.soc import faults as tfaults
    tenv, tapps = envs[4], envs[5]
    ts = tenv.compile(tapps, seed=4)
    specs = tenv.lower(ts, [tpol.ManualPolicy()])
    zero = tfaults.no_faults()
    for a, b in zip(tenv.episodes(ts, specs, faults=zero),
                    tenv.episodes(ts, specs)):
        assert torch.equal(a, b)
    tspec = ttraffic.poisson(1e-5)
    for a, b in zip(tenv.serve(ts, specs, tspec, faults=zero, n_requests=8)[2],
                    tenv.serve(ts, specs, tspec, n_requests=8)[2]):
        assert torch.equal(a, b)
    from repro_torch import random as tprng
    from repro_torch.soc import nn as tnn
    k = ts.schedule.acc_id.shape[0]
    mlps = tnn.init_mlp_qstate(tprng.PRNGKey(np.arange(k)))
    mlps = tnn.MLPQState(*(v[:, None] for v in mlps[:4]), cfg=mlps.cfg)
    mspecs = tenv.lower_mlps(ts, mlps)
    res = tenv.episodes(ts, mspecs)
    assert res.mode.shape[:2] == (k, 1)
    assert bool(torch.isfinite(res.phase_time).all())
    carry, qs, sres = tenv.serve(ts, mspecs, tspec, n_requests=8)
    assert carry.wpack.shape == mlps.wpack.shape
    assert sres.executed.shape == (k, 1, 8)
    assert bool(qs.frozen.all())
    serve_env = tvec.ServeEnv(tenv.envs[0], queue_cap=2, n_requests=4)
    one = tnn.MLPQState(*(v[0] for v in mlps[:4]), cfg=mlps.cfg)
    c0 = serve_env.init_carry(tq.init_qstate(), mlp=one,
                              qfun=torch.ones((), dtype=torch.bool))
    assert torch.equal(c0.wpack, one.wpack)
    _, _, res = serve_env.serve(ts.compiled[0], tpol.ManualPolicy().lower(
        tenv.envs[0], ts.compiled[0]), tspec, faults=zero)
    assert res.executed.shape == (4,)
