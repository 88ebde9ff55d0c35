"""The port's data-parallel wrappers (``repro_torch.soc.shard``) against
the plain calls and against repro's ``soc.shard``, on the CPU.

The lanes and apps of ``tests/test_torch_stacked.py`` (SOC_MOTIV_ISO,
SoC1, SoC2; two-thread apps of 2, 3 and 2 phases): two training
iterations of (3 lanes x 2 agents) with per-lane decay horizons and an
evaluation app, six policies (the four fixed modes, random, manual) on
every lane, serving 32 requests to 2 learned agents a lane, and a
single-SoC ``VecEnv`` training 4 agents.  Split over ``[cpu, cpu]`` with
``force=True`` each wrapper must equal the plain call bitwise, and make
one call per chunk; with one device, or a batch that does not divide
the device count, it makes the plain call once.  Against the reference's
wrappers (which fall back to ``vmap`` on one host device) the split
results must give equal integer traces and floats within rtol = atol =
2e-5 of the build without fused multiply-add, and equal integer traces
against the reference as jitted here, as ``test_torch_stacked.py``
holds the plain calls.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policies as jpol, qlearn as jq, rewards as jr
from repro.soc import shard as jshard, stacked as jstk, traffic as jtraffic
from repro.soc import vecenv as jvec
from repro.soc.apps import make_phase as j_make_phase
from repro.soc.config import SOCS as JSOCS
from repro.soc.des import Application as JApp, SoCSimulator
from repro_torch import random as prng
from repro_torch.core import policies as tpol, qlearn as tq, rewards as tr
from repro_torch.soc import shard as tshard, stacked as tstk
from repro_torch.soc import traffic as ttraffic, vecenv as tvec
from repro_torch.soc.apps import make_phase as t_make_phase
from repro_torch.soc.config import SOCS as TSOCS
from repro_torch.soc.des import Application as TApp
from test_torch_serve import reference_without_fma
from test_torch_stacked import (ITERS, N_REQ, NAMES, SERVE_KW, W, _apps,
                                _assert_tree, _flat, _sub)

CPU2 = ["cpu", "cpu"]


def _suite(pol):
    """Six policies on every lane: the four fixed modes, random, manual."""
    return [pol.FixedHomogeneous(m) for m in range(4)] + [
        pol.RandomPolicy(), pol.ManualPolicy()]


def _single_app(make_phase, app_cls, soc):
    rng = np.random.default_rng(3)
    phases = [make_phase(rng, soc, name=f"p{i}", n_threads=2,
                         size_classes=[c], chain_len=3, loops=1)
              for i, c in enumerate(("S", "L"))]
    return app_cls(name="single", phases=phases)


def reference_tables() -> dict:
    """The reference's four wrappers on this file's inputs."""
    jsocs = [JSOCS[n] for n in NAMES]
    env = jstk.StackedVecEnv.from_simulators(
        [SoCSimulator(s, seed=1) for s in jsocs])
    apps = _apps(j_make_phase, JApp, jsocs)
    iters = [env.compile(apps, seed=it) for it in range(ITERS)]
    ev = env.compile(apps, seed=9)
    cfg = jq.QConfig(decay_steps=jnp.asarray(
        [s * ITERS for s in iters[0].n_steps], jnp.int32))
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(6)).reshape(3, 2, 2)
    out = {}
    qs, hist = jshard.sharded_train_batched_stacked(
        env, iters, cfg, jr.stack_weights(W), keys, eval_stacked=ev)
    _flat("train", qs, out)
    out["hist/t"], out["hist/m"] = map(np.asarray, hist)
    _flat("ep", jshard.sharded_episodes(env, ev, env.lower(ev, _suite(jpol)),
                                        cfg), out)
    _, sq, sres = jshard.sharded_serve(
        env, ev, env.lower_qstates(ev, qs, freeze=False),
        jtraffic.bursty(**SERVE_KW), cfg, queue_cap=4, n_requests=N_REQ)
    _flat("serve", sres, out)
    _flat("serveq", sq, out)
    soc = JSOCS["SoC1"]
    venv = jvec.VecEnv(soc, seed=1)
    app = jvec.compile_app(_single_app(j_make_phase, JApp, soc), soc, seed=2)
    vcfg = jq.QConfig(decay_steps=2 * app.n_steps)
    vq, vh = jshard.sharded_train_batched(
        venv, [app, app], vcfg, jr.stack_weights(W * 2),
        jax.vmap(jax.random.PRNGKey)(jnp.arange(4)), eval_app=app)
    _flat("vtrain", vq, out)
    out["vhist/t"], out["vhist/m"] = map(np.asarray, vh)
    return out


def _inputs():
    tsocs = [TSOCS[n] for n in NAMES]
    env = tstk.StackedVecEnv(tsocs, seed=1, device="cpu")
    apps = _apps(t_make_phase, TApp, tsocs)
    iters = [env.compile(apps, seed=it) for it in range(ITERS)]
    ev = env.compile(apps, seed=9)
    cfg = tq.QConfig(decay_steps=torch.tensor(
        [s * ITERS for s in iters[0].n_steps], dtype=torch.int32))
    keys = prng.PRNGKey(np.arange(6)).reshape(3, 2, 2)
    soc = TSOCS["SoC1"]
    venv = tvec.VecEnv(soc, seed=1, device="cpu")
    app = tvec.compile_app(_single_app(t_make_phase, TApp, soc), soc,
                           seed=2)
    return env, iters, ev, cfg, keys, venv, app


def _calls(inputs, **kw):
    """Every wrapper's result with ``kw`` (devices, force), and the
    stacked environment's call counts."""
    env, iters, ev, cfg, keys, venv, app = inputs
    env.calls.clear()
    out = {}
    out["train"], out["hist"] = tshard.sharded_train_batched_stacked(
        env, iters, cfg, tr.stack_weights(W), keys, eval_stacked=ev, **kw)
    out["ep"] = tshard.sharded_episodes(env, ev, env.lower(ev, _suite(tpol)),
                                        cfg, **kw)
    _, out["serveq"], out["serve"] = tshard.sharded_serve(
        env, ev, env.lower_qstates(ev, out["train"], freeze=False),
        ttraffic.bursty(**SERVE_KW), cfg, queue_cap=4, n_requests=N_REQ,
        **kw)
    out["vtrain"], out["vhist"] = tshard.sharded_train_batched(
        venv, [app, app], tq.QConfig(decay_steps=2 * app.n_steps),
        tr.stack_weights(W * 2), prng.PRNGKey(np.arange(4)), eval_app=app,
        **kw)
    out["calls"] = dict(env.calls)
    return out


def _leaves(x):
    if torch.is_tensor(x):
        return [x]
    return [v for item in x for v in _leaves(item)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(plain calls, forced split over [cpu, cpu], reference without FMA,
    reference as jitted here)."""
    inputs = _inputs()
    (plain, split, here), nofma = reference_without_fma(
        "test_torch_shard", "reference_tables",
        tmp_path_factory.mktemp("nofma"),
        meanwhile=lambda: (_calls(inputs, devices=["cpu"]),
                           _calls(inputs, devices=CPU2, force=True),
                           reference_tables()))
    return plain, split, nofma, here


@pytest.mark.parametrize("name", ["train", "hist", "ep", "serve", "serveq",
                                  "vtrain", "vhist"])
def test_forced_split_is_bitwise(runs, name):
    """Two chunks on two CPU devices equal one plain call bit for bit."""
    plain, split = runs[:2]
    a, b = _leaves(plain[name]), _leaves(split[name])
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.shape == y.shape and torch.equal(x, y), name


def test_fallback_and_split_call_counts(runs):
    """One device makes each stacked call once; the split makes it once
    per chunk."""
    plain, split = runs[:2]
    assert plain["calls"] == {"train": 1, "episodes": 2, "serve": 1}
    # the split's evaluation baseline is one episodes call per chunk too
    assert split["calls"] == {"train": 2, "episodes": 4, "serve": 2}


def test_indivisible_batch_falls_back():
    """Seven policies over two devices (and one device without
    ``force``) make the plain call: one episodes call, the same result."""
    env, _, ev, cfg, _, _, _ = _inputs()
    specs = env.lower(ev, _suite(tpol) + [tpol.ManualPolicy()])
    ref = env.episodes(ev, specs, cfg)
    for kw in (dict(devices=CPU2), dict(devices=CPU2, force=True),
               dict(devices=["cpu"])):
        env.calls.clear()
        got = tshard.sharded_episodes(env, ev, specs, cfg, **kw)
        assert dict(env.calls) == {"episodes": 1}
        for x, y in zip(ref, got):
            assert torch.equal(x, y)
    assert tshard.lane_devices(CPU2) == [torch.device("cpu")] * 2
    assert tshard.lane_devices() == [torch.device("cuda", i) for i in
                                     range(torch.cuda.device_count())]


@pytest.mark.parametrize("a,b,same", [
    ("cpu", "cpu", True), ("cuda", "cuda:0", True), ("cuda:0", "cuda", True),
    ("cuda:1", "cuda", False), ("cuda:1", "cuda:1", True),
    ("cuda:0", "cpu", False)])
def test_same_device_reads_missing_index_as_current(monkeypatch, a, b,
                                                    same):
    """``cuda`` (what ``resolve_device`` gives an environment) and
    ``cuda:0`` (what ``lane_devices`` lists) are one card when card 0 is
    the current one, so a split reuses the environment there."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert tshard._same_device(a, b) is same
    assert tshard._same_device(b, a) is same


def test_env_reused_on_its_own_device():
    soc = TSOCS["SoC1"]
    for env in (tstk.StackedVecEnv([soc], seed=1, device="cpu"),
                tvec.VecEnv(soc, seed=1, device="cpu")):
        assert tshard._env_on(env, torch.device("cpu")) is env


@pytest.mark.parametrize("prefix,name", [
    ("train", "train"), ("ep", "ep"), ("serve", "serve"),
    ("serveq", "serveq"), ("vtrain", "vtrain")])
def test_wrappers_match_reference(runs, prefix, name):
    """The split results against the reference's wrappers: all fields
    within 2e-5 of the no-FMA build, integer fields equal to the FMA
    build."""
    _, split, nofma, here = runs
    _assert_tree(split[name], _sub(nofma, prefix), name)
    _assert_tree(split[name], _sub(here, prefix), f"{name} (FMA)",
                 ints_only=True)


@pytest.mark.parametrize("name", ["hist", "vhist"])
def test_split_histories_match_reference(runs, name):
    _, split, nofma, _ = runs
    for got, f in zip(split[name], ("t", "m")):
        np.testing.assert_allclose(got.numpy(), nofma[f"{name}/{f}"],
                                   rtol=2e-5, atol=2e-5)
