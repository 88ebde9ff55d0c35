"""The port's event-driven simulator (``repro_torch.soc.des``), its policies'
``decide``, the per-decision Q agent, sensing, monitors and the
self-contained timing model against repro's, on the CPU.

Both packages run the same cases from the same seeds (the port with
``device="cpu"``): SoC-motiv-par (12 accelerators, 2 memory tiles) and
SoC1 (7, 4) each running an 18-invocation single-thread chain app and a
36-invocation three-thread one under the four fixed modes, manual,
random, a Q agent trained over two runs, a Q agent frozen after them and
a perturbed MLP agent, plus fixed NON_COH, manual and a training Q agent
under ``storm(n, 1.0)``.  Every record's ``acc_id``, ``mode`` and
``state_idx`` must equal both reference builds' — the one jitted here and
the one compiled without fused multiply-add
(:func:`test_torch_serve.reference_without_fma`, ROADMAP C1).  Floats
(start, end, exec_time, both off-chip counts, reward, the phase
metrics and the trained table) must be bitwise the no-FMA build's, and
within rtol = 2e-6, atol = 1e-6 of the FMA build's (the reference
contracts ``a*b + c`` inside its jitted timing model, reward and update;
measured: 1.8e-6 relative on an attributed off-chip count, a difference
of two DDR counter readings, and 4.7e-7 on every other float).

The units: the timing model on random 32-slot concurrent sets (half of
them LLC-heavy), healthy and faulted (bitwise the no-FMA build, 2e-6
relative of the FMA build; these sets tell apart the summation orders
of the slot loads, ``invocation_perf``'s DDR and LLC lane counts),
``select``/``update`` over tie rows, masks and non-finite rows, the MLP
agent's decisions, ``observe_host``, ``attribute_ddr`` and
``MonitorBank`` (the last three eager in the reference, so bitwise).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import monitors as jmon, policies as jpol, qlearn as jq
from repro.core import state as jstate
from repro.soc import des as jdes, faults as jf, nn as jnn
from repro.soc.apps import make_phase as j_make_phase
from repro.soc.config import SOCS as JSOCS
from repro_torch import random as prng
from repro_torch.core import monitors as tmon, policies as tpol
from repro_torch.core import qlearn as tq, state as tstate
from repro_torch.soc import des as tdes, faults as tf, nn as tnn
from repro_torch.soc.apps import make_phase as t_make_phase
from repro_torch.soc.config import SOCS as TSOCS
from test_torch_serve import reference_without_fma

SOCS = ("SoC-motiv-par", "SoC1")
TILE_SEED = 7
TOL_FMA = dict(rtol=2e-6, atol=1e-6)
INT_FIELDS = ("acc_id", "mode", "state_idx")
FLOAT_FIELDS = ("footprint", "start", "end", "exec_time", "offchip_true",
                "offchip_attr", "reward")
N_SETS = 800


def _api(port: bool):
    """One namespace per package, so the same driver runs both."""
    if port:
        return types.SimpleNamespace(
            port=True, socs=TSOCS, des=tdes, pol=tpol, q=tq, nn=tnn,
            faults=tf, make_phase=t_make_phase, key=prng.PRNGKey,
            sim=lambda soc: tdes.SoCSimulator(soc, device="cpu"),
            qpolicy=lambda cfg, seed: tpol.QPolicy(cfg, seed=seed,
                                                   device="cpu"))
    return types.SimpleNamespace(
        port=False, socs=JSOCS, des=jdes, pol=jpol, q=jq, nn=jnn,
        faults=jf, make_phase=j_make_phase, key=jax.random.PRNGKey,
        sim=lambda soc: jdes.SoCSimulator(soc),
        qpolicy=lambda cfg, seed: jpol.QPolicy(cfg, seed=seed))


def _chain_app(api, soc, seed, n_threads=1):
    rng = np.random.default_rng(seed)
    phases = [api.make_phase(rng, soc, name=f"p{i}", n_threads=n_threads,
                             size_classes=[c], chain_len=3, loops=2)
              for i, c in enumerate(("S", "M", "L"))]
    return api.des.Application(name=f"{soc.name}-chain{n_threads}",
                               phases=phases)


def _mlp_weights(api, seed):
    """A default ("sense") network with every weight perturbed from a
    numpy seed, so its Q-rows are not all ties."""
    jm = jnn.MLPQPolicy(seed=seed)
    w = np.asarray(jm.mlp.wpack).copy()
    w += np.random.default_rng(seed).normal(0, 0.3, w.shape).astype(
        np.float32)
    if not api.port:
        jm.mlp = jm.mlp._replace(wpack=jnp.asarray(w))
        return jm
    mlp = tnn.mlp_from_numpy(w, np.asarray(jm.mlp.lr), np.asarray(
        jm.mlp.step), np.asarray(jm.mlp.frozen), jm.mlp.cfg)
    return tnn.MLPQPolicy(mlp)


def _record_run(out, tag, res):
    recs = [r for p in res.phases for r in p.invocations]
    for f in INT_FIELDS:
        out[f"{tag}/{f}"] = np.asarray([getattr(r, f) for r in recs],
                                       np.int64)
    for f in FLOAT_FIELDS:
        out[f"{tag}/{f}"] = np.asarray([getattr(r, f) for r in recs],
                                       np.float64)
    out[f"{tag}/wall_time"] = np.asarray([p.wall_time for p in res.phases])
    out[f"{tag}/offchip"] = np.asarray([p.offchip_accesses
                                        for p in res.phases])


def _qtable(api, qs):
    return (qs.qtable[0].numpy() if api.port else np.asarray(qs.qtable),
            qs.visits[0].numpy() if api.port else np.asarray(qs.visits),
            int(qs.step[0] if api.port else qs.step))


def _runs(api, out):
    for name in SOCS:
        soc = api.socs[name]
        sim = api.sim(soc)
        for n_threads in (1, 3):
            app = _chain_app(api, soc, seed=3, n_threads=n_threads)
            pre = f"{name}/t{n_threads}"
            pols = [(f"fixed{m}", api.pol.FixedHomogeneous(m))
                    for m in range(4)]
            pols += [("manual", api.pol.ManualPolicy()),
                     ("random", api.pol.RandomPolicy()),
                     ("mlp", _mlp_weights(api, 3))]
            for tag, pol in pols:
                _record_run(out, f"{pre}/{tag}",
                            sim.run(app, pol, seed=TILE_SEED, train=False))
            n = 18 * n_threads
            agent = api.qpolicy(api.q.QConfig(decay_steps=2 * n), 5)
            for it in range(2):
                _record_run(out, f"{pre}/qtrain{it}",
                            sim.run(app, agent, seed=TILE_SEED + it,
                                    train=True))
            (out[f"{pre}/qtable"], out[f"{pre}/visits"],
             out[f"{pre}/step"]) = _qtable(api, agent.qs)
            agent.freeze()
            _record_run(out, f"{pre}/qfrozen",
                        sim.run(app, agent, seed=TILE_SEED, train=False))
            storm = api.faults.storm(n, 1.0, api.key(42))
            for tag, pol in (("nc", api.pol.FixedHomogeneous(0)),
                             ("manual", api.pol.ManualPolicy()),
                             ("q", api.qpolicy(api.q.QConfig(
                                 decay_steps=n), 9))):
                _record_run(out, f"{pre}/storm-{tag}",
                            sim.run(app, pol, seed=TILE_SEED,
                                    train=tag == "q", faults=storm))


# ------------------------------------------------------------------ units
def _concurrent_sets(soc, pmat, seed):
    """Random 32-slot concurrent sets, the active slots first as the
    simulator fills them, and a fault row each.  Half have ``k`` in
    [0, 32] active slots of any mode; half are LLC-heavy (16 to 32
    cached-mode slots of small footprints on most tiles), where the LLC
    load's summation order shows in the times."""
    rng = np.random.default_rng(seed)
    nt, na = soc.n_mem_tiles, soc.n_accs
    S = jdes.MAX_SLOTS
    sets = []
    for i in range(N_SETS):
        heavy = i % 2 == 1
        k = int(rng.integers(16 if heavy else 0, S + 1))
        om = np.full(S, -1, np.int32)
        oa = np.zeros(S, np.int64)
        of = np.zeros(S, np.float32)
        ot = np.zeros((S, nt), bool)
        om[:k] = rng.integers(1 if heavy else 0, 4, k)
        oa[:k] = rng.integers(0, na, k)
        of[:k] = np.exp(rng.uniform(np.log(2**11),
                                    np.log(2**17 if heavy else 2**23), k))
        ot[:k] = rng.random((k, nt)) < (0.9 if heavy else 0.6)
        sets.append(dict(
            mode=int(rng.integers(0, 4)), acc=int(rng.integers(0, na)),
            fp=np.float32(np.exp(rng.uniform(np.log(2**11),
                                             np.log(2**23)))),
            tiles=rng.random(nt) < 0.6, om=om, oa=oa, of=of, ot=ot,
            warm=np.float32(rng.random()),
            fault=np.asarray([1 + 4 * rng.random(),
                              1 / (1 + 3 * rng.random()), 4 * rng.random(),
                              5000.0 * rng.integers(0, 4)], np.float32)))
    return sets


def _perf(api, name):
    """The timing model's five outputs on :func:`_concurrent_sets`,
    healthy then faulted: ``(2, N_SETS, 5)``."""
    soc = api.socs[name]
    sim = api.sim(soc)
    out = np.zeros((2, N_SETS, 5), np.float32)
    for i, c in enumerate(_concurrent_sets(soc, sim.pmat, 31)):
        for f, faulted in enumerate((False, True)):
            if api.port:
                fr = (tf.StepFault(*(torch.tensor([v]) for v in c["fault"]))
                      if faulted else None)
                slots = np.zeros((tdes.MAX_SLOTS, 3 + soc.n_mem_tiles),
                                 np.float32)
                slots[:, 0], slots[:, 1], slots[:, 2] = c["om"], c["oa"], \
                    c["of"]
                slots[:, 3:] = c["ot"]
                packed = np.concatenate([
                    np.asarray([c["mode"], c["acc"], c["fp"], c["warm"]],
                               np.float32),
                    c["tiles"].astype(np.float32), slots.reshape(-1)])
                out[f, i] = sim.perf_fn(packed, fr)
            else:
                fr = (jf.StepFault(*(jnp.float32(v) for v in c["fault"]))
                      if faulted else None)
                op = np.zeros((jdes.MAX_SLOTS, sim.pmat.shape[1]),
                              np.float32)
                act = c["om"] >= 0
                op[act] = sim.pmat[c["oa"][act]]
                o = sim.perf_fn(
                    jnp.int32(c["mode"]), jnp.asarray(sim.pmat[c["acc"]]),
                    jnp.float32(c["fp"]), jnp.asarray(c["tiles"]),
                    jnp.asarray(c["om"]), jnp.asarray(op),
                    jnp.asarray(c["of"]), jnp.asarray(c["ot"]),
                    jnp.float32(c["warm"]), fr)
                out[f, i] = [float(v) for v in o]
    return out


def _agent_rows():
    """A Q-table with an all-tie row, a near-tie row (within 1e-9), a
    NaN row, an inf row and random rows."""
    rng = np.random.default_rng(4)
    qt = rng.uniform(0, 1, (243, 4)).astype(np.float32)
    qt[0] = 1.0
    qt[1] = [1.0, np.float32(1.0) - np.float32(1e-10), 0.5, 1.0]
    qt[2, 1] = np.nan
    qt[3, 2] = np.inf
    qt[4] = [0.25, 0.75, 0.75, 0.1]
    return qt


MASKS = (np.ones(4, bool), np.asarray([1, 1, 1, 0], bool),
         np.asarray([1, 0, 0, 0], bool), np.asarray([1, 0, 1, 1], bool))


def _agent(api):
    """60 ``select``/``update`` steps over states 0..5 and four masks,
    rewards from a seed (every 13th NaN), with ``cfg`` a compile-time
    constant as the reference's QPolicy jits it; returns the actions and
    the final table, visits and step, then the frozen agent's actions."""
    cfg = jq.QConfig(decay_steps=50)
    rng = np.random.default_rng(8)
    rewards = rng.uniform(0, 1, 60).astype(np.float32)
    rewards[::13] = np.nan
    qt = _agent_rows()
    acts = []
    if api.port:
        qs = tq.qstate_from_numpy(qt, np.zeros((243, 4), np.int32), 0,
                                  False)
        key = prng.PRNGKey(3)
        for t in range(80):
            ks = prng.split(key)
            key, sub = ks[0], ks[1]
            s = torch.tensor([t % 6], dtype=torch.int32)
            m = torch.as_tensor(MASKS[t % 4])
            a = tq.select(qs, cfg, s, sub[None], m)
            acts.append(int(a[0]))
            if t == 59:
                table = (qs.qtable[0].numpy().copy(),
                         qs.visits[0].numpy().copy(), int(qs.step[0]))
                qs = tq.freeze(qs)
            if t < 60:
                qs = tq.update(qs, cfg, s, a, torch.tensor([rewards[t]]))
    else:
        qs = jq.init_qstate(cfg)._replace(qtable=jnp.asarray(qt))
        select = jax.jit(lambda qs, s, k, m: jq.select(qs, cfg, s, k, m))
        update = jax.jit(lambda qs, s, a, r: jq.update(qs, cfg, s, a, r))
        key = jax.random.PRNGKey(3)
        for t in range(80):
            key, sub = jax.random.split(key)
            s = jnp.int32(t % 6)
            a = select(qs, s, sub, jnp.asarray(MASKS[t % 4]))
            acts.append(int(a))
            if t == 59:
                table = (np.asarray(qs.qtable), np.asarray(qs.visits),
                         int(qs.step))
                qs = jq.freeze(qs)
            if t < 60:
                qs = update(qs, s, a, jnp.float32(rewards[t]))
    return np.asarray(acts), table


def _contexts(api, soc, n=48):
    """Random decision contexts on ``soc`` (0 to 6 active accelerators,
    some masks without FULLY_COH)."""
    rng = np.random.default_rng(12)
    out = []
    pmat = api.sim(soc).pmat
    for i in range(n):
        k = int(rng.integers(0, 7))
        acc = int(rng.integers(0, soc.n_accs))
        out.append(api.pol.DecisionContext(
            acc_id=acc, acc_name=f"a{acc}",
            footprint=float(np.exp(rng.uniform(np.log(2**10),
                                               np.log(2**23)))),
            state_idx=int(rng.integers(0, 243)),
            active_modes=[int(v) for v in rng.integers(0, 4, k)],
            active_footprint=0.0,
            available=MASKS[i % 2].tolist(), soc=soc,
            rng=np.random.default_rng(i),
            active_footprints=[float(v) for v in
                               rng.uniform(2**10, 2**22, k)],
            target_tiles=(rng.random(soc.n_mem_tiles) < 0.6).tolist(),
            profile=pmat[acc], warm=float(rng.random())))
    return out


def _mlp_decisions(api):
    out = {}
    for name in SOCS:
        soc = api.socs[name]
        ctxs = _contexts(api, soc)
        for seed in (1, 2):
            pol = _mlp_weights(api, seed)
            out[f"{name}/mlp{seed}"] = np.asarray(
                [int(pol.decide(c)) for c in ctxs])
        bad = _mlp_weights(api, 1)
        if api.port:
            w = bad.mlp.wpack.clone()
            w[0, 0, 0] = float("nan")
            bad.mlp = bad.mlp._replace(wpack=w)
        else:
            bad.mlp = bad.mlp._replace(
                wpack=bad.mlp.wpack.at[0, 0].set(jnp.nan))
        out[f"{name}/mlp-nan"] = np.asarray([int(bad.decide(c))
                                             for c in ctxs])
    return out


def _tables(port: bool) -> dict:
    api = _api(port)
    out = {}
    _runs(api, out)
    for name in SOCS:
        out[f"perf/{name}"] = _perf(api, name)
    acts, (qt, visits, step) = _agent(api)
    out.update({"agent/actions": acts, "agent/qtable": qt,
                "agent/visits": visits, "agent/step": step})
    out.update(_mlp_decisions(api))
    return out


def reference_tables() -> dict:
    """Every case through the reference (run in a process without FMA by
    the fixture below, and in this one)."""
    return _tables(False)


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """(reference as jitted here, reference without FMA, the port)."""
    jit_tab, nofma = reference_without_fma(
        "test_torch_des", "reference_tables",
        tmp_path_factory.mktemp("nofma"), meanwhile=reference_tables)
    return jit_tab, nofma, _tables(True)


CASES = [f"{soc}/t{t}/{c}" for soc in SOCS for t in (1, 3) for c in (
    "fixed0", "fixed1", "fixed2", "fixed3", "manual", "random", "mlp",
    "qtrain0", "qtrain1", "qfrozen", "storm-nc", "storm-manual",
    "storm-q")]


@pytest.mark.parametrize("case", CASES)
def test_run_record_by_record(tables, case):
    """``SoCSimulator.run``: integer traces equal to both builds, floats
    bitwise the no-FMA build and within TOL_FMA of the FMA build."""
    jit_tab, nofma, port = tables
    for f in INT_FIELDS:
        np.testing.assert_array_equal(port[f"{case}/{f}"],
                                      nofma[f"{case}/{f}"], err_msg=f)
        np.testing.assert_array_equal(port[f"{case}/{f}"],
                                      jit_tab[f"{case}/{f}"], err_msg=f)
    for f in FLOAT_FIELDS + ("wall_time", "offchip"):
        np.testing.assert_array_equal(port[f"{case}/{f}"],
                                      nofma[f"{case}/{f}"], err_msg=f)
        np.testing.assert_allclose(port[f"{case}/{f}"],
                                   jit_tab[f"{case}/{f}"], err_msg=f,
                                   **TOL_FMA)


@pytest.mark.parametrize("prefix", [f"{s}/t{t}" for s in SOCS
                                    for t in (1, 3)])
def test_trained_table(tables, prefix):
    """The Q agent trained through two runs: visits and step equal, the
    table bitwise the no-FMA build's."""
    jit_tab, nofma, port = tables
    for f in ("visits", "step"):
        np.testing.assert_array_equal(port[f"{prefix}/{f}"],
                                      jit_tab[f"{prefix}/{f}"])
    np.testing.assert_array_equal(port[f"{prefix}/qtable"],
                                  nofma[f"{prefix}/qtable"])
    np.testing.assert_allclose(port[f"{prefix}/qtable"],
                               jit_tab[f"{prefix}/qtable"], **TOL_FMA)


@pytest.mark.parametrize("name", SOCS)
def test_invocation_perf(tables, name):
    """The self-contained timing model on 32-slot concurrent sets (up to
    32 active), healthy and faulted."""
    jit_tab, nofma, port = tables
    got = port[f"perf/{name}"]
    np.testing.assert_array_equal(got, nofma[f"perf/{name}"])
    np.testing.assert_allclose(got, jit_tab[f"perf/{name}"], rtol=2e-6)


def test_select_and_update(tables):
    """The per-decision agent over tie rows, masks, a NaN and an inf row
    and NaN rewards, then frozen: actions equal, the table bitwise the
    no-FMA build's."""
    jit_tab, nofma, port = tables
    np.testing.assert_array_equal(port["agent/actions"],
                                  jit_tab["agent/actions"])
    np.testing.assert_array_equal(port["agent/actions"],
                                  nofma["agent/actions"])
    acts = port["agent/actions"]
    assert set(acts[2::6]) == {0}          # the NaN row falls back
    assert set(acts[3::6]) == {0}          # the inf row too
    assert len(set(acts[0::6])) >= 2       # an all-tie row breaks at random
    for f in ("visits", "step"):
        np.testing.assert_array_equal(port[f"agent/{f}"],
                                      jit_tab[f"agent/{f}"])
    np.testing.assert_array_equal(port["agent/qtable"],
                                  nofma["agent/qtable"])
    np.testing.assert_allclose(port["agent/qtable"], jit_tab["agent/qtable"],
                               **TOL_FMA)


@pytest.mark.parametrize("name", SOCS)
def test_mlp_decide(tables, name):
    """``MLPQPolicy.decide``: the greedy masked argmax of two perturbed
    networks, and NON_COH from a network with a NaN weight."""
    jit_tab, nofma, port = tables
    for tag in ("mlp1", "mlp2", "mlp-nan"):
        k = f"{name}/{tag}"
        np.testing.assert_array_equal(port[k], jit_tab[k], err_msg=tag)
        np.testing.assert_array_equal(port[k], nofma[k], err_msg=tag)
    assert set(port[f"{name}/mlp-nan"]) == {0}
    assert len(set(port[f"{name}/mlp1"])) >= 2


@pytest.mark.parametrize("name", SOCS)
def test_observe_host(name):
    """``observe_host`` on random in-flight sets (none to six active), the
    footprints rounding to float32 as the reference's do."""
    soc = TSOCS[name]
    rng = np.random.default_rng(5)
    states = set()
    for _ in range(150):
        k = int(rng.integers(0, 7))
        kw = dict(active_modes=[int(v) for v in rng.integers(0, 4, k)],
                  active_footprints=[float(v) for v in np.exp(
                      rng.uniform(np.log(2**10), np.log(2**22), k))],
                  needed_tiles=[(rng.random(soc.n_mem_tiles) < 0.6).tolist()
                                for _ in range(k)],
                  target_tiles=(rng.random(soc.n_mem_tiles) < 0.6).tolist(),
                  target_footprint=float(np.exp(rng.uniform(
                      np.log(2**10), np.log(2**22)))))
        want = jstate.observe_host(geom=JSOCS[name].geometry, **kw)
        got = tstate.observe_host(geom=soc.geometry, device="cpu", **kw)
        assert got == want, kw
        states.add(got)
    assert len(states) > 20


def test_attribute_ddr_and_monitor_bank():
    """The proportional attribution (float32, tiles with no footprint
    included) and the counter bank's windows."""
    rng = np.random.default_rng(6)
    for _ in range(20):
        n_accs, n_tiles = int(rng.integers(1, 9)), int(rng.integers(1, 5))
        ddr = rng.uniform(0, 1e5, n_tiles)
        fps = rng.uniform(0, 1e6, (n_accs, n_tiles)) * (
            rng.random((n_accs, n_tiles)) < 0.7)
        np.testing.assert_array_equal(
            tmon.attribute_ddr(ddr, fps).numpy(),
            np.asarray(jmon.attribute_ddr(ddr, fps)))
    banks = (jmon.MonitorBank(5, 3), tmon.MonitorBank(5, 3))
    for _ in range(12):
        acc = int(rng.integers(0, 5))
        tot, comm = float(rng.uniform(1e3, 1e6)), float(rng.uniform(0, 1e5))
        per_tile = rng.uniform(0, 1e4, 3)
        fps = rng.uniform(0, 1e6, (5, 3))
        got = []
        for bank in banks:
            before = bank.snapshot_ddr()
            bank.record_invocation(acc, tot, comm, per_tile)
            got.append(bank.attributed_accesses(
                before, bank.snapshot_ddr(), acc, fps))
        assert got[0] == got[1]
    for f in ("ddr_accesses", "acc_cycles", "comm_cycles"):
        np.testing.assert_array_equal(getattr(banks[1], f),
                                      getattr(banks[0], f))


def test_fixed_policies_decide():
    """The fixed, heterogeneous, manual and random ``decide`` on the same
    contexts (random draws from the context's generator)."""
    for name in SOCS:
        jc, tc = _contexts(_api(False), JSOCS[name]), _contexts(
            _api(True), TSOCS[name])
        jsuite = (jpol.all_fixed_policies()
                  + [jpol.FixedHeterogeneous({"a1": 3, "a2": 2}),
                     jpol.ManualPolicy(), jpol.RandomPolicy()])
        tsuite = (tpol.all_fixed_policies()
                  + [tpol.FixedHeterogeneous({"a1": 3, "a2": 2}),
                     tpol.ManualPolicy(), tpol.RandomPolicy()])
        for jp, tp in zip(jsuite, tsuite):
            assert jp.name == tp.name
            assert ([int(tp.decide(c)) for c in tc]
                    == [int(jp.decide(c)) for c in jc]), tp.name


def test_simulator_needs_a_device():
    """``device=None`` means the card: without one the simulator raises."""
    if torch.cuda.is_available():
        assert tdes.SoCSimulator(TSOCS["SoC1"]).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tdes.SoCSimulator(TSOCS["SoC1"])
