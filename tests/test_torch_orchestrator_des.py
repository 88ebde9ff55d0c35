"""The port's experiment drivers on the event-driven backend, and the
port's simulator against its own batched environment, on the CPU.

Against repro (same seeds; the port with ``device="cpu"``):
``run_isolated`` over accelerators, modes and sizes,
``profile_fixed_heterogeneous(backend="des")`` on SoC1,
``train_cohmeleon`` on SoC-motiv-par (2 iterations of a 2-phase app,
evaluated after each), ``compare_policies`` on both backends with the
trained agent in the suite, ``mode_breakdown`` of each run,
``episode_to_runresult`` (the batched backend's records) and
``VecEnv.train`` (one agent).  Assignments, modes, states, visits and
steps must be equal to the reference jitted here and to the one compiled
without fused multiply-add (``test_torch_serve.reference_without_fma``);
floats bitwise the no-FMA build's and within rtol = 2e-6, atol = 1e-6 of
the FMA build's (measured: 4.9e-7 relative on an attributed off-chip
count, 2.6e-7 on a reward, 1.2e-7 absolute on the trained tables).

The port's own fidelity contract mirrors ``tests/test_vecenv_equivalence.
py``: on single-thread chain apps the simulator and the batched
environment give equal modes and sensed states and per-phase times within
rtol = 1e-4; NON_COH off-chip counts are exact on a two-thread app; and
``compare_policies``' two backends agree to 1e-3.
"""
import jax
import numpy as np
import pytest

from repro.core import orchestrator as jorch, policies as jpol
from repro.core import qlearn as jq
from repro.soc import des as jdes, vecenv as jvec
from repro.soc.apps import make_application as j_make_app
from repro.soc.apps import make_phase as j_make_phase
from repro.soc.config import SOCS as JSOCS
from repro_torch import random as prng
from repro_torch.core import orchestrator as torch_orch
from repro_torch.core import policies as tpol, qlearn as tq
from repro_torch.core.modes import CoherenceMode
from repro_torch.soc import des as tdes, vecenv as tvec
from repro_torch.soc.apps import make_application as t_make_app
from repro_torch.soc.apps import make_phase as t_make_phase
from repro_torch.soc.config import (SOC_MOTIV_ISO, SOC_MOTIV_PAR, SOC1,
                                    SOCS as TSOCS)
from test_torch_serve import reference_without_fma

TILE_SEED = 7
TOL_FMA = dict(rtol=2e-6, atol=1e-6)
ISOLATED = [(acc, mode, fp) for acc in (0, 3, 6) for mode in range(4)
            for fp in (16 << 10, 256 << 10, 4 << 20)]


def _chain_app(make_phase, app_cls, soc, seed, n_threads=1):
    """Small app: every phase is ``n_threads`` serial accelerator chains."""
    rng = np.random.default_rng(seed)
    phases = [make_phase(rng, soc, name=f"p{i}", n_threads=n_threads,
                         size_classes=[c], chain_len=3, loops=2)
              for i, c in enumerate(("S", "M", "L"))]
    return app_cls(name=f"{soc.name}-chain{n_threads}", phases=phases)


def _runresult(out, tag, res):
    recs = [r for p in res.phases for r in p.invocations]
    for f in ("acc_id", "mode", "state_idx"):
        out[f"{tag}/{f}"] = np.asarray([getattr(r, f) for r in recs])
    for f in ("start", "end", "exec_time", "offchip_true", "offchip_attr",
              "reward"):
        out[f"{tag}/{f}"] = np.asarray([getattr(r, f) for r in recs],
                                       np.float64)
    out[f"{tag}/wall_time"] = np.asarray([p.wall_time for p in res.phases])


def _drivers(port: bool) -> dict:
    """Every driver through one package; floats and integers as arrays."""
    orch = torch_orch if port else jorch
    pol = tpol if port else jpol
    socs = TSOCS if port else JSOCS
    sim_of = ((lambda soc: tdes.SoCSimulator(soc, device="cpu")) if port
              else jdes.SoCSimulator)
    out = {}
    sim1 = sim_of(socs["SoC1"])
    out["isolated"] = np.asarray([
        [orch.run_isolated(sim1, acc, mode, fp, seed=3).total_time,
         orch.run_isolated(sim1, acc, mode, fp, seed=3).total_offchip]
        for acc, mode, fp in ISOLATED])
    het = orch.profile_fixed_heterogeneous(sim1, backend="des")
    out["hetero"] = np.asarray([int(het.assignment[p.name])
                                for p in sim1.profiles])

    sim = sim_of(socs["SoC-motiv-par"])
    agent, hist = orch.train_cohmeleon(sim, iterations=2, seed=0,
                                       n_phases=2, eval_each_iteration=True)
    out["hist"] = np.asarray([hist.iteration, hist.exec_time, hist.offchip])
    qs = agent.qs
    out["qtable"] = qs.qtable[0].numpy() if port else np.asarray(qs.qtable)
    out["visits"] = qs.visits[0].numpy() if port else np.asarray(qs.visits)

    app = _chain_app(t_make_phase if port else j_make_phase,
                     tdes.Application if port else jdes.Application,
                     socs["SoC-motiv-par"], seed=4, n_threads=2)
    suite = pol.all_fixed_policies() + [pol.ManualPolicy(),
                                        pol.RandomPolicy(), agent]
    for backend in ("des", "vecenv"):
        cmp = orch.compare_policies(sim, app, suite, seed=TILE_SEED,
                                    backend=backend)
        out[f"{backend}/norm"] = np.asarray(
            [[cmp.norm_time[n], cmp.norm_mem[n]] for n in cmp.policies])
        for name, res in cmp.raw.items():
            _runresult(out, f"{backend}/{name}", res)
            bd = orch.mode_breakdown(res, sim.soc)
            out[f"{backend}/{name}/breakdown"] = np.stack(
                [bd[k] for k in ("total", "S", "M", "L", "XL")])

    vec = tvec if port else jvec
    env = vec.VecEnv.from_simulator(sim)
    train_app = (t_make_app if port else j_make_app)(sim.soc, seed=5,
                                                     n_phases=1)
    apps = [vec.compile_app(train_app, sim.soc, seed=s) for s in (1, 2)]
    cfg = (tq if port else jq).QConfig(decay_steps=2 * apps[0].n_steps)
    key = prng.PRNGKey(9) if port else jax.random.PRNGKey(9)
    qs, h = env.train(apps, cfg, key=key, eval_app=apps[0])
    out["train/qtable"] = (qs.qtable[0].numpy() if port
                           else np.asarray(qs.qtable))
    out["train/visits"] = (qs.visits[0].numpy() if port
                           else np.asarray(qs.visits))
    out["train/hist"] = np.asarray([np.asarray(v) for v in h])
    return out


def reference_drivers() -> dict:
    """The reference's drivers (run without FMA by the fixture below, and
    in this process)."""
    return _drivers(False)


@pytest.fixture(scope="module")
def drivers(tmp_path_factory):
    jit_tab, nofma = reference_without_fma(
        "test_torch_orchestrator_des", "reference_drivers",
        tmp_path_factory.mktemp("nofma"), meanwhile=reference_drivers)
    return jit_tab, nofma, _drivers(True)


INT_KEYS = ("hetero", "visits", "train/visits")


def _check(drivers, keys):
    jit_tab, nofma, port = drivers
    for k in keys:
        if k in INT_KEYS or k.rsplit("/", 1)[-1] in ("acc_id", "mode",
                                                     "state_idx"):
            np.testing.assert_array_equal(port[k], jit_tab[k], err_msg=k)
        else:
            np.testing.assert_allclose(port[k], jit_tab[k], err_msg=k,
                                       **TOL_FMA)
        np.testing.assert_array_equal(port[k], nofma[k], err_msg=k)


def test_run_isolated(drivers):
    _check(drivers, ["isolated"])


def test_profile_fixed_heterogeneous_des(drivers):
    _check(drivers, ["hetero"])
    assert len(set(drivers[2]["hetero"])) >= 2   # not one mode for all


def test_train_cohmeleon(drivers):
    _check(drivers, ["hist", "qtable", "visits"])
    assert drivers[2]["visits"].sum() == 2 * 282


@pytest.mark.parametrize("backend", ["des", "vecenv"])
def test_compare_policies_and_breakdown(drivers, backend):
    """Both backends against the reference's: normalized metrics, every
    run's records (``episode_to_runresult`` on the batched one) and
    ``mode_breakdown``."""
    keys = [k for k in drivers[0] if k.startswith(f"{backend}/")]
    assert len(keys) > 50
    _check(drivers, keys)


def test_vecenv_train_one_agent(drivers):
    _check(drivers, ["train/qtable", "train/visits", "train/hist"])


# ------------------------------------------------- fidelity contract (port)
@pytest.fixture(scope="module", params=["SoC-motiv-iso", "SoC1"])
def pair(request):
    """(simulator, its VecEnv twin, single-thread app, compiled app)."""
    soc = {"SoC-motiv-iso": SOC_MOTIV_ISO, "SoC1": SOC1}[request.param]
    sim = tdes.SoCSimulator(soc, device="cpu")
    env = tvec.VecEnv.from_simulator(sim)
    app = _chain_app(t_make_phase, tdes.Application, soc, seed=3)
    return sim, env, app, tvec.compile_app(app, soc, seed=TILE_SEED)


def _des_phase_metrics(res):
    return (np.array([p.wall_time for p in res.phases]),
            np.array([p.offchip_accesses for p in res.phases]))


def test_fixed_modes_match_des_per_phase(pair):
    sim, env, app, compiled = pair
    for mode in CoherenceMode:
        des = sim.run(app, tpol.FixedHomogeneous(mode), seed=TILE_SEED,
                      train=False)
        _, res = env.episode(compiled, policy="fixed", fixed_modes=int(mode))
        dt, do = _des_phase_metrics(des)
        np.testing.assert_allclose(res.phase_time.numpy(), dt, rtol=1e-4,
                                   err_msg=str(mode))
        np.testing.assert_allclose(res.phase_offchip.numpy(), do, rtol=1e-4,
                                   atol=1e-3, err_msg=str(mode))


def test_manual_policy_matches_des(pair):
    sim, env, app, compiled = pair
    des = sim.run(app, tpol.ManualPolicy(), seed=TILE_SEED, train=False)
    _, res = env.episode(compiled, policy="manual")
    assert ([r.mode for p in des.phases for r in p.invocations]
            == res.mode.tolist())
    dt, do = _des_phase_metrics(des)
    np.testing.assert_allclose(res.phase_time.numpy(), dt, rtol=1e-4)
    np.testing.assert_allclose(res.phase_offchip.numpy(), do, rtol=1e-4,
                               atol=1e-3)


def test_sensed_states_match_des(pair):
    sim, env, app, compiled = pair
    des = sim.run(app, tpol.FixedHomogeneous(CoherenceMode.COH_DMA),
                  seed=TILE_SEED, train=False)
    _, res = env.episode(compiled, policy="fixed",
                         fixed_modes=int(CoherenceMode.COH_DMA))
    assert ([r.state_idx for p in des.phases for r in p.invocations]
            == res.state_idx.tolist())


def test_compare_policies_backends_agree(pair):
    sim, _, app, _ = pair
    suite = tpol.all_fixed_policies() + [tpol.ManualPolicy()]
    cd = torch_orch.compare_policies(sim, app, suite, seed=TILE_SEED)
    cv = torch_orch.compare_policies(sim, app, suite, seed=TILE_SEED,
                                     backend="vecenv")
    for name in cd.policies:
        td, md = cd.geomean(name)
        tv, mv = cv.geomean(name)
        assert abs(tv - td) <= 1e-3 * max(td, 1e-9), name
        assert abs(mv - md) <= 1e-3 * max(md, 1e-9) + 1e-6, name


def test_multithread_noncoh_offchip_exact():
    """NON_COH traffic bypasses every shared cache, so off-chip counts are
    contention-independent and match under the lockstep approximation;
    wall clock stays within a loose envelope."""
    sim = tdes.SoCSimulator(SOC_MOTIV_PAR, device="cpu")
    env = tvec.VecEnv.from_simulator(sim)
    app = _chain_app(t_make_phase, tdes.Application, SOC_MOTIV_PAR, seed=5,
                     n_threads=2)
    compiled = tvec.compile_app(app, SOC_MOTIV_PAR, seed=TILE_SEED)
    des = sim.run(app, tpol.FixedHomogeneous(CoherenceMode.NON_COH_DMA),
                  seed=TILE_SEED, train=False)
    _, res = env.episode(compiled, policy="fixed",
                         fixed_modes=int(CoherenceMode.NON_COH_DMA))
    dt, do = _des_phase_metrics(des)
    np.testing.assert_allclose(res.phase_offchip.numpy(), do, rtol=1e-4)
    ratio = res.phase_time.numpy() / np.maximum(dt, 1e-30)
    assert np.all(ratio > 0.5) and np.all(ratio < 1.5), ratio


def test_backend_defaults():
    """A simulator defaults to the event-driven backend; a VecEnv or an
    SoC configuration has only the batched one."""
    sim = tdes.SoCSimulator(SOC_MOTIV_ISO, device="cpu")
    app = _chain_app(t_make_phase, tdes.Application, SOC_MOTIV_ISO, seed=3)
    cmp = torch_orch.compare_policies(sim, app, [tpol.ManualPolicy()])
    assert cmp.raw["manual"].decide_overhead_s > 0.0     # ran the DES
    env = tvec.VecEnv.from_simulator(sim)
    assert env.device == sim.device and env.profiles == sim.profiles
    cmv = torch_orch.compare_policies(env, app, [tpol.ManualPolicy()])
    assert cmv.raw["manual"].decide_overhead_s == 0.0
    with pytest.raises(ValueError, match="SoCSimulator"):
        torch_orch.compare_policies(env, app, [], backend="des")
    with pytest.raises(ValueError, match="unknown backend"):
        torch_orch.compare_policies(sim, app, [], backend="scan")
