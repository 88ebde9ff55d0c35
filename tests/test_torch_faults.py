"""Fault injection in the port (``repro_torch.soc.faults`` and the
``faults=`` paths of the environments) against repro's, on the CPU.

Cases: SoC1 (7 accelerators, 4 memory tiles) running a chain application
of two phases (S, M) with two threads; two agents trained for two
iterations inside ``storm(eval steps, 1.0, PRNGKey(42))`` with the
collapse watchdog on; a storm episode of a learning agent; three streams
served under ``storm(64, 0.7, PRNGKey(42))`` at an overloading rate; the
four fixed modes and manual on two stacked lanes (SoC1, SoC2) under a
storm, its drop coins drawn over the padded length.  Fault rows, storms
and their draws must be bitwise the reference's.  Every float is held to
rtol = atol = 2e-5 against the reference compiled without fused
multiply-add (``test_torch_serve.reference_without_fma``, ROADMAP C1), and
every integer column also against the reference as jitted here, except
the storm training's: there the jitted reference's contracted rewards
(one ULP from step 11 of the first iteration on) flip agent 0's mode at
step 16 of the second iteration and 7 visit counts differ (ROADMAP C4).
A zero spec (``no_faults()``) must be bitwise the ``faults=None`` run on
every path.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qlearn as jq, rewards as jr
from repro.core import policies as jpol
from repro.soc import faults as jf, stacked as jstk, vecenv as jvec
from repro.soc import traffic as jtraffic
from repro.soc.apps import make_phase as j_make_phase
from repro.soc.config import SOCS as JSOCS
from repro.soc.des import Application as JApp, SoCSimulator
from repro_torch import random as prng
from repro_torch.core import policies as tpol, qlearn as tq, rewards as tr
from repro_torch.core.modes import CoherenceMode
from repro_torch.kernels.soc_step import ops as tops, ref as tref
from repro_torch.soc import faults as tf, stacked as tstk
from repro_torch.soc import traffic as ttraffic, vecenv as tvec
from repro_torch.soc.apps import make_phase as t_make_phase
from repro_torch.soc.config import SOCS as TSOCS
from repro_torch.soc.des import Application as TApp
from test_torch_serve import reference_without_fma

TOL = dict(rtol=2e-5, atol=2e-5)
N_REQ, QCAP = 64, 4
W = [(0.675, 0.075, 0.25), (0.2, 0.2, 0.6)]
SERVE_KW = dict(mix=(0.7, 0.3), deadline=(6000.0, 0.0),
                priority=(1.0, 0.25), backoff=400.0, overload_frac=0.35,
                prio_reserve=0.25, seed=3)


def _chain_app(make_phase, app_cls, soc, seed, n_threads=2):
    rng = np.random.default_rng(seed)
    phases = [make_phase(rng, soc, name=f"p{i}", n_threads=n_threads,
                         size_classes=[c], chain_len=3, loops=2)
              for i, c in enumerate(("S", "M"))]
    return app_cls(name=f"{soc.name}-faults{seed}", phases=phases)


def _flat(prefix, tree, out):
    for f in tree._fields:
        out[f"{prefix}/{f}"] = np.asarray(getattr(tree, f))


def _sub(tab, prefix):
    return {k[len(prefix) + 1:]: v for k, v in tab.items()
            if k.startswith(prefix + "/")}


def reference_tables() -> dict:
    """The reference's storm episode, storm training, storm serving and
    stacked storm episodes, as numpy arrays."""
    from repro.core.modes import CoherenceMode as JMode
    soc = JSOCS["SoC1"]
    env = jvec.VecEnv.from_simulator(SoCSimulator(soc, seed=1))
    app = jvec.compile_app(_chain_app(j_make_phase, JApp, soc, 3), soc,
                           seed=7)
    out = {}
    fs = jf.storm(app.n_steps, 0.7, jax.random.PRNGKey(42))
    qs, res = env.episode(app, policy="q", cfg=jq.QConfig(decay_steps=60),
                          key=jax.random.PRNGKey(1), faults=fs)
    _flat("epq", qs, out)
    _flat("ep", res, out)

    apps = [jvec.compile_app(_chain_app(j_make_phase, JApp, soc, 3), soc,
                             seed=s) for s in range(2)]
    ev = jvec.compile_app(_chain_app(j_make_phase, JApp, soc, 5), soc,
                          seed=4)
    cfg = jq.QConfig(decay_steps=2 * apps[0].n_steps, collapse_frac=0.25)
    qs, hist = env.train_batched(
        apps, cfg, jr.stack_weights([jr.RewardWeights(*w) for w in W]),
        jax.vmap(jax.random.PRNGKey)(jnp.arange(2)), eval_app=ev,
        faults=jf.storm(ev.n_steps, 1.0, jax.random.PRNGKey(42)))
    _flat("train", qs, out)
    out["hist/t"], out["hist/m"] = map(np.asarray, hist)

    specs = jvec.stack_specs([
        env.lower(ev, "q", qstate=jq.init_qstate(jq.QConfig())),
        env.lower(ev, "fixed", fixed_modes=JMode.NON_COH_DMA),
        env.lower(ev, "fixed", fixed_modes=JMode.FULLY_COH)])
    serve_env = jvec.ServeEnv(env, queue_cap=QCAP, n_requests=N_REQ)
    _, sq, sres = serve_env.serve_specs(
        ev, specs, jtraffic.bursty(4e-3, **SERVE_KW),
        cfg=jq.QConfig(decay_steps=60),
        faults=jf.storm(N_REQ, 0.7, jax.random.PRNGKey(42)))
    _flat("serve", sres, out)
    _flat("serveq", sq, out)

    socs = [JSOCS["SoC1"], JSOCS["SoC2"]]
    senv = jstk.StackedVecEnv.from_simulators(
        [SoCSimulator(s, seed=1) for s in socs])
    st = senv.compile([_chain_app(j_make_phase, JApp, s, 11 + i, 1 + i)
                       for i, s in enumerate(socs)], seed=3)
    suite = ([jpol.FixedHomogeneous(m) for m in JMode]
             + [jpol.ManualPolicy()])
    _flat("stk", senv.episodes(
        st, senv.lower(st, suite),
        faults=jf.storm(st.schedule.acc_id.shape[-1], 0.5,
                        jax.random.PRNGKey(7))), out)
    return out


def _port_setup():
    soc = TSOCS["SoC1"]
    env = tvec.VecEnv(soc, seed=1, device="cpu")
    app = tvec.compile_app(_chain_app(t_make_phase, TApp, soc, 3), soc,
                           seed=7)
    apps = [tvec.compile_app(_chain_app(t_make_phase, TApp, soc, 3), soc,
                             seed=s) for s in range(2)]
    ev = tvec.compile_app(_chain_app(t_make_phase, TApp, soc, 5), soc,
                          seed=4)
    return soc, env, app, apps, ev


def _serve_specs(env, ev):
    sched = ev.schedule
    return tvec.stack_specs([
        tvec.learned_policy_spec(tq.init_qstate(tq.QConfig()), sched),
        tvec.fixed_policy_spec(env.params, sched, 0),
        tvec.fixed_policy_spec(env.params, sched, 3)])


def _stacked_setup():
    socs = [TSOCS["SoC1"], TSOCS["SoC2"]]
    senv = tstk.StackedVecEnv(socs, seed=1, device="cpu")
    st = senv.compile([_chain_app(t_make_phase, TApp, s, 11 + i, 1 + i)
                       for i, s in enumerate(socs)], seed=3)
    suite = ([tpol.FixedHomogeneous(m) for m in CoherenceMode]
             + [tpol.ManualPolicy()])
    return senv, st, senv.lower(st, suite)


def _run(path: str, faults):
    """One path of the port on this file's inputs; ``faults`` is a spec
    maker ``(n_steps, intensity, seed) -> FaultSpec or None``."""
    soc, env, app, apps, ev = _port_setup()
    if path == "episode":
        spec = tvec.learned_policy_spec(tq.init_qstate(tq.QConfig()),
                                        app.schedule)
        return env.episode_spec(app, spec, cfg=tq.QConfig(decay_steps=60),
                                key=prng.PRNGKey(1),
                                faults=faults(app.n_steps, 0.7, 42))
    if path == "train":
        cfg = tq.QConfig(decay_steps=2 * apps[0].n_steps, collapse_frac=0.25)
        return env.train_batched(apps, cfg, tr.stack_weights(W),
                                 prng.PRNGKey(np.arange(2)), eval_app=ev,
                                 faults=faults(ev.n_steps, 1.0, 42))
    if path == "serve":
        serve_env = tvec.ServeEnv(env, queue_cap=QCAP, n_requests=N_REQ)
        return serve_env.serve_specs(
            ev, _serve_specs(env, ev), ttraffic.bursty(4e-3, **SERVE_KW),
            cfg=tq.QConfig(decay_steps=60), faults=faults(N_REQ, 0.7, 42))
    senv, st, specs = _stacked_setup()
    return (senv.episodes(st, specs, faults=faults(
        st.schedule.acc_id.shape[-1], 0.5, 7)),)


def _storm(n, intensity, seed):
    return tf.storm(n, intensity, prng.PRNGKey(seed))


def port_results() -> dict:
    return {p: _run(p, _storm)
            for p in ("episode", "train", "serve", "stacked")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port results, reference without FMA, reference as jitted here);
    the last two are computed concurrently."""
    (port, here), nofma = reference_without_fma(
        "test_torch_faults", "reference_tables",
        tmp_path_factory.mktemp("nofma"),
        meanwhile=lambda: (port_results(), reference_tables()))
    return port, nofma, here


def _assert_tree(port, ref: dict, name, ints_only=False):
    """``port`` fields against ``ref``'s arrays (a port state's batch axis
    of one is the reference's unbatched state)."""
    for f in port._fields:
        b = ref[f]
        a = getattr(port, f).cpu().numpy().reshape(b.shape)
        if np.issubdtype(b.dtype, np.floating) and f not in ("retries",
                                                             "depth"):
            if not ints_only:
                np.testing.assert_allclose(a, b, err_msg=f"{name}.{f}",
                                           **TOL)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{name}.{f}")


def _assert_both(port, nofma, here, prefix, name):
    _assert_tree(port, _sub(nofma, prefix), name)
    if here is not None:
        _assert_tree(port, _sub(here, prefix), f"{name} (FMA)",
                     ints_only=True)


# ------------------------------------------------------------ fault rows
@pytest.mark.parametrize("intensity", [0.0, 0.25, 0.7, 1.0])
def test_storm_and_rows_bitwise(intensity):
    """storm's fields (Python doubles cast to float32), the drop coins
    and every fault row are the reference's, bitwise; a reference spec
    carries across through faults_from_numpy."""
    js = jf.storm(97, intensity, jax.random.PRNGKey(42), slow_acc=2)
    ts = tf.storm(97, intensity, prng.PRNGKey(42), slow_acc=2)
    for f in jf.FaultSpec._fields:
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        if f == "key":
            b = b.astype(np.uint32)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for a, b in zip(tf.faults_from_numpy(js), ts):
        assert torch.equal(a, b)
    acc = np.random.default_rng(0).integers(0, 7, 97).astype(np.int32)
    jrow = jf.sample_fault_arrays(js, jnp.asarray(acc))
    trow = tf.sample_fault_arrays(ts, torch.from_numpy(acc))
    for f in jf.StepFault._fields:
        np.testing.assert_array_equal(getattr(trow, f).numpy(),
                                      np.asarray(getattr(jrow, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(
        tf.sample_fault_uniforms(ts, 97).numpy(),
        jf.sample_fault_uniforms(js, 97))
    u = np.random.default_rng(1).random((5, 3)).astype(np.float32)
    for t in (0, 30, 60, 90):
        j = jf.fault_row(js, jnp.int32(t), jnp.int32(2), jnp.asarray(u[t % 5]))
        p = tf.fault_row(ts, torch.tensor(t, dtype=torch.int32),
                         torch.tensor(2, dtype=torch.int32),
                         torch.from_numpy(u[t % 5]))
        for f in jf.StepFault._fields:
            assert np.asarray(getattr(j, f)) == getattr(p, f).numpy(), f


def test_fault_row_semantics():
    """Window tests, victim selection and the retry/backoff arithmetic
    (``tests/test_soc_faults.py::test_fault_row_semantics``)."""
    fs = tf.no_faults()._replace(
        slow_start=torch.tensor(2, dtype=torch.int32),
        slow_end=torch.tensor(5, dtype=torch.int32),
        slow_acc=torch.tensor(1, dtype=torch.int32),
        slow_factor=torch.tensor(3.0),
        drop_start=torch.tensor(0, dtype=torch.int32),
        drop_end=torch.tensor(10, dtype=torch.int32),
        drop_prob=torch.tensor(1.0), backoff=torch.tensor(100.0))
    u = torch.zeros(tf.FAULT_MAX_RETRIES)
    i = lambda v: torch.tensor(v, dtype=torch.int32)
    row = tf.fault_row(fs, i(3), i(1), u)
    assert float(row.exec_scale) == 3.0
    assert float(tf.fault_row(fs, i(5), i(1), u).exec_scale) == 1.0
    assert float(tf.fault_row(fs, i(3), i(0), u).exec_scale) == 1.0
    assert float(row.retry_cycles) == 100.0 * (2.0 ** tf.FAULT_MAX_RETRIES
                                               - 1.0)
    row0 = tf.fault_row(fs._replace(drop_prob=torch.tensor(0.0)), i(3),
                        i(1), u)
    assert float(row0.retry_cycles) == 0.0
    assert tf.backoff_cycles(torch.tensor(1.0),
                             torch.arange(4)).tolist() == [0.0, 1.0, 3.0,
                                                           7.0]
    neutral = tf.neutral_step_fault()
    assert [float(v) for v in neutral] == [1.0, 1.0, 0.0, 0.0]


# ------------------------------------------------------ zero-spec identity
def _none(n, intensity, seed):
    return None


def _zero(n, intensity, seed):
    return tf.no_faults(prng.PRNGKey(seed))


def _zero_intensity(n, intensity, seed):
    return tf.storm(n, 0.0, prng.PRNGKey(seed))


@pytest.mark.parametrize("path", ["episode", "train", "serve", "stacked"])
def test_zero_spec_is_no_faults(path):
    """``no_faults()`` and a zero-intensity storm give the ``faults=None``
    run bitwise, and the neutral rows take the plain version with its
    fault columns."""
    base = _run(path, _none)
    for maker in (_zero, _zero_intensity):
        got = _run(path, maker)
        for a_tree, b_tree in zip(got, base):
            if a_tree is None:
                assert b_tree is None
                continue
            for a, b in zip(a_tree, b_tree):
                if a is None:      # a table stream's carry has no wpack
                    assert b is None
                    continue
                assert torch.equal(a, b), (path, maker.__name__)


# ------------------------------------------------- against the reference
def test_storm_episode_matches_reference(runs):
    port, nofma, here = runs
    qs, res = port["episode"]
    _assert_both(qs, nofma, here, "epq", "episode.qstate")
    _assert_both(res, nofma, here, "ep", "episode")
    healthy = _run("episode", _none)[1]
    assert not torch.equal(res.exec_time, healthy.exec_time)


def test_storm_training_matches_reference(runs):
    port, nofma, here = runs
    qs, hist = port["train"]
    _assert_both(qs, nofma, None, "train", "train.qstate")   # C4
    np.testing.assert_allclose(hist[0].numpy(), nofma["hist/t"], **TOL)
    np.testing.assert_allclose(hist[1].numpy(), nofma["hist/m"], **TOL)


def test_storm_serving_matches_reference(runs):
    port, nofma, here = runs
    _, qs, res = port["serve"]
    _assert_both(res, nofma, here, "serve", "serve")
    _assert_both(qs, nofma, here, "serveq", "serve.qstate")
    assert 0 < float(res.executed.float().mean()) < 1.0


def test_stacked_storm_episodes_match_reference(runs):
    port, nofma, here = runs
    _assert_both(port["stacked"][0], nofma, here, "stk", "stacked")


# ------------------------------------------------------ degradation safety
def test_nonfinite_footprint_forces_noncoh_fallback():
    """A NaN footprint mid-episode degrades that invocation to NON_COH
    and leaves the other steps as they were."""
    _, env, app, _, _ = _port_setup()
    sched = app.schedule
    bad_sched = sched._replace(footprint=sched.footprint.clone())
    bad_sched.footprint[2] = float("nan")
    bad = tvec.CompiledApp(name=app.name, schedule=bad_sched,
                           n_phases=app.n_phases, n_threads=app.n_threads,
                           n_steps=app.n_steps, phase_names=app.phase_names)
    fc = int(CoherenceMode.FULLY_COH)
    _, ok = env.episode_spec(app, tvec.fixed_policy_spec(env.params, sched,
                                                         fc))
    _, res = env.episode_spec(bad, tvec.fixed_policy_spec(env.params,
                                                          bad_sched, fc))
    assert int(res.mode[2]) == int(CoherenceMode.NON_COH_DMA)
    keep = torch.arange(res.mode.shape[0]) != 2
    assert torch.equal(res.mode[keep], ok.mode[keep])


def test_debug_finite_env_flag():
    """``VecEnv(debug_finite=True)`` raises on an episode whose schedule
    carries a NaN footprint and stays silent on a healthy one."""
    soc, _, app, _, _ = _port_setup()
    env = tvec.VecEnv(soc, seed=1, debug_finite=True, device="cpu")
    spec = tvec.learned_policy_spec(tq.init_qstate(tq.QConfig()),
                                    app.schedule)
    env.episode_spec(app, spec)
    sched = app.schedule._replace(footprint=app.schedule.footprint.clone())
    sched.footprint[2] = float("nan")
    bad = tvec.CompiledApp(name=app.name, schedule=sched,
                           n_phases=app.n_phases, n_threads=app.n_threads,
                           n_steps=app.n_steps, phase_names=app.phase_names)
    with pytest.raises(FloatingPointError, match="vecenv.episode"):
        env.episode_spec(bad, spec)
    with pytest.raises(FloatingPointError, match="reward"):
        tq.debug_finite_check("qlearn.update", reward=torch.tensor(np.nan),
                              qtable=torch.ones(2))
    tq.debug_finite_check("qlearn.update", reward=torch.tensor(1.0))


def test_kernel_inputs_carry_fault_columns():
    """The packed rows end in the four fault columns the kernels read at
    ``nf - 4 .. nf - 1``, and a faulted call counts no launch on the
    CPU."""
    _, env, app, _, _ = _port_setup()
    sched = app.schedule
    spec = tvec.learned_policy_spec(tq.init_qstate(tq.QConfig()), sched)
    fs = tf.storm(app.n_steps, 1.0, prng.PRNGKey(42))
    xs, _ = tvec.episode_inputs(env.params, sched, spec, tq.QConfig(),
                                prng.PRNGKey(np.arange(1)), faults=fs)
    healthy, _ = tref.pack_inputs(xs._replace(f_exec=None, f_ddr=None,
                                              f_llc=None, f_retry=None))
    xf, _ = tref.pack_inputs(xs)
    assert xf.shape[-1] == healthy.shape[-1] + 4
    assert torch.equal(xf[..., :-4], healthy)
    rows = tf.sample_fault_arrays(fs, sched.acc_id)
    assert torch.equal(xf[0, :, -4:], torch.stack(list(rows), -1))
    tops.reset_launches()
    ex0 = tr.init_reward_state(7, (1,)).extrema
    tops.fused_episode(env.static, spec.learned.reshape(1),
                       tr.PAPER_DEFAULT_WEIGHTS, spec.qstate.qtable, ex0, xs)
    assert (tops.launches, tops.fault_launches) == (0, 0)
