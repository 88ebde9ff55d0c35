"""The port's event-driven serving mirror (``SoCSimulator.serve``) against
repro's, request by request, on the CPU.

Both packages serve the SAME arrival tables, built here with numpy from a
seed (an MMPP-2 clock in float32, tenants, rows, deadlines, priorities),
on SoC1 (7 accelerators, 4 memory tiles) through an 18-row single-thread
chain app with ``queue_cap`` 4:

  * ``mid``: one tenant at 1.5x capacity with deadlines and backoff, so
    requests retry and some are shed — the four fixed modes, manual,
    random, a Q agent learning as it serves (``train=True``) and a frozen
    MLP agent;
  * ``prio``: two tenants (priorities 1 and 0.25) at 2x with a quarter of
    each queue reserved for priority: a Q agent learning;
  * ``latch``: two tenants at 2x with the overload latch (``overload_frac``
    0.25, ``pressure_beta`` 0.25), which trips and releases twice, forcing
    NON_COH while tripped: manual;
  * ``storm``: ``mid`` under ``storm(n, 0.7)``, rows indexed by offered
    request: fixed NON_COH and a Q agent learning.

Every record's integer fields (executed, retries, depth, degraded, mode,
state_idx, acc_id, tenant) must equal both reference builds' — the one
jitted here and the one compiled without fused multiply-add
(:func:`test_torch_serve.reference_without_fma`, ROADMAP C1).  Floats
(start, finish, exec_time, latency, reward) and the trained Q-tables must
be bitwise the no-FMA build's.  Against the FMA build the times are
within rtol = 2e-6, atol = 1e-6 (measured: one float32 ULP of an
exec_time, 6.25e-2 cycles in 6.3e5), and the rewards within the measured
0.25000006: the FMA build's contracted timing model and reward move an
off-chip count or a normalized metric by one ULP, which flips the
reward's extrema span test on an accelerator's first invocations
(ROADMAP C6: ``mid/fixed0``, request 3, accelerator 2, reward 1.0 in the
FMA build vs 0.75 in the port and the no-FMA build).  The batched
serving path (``ServeEnv.serve``) and the port's mirror agree as the
reference's own mirror test asks.
"""
import types

import jax
import numpy as np
import pytest
import torch

from repro.core import policies as jpol, qlearn as jq
from repro.soc import des as jdes, faults as jf, traffic as jtraffic
from repro.soc import vecenv as jvec
from repro.soc.apps import make_phase as j_make_phase
from repro.soc.config import SOC1 as JSOC1
from repro_torch import random as prng
from repro_torch.core import policies as tpol, qlearn as tq
from repro_torch.core.modes import CoherenceMode
from repro_torch.soc import des as tdes, faults as tf, traffic as ttraffic
from repro_torch.soc import vecenv as tvec
from repro_torch.soc.apps import make_phase as t_make_phase
from repro_torch.soc.config import SOC1 as TSOC1
from test_torch_des import _chain_app, _mlp_weights, _qtable
from test_torch_serve import reference_without_fma

TILE_SEED = 7
QCAP, N_REQ = 4, 96
# SoC1's mean NON_COH service time on the chain app, in cycles (a probe
# at a near-zero rate); the streams' rates and budgets scale with it.
MEAN_EXEC = 1472111.0
CAP_RATE = TSOC1.n_accs / MEAN_EXEC
TOL_FMA = dict(rtol=2e-6, atol=1e-6)
REWARD_GAP_FMA = 0.25000006    # measured, ROADMAP C6
INT_FIELDS = ("executed", "retries", "depth", "degraded", "mode",
              "state_idx", "acc_id", "tenant")
FLOAT_FIELDS = ("t_arr", "start", "finish", "exec_time", "latency",
                "reward")
NO_DEADLINE = float(np.float32(1e30))

# stream -> (load, tenant mix, relative deadlines, priorities, seed)
STREAMS = {
    "mid": (1.5, (1.0,), (12 * MEAN_EXEC,), (1.0,), 11),
    "prio": (2.0, (0.7, 0.3), (12 * MEAN_EXEC, 0.0), (1.0, 0.25), 12),
    "latch": (2.0, (0.7, 0.3), (4 * MEAN_EXEC, 0.0), (1.0, 0.25), 13),
}
SERVE_KW = {
    "mid": dict(backoff=0.5 * MEAN_EXEC),
    "prio": dict(backoff=0.25 * MEAN_EXEC, prio_reserve=0.25),
    "latch": dict(backoff=0.25 * MEAN_EXEC, overload_frac=0.25,
                  pressure_beta=0.25),
}


def _arrivals(stream: str, n_rows: int) -> dict:
    """A stream's arrival table as numpy arrays: MMPP-2 gaps (burst rate
    4x, flips 0.1 / 0.3) accumulated in float32, a tenant per request from
    the mix, a row in the tenant's share of the schedule."""
    load, mix, dl, prio, seed = STREAMS[stream]
    rng = np.random.default_rng(seed)
    burst = np.zeros(N_REQ, bool)
    state = False
    for i in range(N_REQ):
        state = rng.random() < (0.7 if state else 0.1)
        burst[i] = state
    rate = load * CAP_RATE * np.where(burst, 4.0, 1.0)
    gaps = (rng.exponential(1.0, N_REQ) / rate).astype(np.float32)
    t_arr = np.cumsum(gaps, dtype=np.float32)
    tenant = rng.choice(len(mix), N_REQ, p=np.asarray(mix) / sum(mix))
    k = len(mix)
    lo, hi = tenant * n_rows // k, (tenant + 1) * n_rows // k
    row = lo + (rng.random(N_REQ) * (hi - lo)).astype(np.int64)
    rel = np.asarray(dl, np.float32)[tenant]
    deadline = np.where(rel <= 0, np.float32(NO_DEADLINE),
                        t_arr + rel).astype(np.float32)
    return dict(t_arr=t_arr, row=row.astype(np.int32),
                tenant=tenant.astype(np.int32), deadline=deadline,
                priority=np.asarray(prio, np.float32)[tenant],
                burst=burst)


def _api(port: bool):
    if port:
        return types.SimpleNamespace(
            port=True, des=tdes, pol=tpol, q=tq, faults=tf,
            make_phase=t_make_phase, key=prng.PRNGKey,
            arrivals=lambda a: ttraffic.Arrivals(
                **{k: torch.as_tensor(v) for k, v in a.items()}),
            sim=lambda: tdes.SoCSimulator(TSOC1, device="cpu"),
            compile=lambda app: tvec.compile_app(app, TSOC1,
                                                 seed=TILE_SEED),
            qpolicy=lambda cfg, seed: tpol.QPolicy(cfg, seed=seed,
                                                   device="cpu"))
    return types.SimpleNamespace(
        port=False, des=jdes, pol=jpol, q=jq, faults=jf,
        make_phase=j_make_phase, key=jax.random.PRNGKey,
        arrivals=lambda a: jtraffic.Arrivals(**a),
        sim=lambda: jdes.SoCSimulator(JSOC1),
        compile=lambda app: jvec.compile_app(app, JSOC1, seed=TILE_SEED),
        qpolicy=lambda cfg, seed: jpol.QPolicy(cfg, seed=seed))


def _cases(api):
    """(case, stream, policy, train, faults) of every serve call."""
    cfg = api.q.QConfig(decay_steps=N_REQ)
    storm = api.faults.storm(N_REQ, 0.7, api.key(42))
    out = [(f"mid/fixed{m}", "mid", api.pol.FixedHomogeneous(m), False,
            None) for m in range(4)]
    out += [("mid/manual", "mid", api.pol.ManualPolicy(), False, None),
            ("mid/random", "mid", api.pol.RandomPolicy(), False, None),
            ("mid/q", "mid", api.qpolicy(cfg, 5), True, None),
            ("mid/mlp", "mid", _mlp_weights(api, 3), False, None),
            ("prio/q", "prio", api.qpolicy(cfg, 6), True, None),
            ("latch/manual", "latch", api.pol.ManualPolicy(), False, None),
            ("storm/fixed0", "mid", api.pol.FixedHomogeneous(0), False,
             storm),
            ("storm/q", "mid", api.qpolicy(cfg, 7), True, storm)]
    return out


def _tables(port: bool) -> dict:
    api = _api(port)
    sim = api.sim()
    compiled = api.compile(_chain_app(api, sim.soc, seed=0))
    n_rows = int(compiled.n_steps)
    out = {}
    for case, stream, pol, train, faults in _cases(api):
        arr = api.arrivals(_arrivals(stream, n_rows))
        recs = sim.serve(compiled.schedule, pol, arr, queue_cap=QCAP,
                         train=train, faults=faults, seed=TILE_SEED,
                         **SERVE_KW[stream])
        for f in INT_FIELDS:
            out[f"{case}/{f}"] = np.asarray([r[f] for r in recs], np.int64)
        for f in FLOAT_FIELDS:
            out[f"{case}/{f}"] = np.asarray([r[f] for r in recs],
                                            np.float64)
        if train:
            (out[f"{case}/qtable"], out[f"{case}/visits"],
             out[f"{case}/step"]) = _qtable(api, pol.qs)
    return out


def reference_tables() -> dict:
    """Every case through the reference (run in a process without FMA by
    the fixture below, and in this one)."""
    return _tables(False)


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """(reference as jitted here, reference without FMA, the port)."""
    jit_tab, nofma = reference_without_fma(
        "test_torch_des_serve", "reference_tables",
        tmp_path_factory.mktemp("nofma"), meanwhile=reference_tables)
    return jit_tab, nofma, _tables(True)


CASES = [c[0] for c in _cases(_api(True))]
LEARNING = [c[0] for c in _cases(_api(True)) if c[3]]


@pytest.mark.parametrize("case", CASES)
def test_serve_record_by_record(tables, case):
    """Integer fields equal to both builds, floats bitwise the no-FMA
    build; times within TOL_FMA of the FMA build, rewards within its
    measured gap."""
    jit_tab, nofma, port = tables
    for f in INT_FIELDS:
        np.testing.assert_array_equal(port[f"{case}/{f}"],
                                      nofma[f"{case}/{f}"], err_msg=f)
        np.testing.assert_array_equal(port[f"{case}/{f}"],
                                      jit_tab[f"{case}/{f}"], err_msg=f)
    for f in FLOAT_FIELDS:
        np.testing.assert_array_equal(port[f"{case}/{f}"],
                                      nofma[f"{case}/{f}"], err_msg=f)
        tol = (dict(rtol=0.0, atol=REWARD_GAP_FMA) if f == "reward"
               else TOL_FMA)
        np.testing.assert_allclose(port[f"{case}/{f}"],
                                   jit_tab[f"{case}/{f}"], err_msg=f, **tol)


@pytest.mark.parametrize("case", LEARNING)
def test_serve_trained_table(tables, case):
    """A Q agent trained while serving: visits and step equal, the table
    bitwise the no-FMA build's."""
    jit_tab, nofma, port = tables
    for f in ("visits", "step"):
        np.testing.assert_array_equal(port[f"{case}/{f}"],
                                      jit_tab[f"{case}/{f}"])
    np.testing.assert_array_equal(port[f"{case}/qtable"],
                                  nofma[f"{case}/qtable"])
    np.testing.assert_allclose(port[f"{case}/qtable"],
                               jit_tab[f"{case}/qtable"], **TOL_FMA)


def test_streams_exercise_admission(tables):
    """The streams reach what they are for: retries and sheds at 1.5x, the
    low-priority tenant shed more under the reserve, the latch tripping
    and releasing (and forcing NON_COH while tripped), the storm changing
    the service times."""
    port = tables[2]
    ex = port["mid/fixed2/executed"].astype(bool)
    assert (port["mid/fixed2/retries"][ex] > 0).any() and not ex.all()
    ten, ex = port["prio/q/tenant"], port["prio/q/executed"].astype(bool)
    assert ex[ten == 1].mean() < ex[ten == 0].mean()
    deg = port["latch/manual/degraded"].astype(bool)
    ex = port["latch/manual/executed"].astype(bool)
    runs = np.diff(np.concatenate([[0], deg[ex].astype(int), [0]]))
    assert (runs == 1).sum() >= 2, "the latch should trip twice"
    assert (port["latch/manual/mode"][deg] == CoherenceMode.NON_COH_DMA).all()
    assert not np.array_equal(port["storm/fixed0/exec_time"],
                              port["mid/fixed0/exec_time"])


def test_des_serving_mirror_agrees():
    """The port's batched serving path vs its event-driven mirror on the
    same arrival table: identical admission decisions, latencies within
    1e-4 relative (the reference's test, on the port's two paths)."""
    sim = tdes.SoCSimulator(TSOC1, device="cpu")
    env = tvec.VecEnv.from_simulator(sim)
    compiled = tvec.compile_app(_chain_app(_api(True), TSOC1, seed=0),
                                TSOC1, seed=TILE_SEED)
    serve_env = tvec.ServeEnv(env, queue_cap=QCAP, n_requests=64)
    mode = CoherenceMode.NON_COH_DMA
    spec = env.lower(compiled, "fixed", fixed_modes=mode)
    tspec = ttraffic.poisson(2e-5, deadline=3e5, backoff=5e4, seed=11)
    _, _, res = serve_env.serve(compiled, spec, tspec)
    arr = ttraffic.sample_arrivals(tspec, 64,
                                   compiled.schedule.acc_id.shape[0])
    des = sim.serve(compiled.schedule, tpol.FixedHomogeneous(mode), arr,
                    queue_cap=QCAP, backoff=float(tspec.backoff))
    v_ex = res.executed.numpy()
    d_ex = np.array([r["executed"] for r in des])
    np.testing.assert_array_equal(v_ex, d_ex)
    assert not v_ex.all() and v_ex.any()
    v_lat = res.latency.numpy()[v_ex]
    d_lat = np.array([r["latency"] for r in des])[v_ex]
    np.testing.assert_allclose(v_lat, d_lat, rtol=1e-4)
