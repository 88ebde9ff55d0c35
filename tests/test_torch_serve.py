"""The port's serving step (plain PyTorch version) and ServeEnv against
repro's, on the CPU.

Both packages serve the SAME arrival table — the reference's, converted
to torch — so admission compares like with like (the port's own arrival
clock agrees only to a few ULP, ``tests/test_torch_traffic.py``).  Cases:
SoC1 (7 accelerators, 4 memory tiles), ``queue_cap`` 4, a short two-phase
application, three streams per call (a learning agent, fixed NON_COH,
fixed FULLY_COH) under an underloaded and an overloaded two-tenant bursty
stream; the overload trips the watchdog.  Integer columns must be equal;
floats within rtol = atol = 2e-5 against the reference compiled without
fused multiply-add (:func:`reference_without_fma`; measured: bitwise at
both loads), integer columns also against the reference as jitted here.
With FMA (ROADMAP C1) 52 floats of the underload differ, one reward by
0.25: a contracted off-chip count flips the reward's extrema span test.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.torch_no_fma import without_fma
from repro.core import qlearn as jq, rewards as jr
from repro.kernels.soc_step import ref as jref
from repro.soc import traffic as jtraffic, vecenv as jvec
from repro.soc.apps import make_application as j_make_app
from repro.soc.config import SOCS as JSOCS
from repro_torch import random as prng
from repro_torch.core import qlearn as tq, rewards as tr
from repro_torch.kernels.soc_step import ops as tops, ref as tref
from repro_torch.soc import traffic as ttraffic, vecenv as tvec
from repro_torch.soc.apps import make_application as t_make_app
from repro_torch.soc.config import SOCS as TSOCS
from repro_torch.soc.memsys import SoCStatic

ROOT = Path(__file__).resolve().parents[1]
SRC, TESTS = ROOT / "src", ROOT / "tests"
TOL = dict(rtol=2e-5, atol=2e-5)
QCAP, N_REQ = 4, 96
INT_COLS = ("mode", "state_idx", "action", "executed", "retries", "depth",
            "degraded")
LOADS = {"under": 2e-7, "over": 4e-3}
XS_FIELDS = tref.StepInputs._fields[:15]      # the healthy (fault-free) row
# a table stream's carry (no weight pack)
CARRY_FIELDS = tuple(f for f in tref.ServeCarry._fields if f != "wpack")


def _traffic(mod, rate):
    return mod.bursty(rate, mix=(0.7, 0.3), deadline=(6000.0, 0.0),
                      priority=(1.0, 0.25), backoff=400.0,
                      overload_frac=0.35, prio_reserve=0.25, seed=3)


def _setup():
    soc = JSOCS["SoC1"]
    jenv = jvec.VecEnv(soc, seed=1)
    japp = jvec.compile_app(j_make_app(soc, seed=50, n_phases=2), soc,
                            seed=4)
    tenv = tvec.VecEnv(TSOCS["SoC1"], seed=1, device="cpu")
    tapp = tvec.compile_app(t_make_app(TSOCS["SoC1"], seed=50, n_phases=2),
                            TSOCS["SoC1"], seed=4)
    return soc, jenv, japp, tenv, tapp


def _jax_specs(jenv, japp):
    from repro.core.modes import CoherenceMode
    return [jenv.lower(japp, "q", qstate=jq.init_qstate(jq.QConfig())),
            jenv.lower(japp, "fixed",
                       fixed_modes=CoherenceMode.NON_COH_DMA),
            jenv.lower(japp, "fixed", fixed_modes=CoherenceMode.FULLY_COH)]


_SERVE_JIT = jax.jit(jref.serve_episode_ref)


def _jax_chunk(jenv, japp, spec, tspec, key, cfg):
    """The reference's serve inputs for one stream (build_serve_fn's
    construction) and its jitted serve_episode_ref result."""
    sched = japp.schedule
    n_accs = jenv.pmat.shape[0]
    arr = jtraffic.sample_arrivals(tspec, N_REQ, sched.acc_id.shape[0])
    acc = sched.acc_id[arr.row]
    noise = jq.sample_select_noise(key, (N_REQ,), 4)
    zf = jnp.zeros((N_REQ,), jnp.float32)
    xs = jref.StepInputs(
        acc_id=acc, footprint=sched.footprint[arr.row],
        tiles=sched.tiles[arr.row], thread=jnp.zeros((N_REQ,), jnp.int32),
        fresh=jnp.ones((N_REQ,), bool),
        others=jnp.zeros((N_REQ, n_accs), bool),
        valid=jnp.ones((N_REQ,), bool), pre_mode=spec.modes[arr.row],
        profile=jenv.pmat[acc], avail=jenv.masks[acc], eps=zf, alpha=zf,
        u_explore=noise.u_explore, g_pick=noise.g_pick, g_tie=noise.g_tie)
    sp = jref.ServeParams(
        eps0=jnp.float32(cfg.epsilon0), alpha0=jnp.float32(cfg.alpha0),
        decay_steps=jnp.float32(cfg.decay_steps),
        reopen_frac=jnp.float32(cfg.reopen_frac),
        frozen=spec.qstate.frozen.astype(jnp.float32),
        backoff=tspec.backoff, overload_frac=tspec.overload_frac,
        pressure_beta=tspec.pressure_beta, prio_reserve=tspec.prio_reserve)
    carry0 = jref.init_serve_carry(
        spec.qstate.qtable, jr.init_reward_state(n_accs).extrema, n_accs,
        sched.tiles.shape[-1], QCAP, spec.qstate.step)
    carry, ys = _SERVE_JIT(jenv.static, spec.learned, jr.PAPER_DEFAULT_WEIGHTS, sp,
                   carry0, xs, arr.t_arr, arr.deadline, arr.priority)
    return (xs, sp, carry0, arr), (carry, ys)


def reference_tables() -> dict:
    """The reference's serve inputs and jitted outputs for every load, the
    three streams stacked on a leading axis, as numpy arrays keyed
    ``"<load>/<group>/<field>"``."""
    soc, jenv, japp, _, _ = _setup()
    cfg = jq.QConfig(decay_steps=60)
    out = {}
    for load, rate in LOADS.items():
        tspec = _traffic(jtraffic, rate)
        runs = [_jax_chunk(jenv, japp, spec, tspec,
                           jax.random.PRNGKey(10 + i), cfg)
                for i, spec in enumerate(_jax_specs(jenv, japp))]
        groups = {
            "xs": (XS_FIELDS, [r[0][0] for r in runs]),
            "sp": (tref.ServeParams._fields, [r[0][1] for r in runs]),
            "carry0": (CARRY_FIELDS, [r[0][2] for r in runs]),
            "arr": (("t_arr", "deadline", "priority"),
                    [(r[0][3].t_arr, r[0][3].deadline, r[0][3].priority)
                     for r in runs]),
            "carry": (CARRY_FIELDS, [r[1][0] for r in runs]),
            "ys": (("y",), [(r[1][1],) for r in runs])}
        for g, (fields, items) in groups.items():
            for i, f in enumerate(fields):
                out[f"{load}/{g}/{f}"] = np.stack([np.asarray(it[i])
                                                   for it in items])
        # the whole ServeEnv path: the env samples its own arrivals
        serve_env = jvec.ServeEnv(jenv, queue_cap=QCAP, n_requests=N_REQ)
        _, qs, res = serve_env.serve_specs(
            japp, jvec.stack_specs(_jax_specs(jenv, japp)), tspec, cfg=cfg)
        for g, tree in (("env", res), ("envq", qs)):
            for f in tree._fields:
                out[f"{load}/{g}/{f}"] = np.asarray(getattr(tree, f))
    return out


def reference_without_fma(module: str, fn: str, out_dir,
                          meanwhile=None):
    """``module.fn()`` (a dict of numpy arrays) computed in a fresh process
    whose XLA targets AVX, an ISA without fused multiply-add: the jitted
    reference then rounds each multiply and each add, as the port does.
    With FMA available XLA contracts ``a*b + c`` inside its fusions, and
    which pairs it contracts depends on the fusion (ROADMAP C1).  Returns
    ``(meanwhile(), tables)``, running ``meanwhile`` while the process
    works."""
    path = Path(out_dir) / f"{module}.{fn}.npz"
    code = (f"import sys, numpy as np; sys.path[:0] = [{str(SRC)!r}, "
            f"{str(TESTS)!r}, {str(ROOT)!r}]; import {module} as m; "
            f"np.savez({str(path)!r}, **m.{fn}())")
    flags = without_fma(os.environ.get("XLA_FLAGS", ""))
    env = dict(os.environ, XLA_FLAGS=flags, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(SRC))
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        early = meanwhile() if meanwhile is not None else None
        log, _ = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, log
    with np.load(path) as z:
        return early, {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """(reference as jitted here, reference jitted without FMA)."""
    return reference_without_fma("test_torch_serve", "reference_tables",
                                 tmp_path_factory.mktemp("nofma"),
                                 meanwhile=reference_tables)


def _port_run(tab, load, chunks=1):
    g = lambda grp, cls: cls(*(torch.as_tensor(tab[f"{load}/{grp}/{f}"])
                                for f in cls._fields if f in XS_FIELDS
                                or cls is tref.ServeParams
                                or (cls is tref.ServeCarry
                                    and f in CARRY_FIELDS)))
    xs = g("xs", tref.StepInputs)
    sp = g("sp", tref.ServeParams)
    carry = g("carry0", tref.ServeCarry)
    arr = {f: torch.as_tensor(tab[f"{load}/arr/{f}"])
           for f in ("t_arr", "deadline", "priority")}
    s = SoCStatic.from_config(TSOCS["SoC1"])
    learned = torch.tensor([True, False, False])
    bounds = np.linspace(0, N_REQ, chunks + 1).astype(int)
    ys = []
    for lo, hi in zip(bounds, bounds[1:]):
        carry, y = tops.fused_serve_episode(
            s, learned, tr.PAPER_DEFAULT_WEIGHTS, sp, carry,
            tref.StepInputs(*(v[:, lo:hi] for v in xs[:15])),
            arr["t_arr"][:, lo:hi], arr["deadline"][:, lo:hi],
            arr["priority"][:, lo:hi])
        ys.append(y)
    return carry, torch.cat(ys, 1).numpy()


def _compare(tab, load, carry, ys, ints_only=False):
    want = tab[f"{load}/ys/y"]
    for c, name in enumerate(tref.SERVE_YCOLS):
        if name in INT_COLS:
            np.testing.assert_array_equal(ys[..., c], want[..., c],
                                          err_msg=name)
        elif not ints_only:
            np.testing.assert_allclose(ys[..., c], want[..., c],
                                       err_msg=name, **TOL)
    for name in CARRY_FIELDS:
        got = getattr(carry, name).numpy()
        ref = tab[f"{load}/carry/{name}"]
        if name in ("head", "step"):
            np.testing.assert_array_equal(got, ref, err_msg=name)
        elif not ints_only:
            np.testing.assert_allclose(got, ref, err_msg=name, **TOL)


@pytest.mark.parametrize("load", sorted(LOADS))
def test_serve_episode_ref_matches_reference(tables, load):
    """All columns against the reference compiled without FMA; the
    integer columns (admission, shedding, watchdog, decisions) also
    against the reference as jitted on this host."""
    here, nofma = tables
    carry, ys = _port_run(nofma, load)
    _compare(nofma, load, carry, ys)
    carry_h, ys_h = _port_run(here, load)
    _compare(here, load, carry_h, ys_h, ints_only=True)
    ex = ys[..., tref.SERVE_YCOLS.index("executed")]
    deg = ys[..., tref.SERVE_YCOLS.index("degraded")]
    if load == "over":
        assert ex.mean() < 0.9           # shedding happens
        assert deg.max() == 1.0          # the watchdog trips
    else:
        assert ex.mean() == 1.0


def test_serve_chunks_chain(tables):
    """Three chunks chained through the returned carry equal one whole
    chunk."""
    _, nofma = tables
    carry, ys = _port_run(nofma, "over", chunks=3)
    _compare(nofma, "over", carry, ys)


def _port_specs(tenv, tapp):
    sched = tapp.schedule
    return tvec.stack_specs([
        tvec.learned_policy_spec(tq.init_qstate(tq.QConfig()), sched),
        tvec.fixed_policy_spec(tenv.params, sched, 0),
        tvec.fixed_policy_spec(tenv.params, sched, 3)])


@pytest.mark.parametrize("load", sorted(LOADS))
def test_serve_env_serve_specs_matches_reference(tables, load):
    """ServeEnv.serve_specs end to end (the port draws its own arrivals,
    whose clock agrees to 2 ULP): all columns against the reference
    compiled without FMA, integer columns against the reference as jitted
    here."""
    here, nofma = tables
    _, _, _, tenv, tapp = _setup()
    serve_env = tvec.ServeEnv(tenv, queue_cap=QCAP, n_requests=N_REQ)
    _, qs, res = serve_env.serve_specs(
        tapp, _port_specs(tenv, tapp), _traffic(ttraffic, LOADS[load]),
        cfg=tq.QConfig(decay_steps=60))
    for tab, ints_only in ((nofma, False), (here, True)):
        for f in tvec.ServeResult._fields:
            got = getattr(res, f).numpy()
            want = tab[f"{load}/env/{f}"]
            if not np.issubdtype(want.dtype, np.floating) or f in (
                    "retries", "depth"):
                np.testing.assert_array_equal(got, want, err_msg=f)
            elif not ints_only:
                np.testing.assert_allclose(got, want, err_msg=f, **TOL)
        for f in ("visits", "step", "frozen"):
            np.testing.assert_array_equal(getattr(qs, f).numpy(),
                                          tab[f"{load}/envq/{f}"])


def test_serve_without_traffic_is_the_episode():
    """``serve(traffic=None)`` is ``episode_spec``, bitwise."""
    _, _, _, tenv, tapp = _setup()
    serve_env = tvec.ServeEnv(tenv, queue_cap=QCAP, n_requests=N_REQ)
    spec = tvec.learned_policy_spec(tq.init_qstate(tq.QConfig()),
                                    tapp.schedule)
    key = prng.PRNGKey(5)
    qs_a, res_a = serve_env.serve(tapp, spec, None, key=key)
    qs_b, res_b = tenv.episode_spec(tapp, spec, key=key)
    for a, b in zip((*qs_a, *res_a), (*qs_b, *res_b)):
        assert torch.equal(a, b)


def test_serve_env_chunks_chain():
    """A stream served in two chunks: the carry and the clock cross the
    boundary (arrivals resume after the first chunk's end; the decay
    counter and the visits accumulate)."""
    _, _, _, tenv, tapp = _setup()
    serve_env = tvec.ServeEnv(tenv, queue_cap=QCAP, n_requests=N_REQ)
    spec = tvec.learned_policy_spec(tq.init_qstate(tq.QConfig()),
                                    tapp.schedule)
    tspec = _traffic(ttraffic, LOADS["over"])
    c1, q1, r1 = serve_env.serve(tapp, spec, tspec, key=prng.PRNGKey(1))
    spec2 = spec._replace(qstate=q1)
    c2, q2, r2 = serve_env.serve(tapp, spec2, ttraffic.chunk_key(tspec, 1),
                                 key=prng.PRNGKey(2), carry=c1,
                                 t0=r1.t_end)
    assert float(r2.t_arr[0]) > float(r1.t_end)
    assert int(q2.step[0]) == int(c2.step[0])
    assert int(q2.visits.sum()) == int(r1.executed.sum() + r2.executed.sum())
    assert float(c2.busy.max()) >= float(c1.busy.max())
