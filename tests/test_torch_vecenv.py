"""The port's slice as a whole against repro: batched Cohmeleon training,
frozen evaluation and the 7-policy comparison on SOC_MOTIV_PAR, both
packages from the same integer seeds, the port on the CPU.

Integer traces, visits and steps must match exactly; float results are
held to rtol=atol=2e-5 (measured: Q-tables 2.4e-7 absolute, evaluated
normalized metrics 1.1e-7 relative — XLA and eager torch round a few
float32 sums differently, which moved no state and no action here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import orchestrator as jorch
from repro.core import policies as jpol
from repro.core.modes import CoherenceMode as JMode
from repro.soc import apps as japps
from repro.soc import config as jcfg
from repro.soc import vecenv as jvec
from repro_torch import resolve_device
from repro_torch.core import orchestrator as torch_orch
from repro_torch.core import policies as tpol
from repro_torch.core.modes import CoherenceMode as TMode
from repro_torch.soc import apps as tapps
from repro_torch.soc import config as tcfg
from repro_torch.soc import vecenv as tvec

TOL = dict(rtol=2e-5, atol=2e-5)
WEIGHTS = [(0.675, 0.075, 0.25), (0.05, 0.05, 0.90)]


@pytest.fixture(scope="module")
def trained():
    kw = dict(iterations=3, seed=11, weights=WEIGHTS, n_seeds=2,
              n_phases=2)
    jres = jorch.train_cohmeleon_batched(jcfg.SOC_MOTIV_PAR, **kw)
    tres = torch_orch.train_cohmeleon_batched(tcfg.SOC_MOTIV_PAR,
                                              device="cpu", **kw)
    return jres, tres


def test_batched_training_matches(trained):
    jres, tres = trained
    assert tres.n_agents == jres.n_agents == 4
    np.testing.assert_allclose(tres.qstates.qtable.numpy(),
                               np.asarray(jres.qstates.qtable), **TOL)
    np.testing.assert_array_equal(tres.qstates.visits.numpy(),
                                  np.asarray(jres.qstates.visits))
    np.testing.assert_array_equal(tres.qstates.step.numpy(),
                                  np.asarray(jres.qstates.step))
    assert tres.cfg.decay_steps == jres.cfg.decay_steps


def test_evaluation_matches(trained):
    jres, tres = trained
    jt, jm = jres.evaluate(japps.make_application(jcfg.SOC_MOTIV_PAR,
                                                  seed=900, n_phases=2),
                           seed=5)
    tt, tm = tres.evaluate(tapps.make_application(tcfg.SOC_MOTIV_PAR,
                                                  seed=900, n_phases=2),
                           seed=5)
    np.testing.assert_allclose(tt, jt, **TOL)
    np.testing.assert_allclose(tm, jm, **TOL)
    np.testing.assert_allclose(tres.per_weight(tt), jres.per_weight(jt),
                               **TOL)


def _episode(run):
    """A ``compare_policies`` run (a RunResult) as the batched episode's
    float32 traces and phase metrics it was lifted from (exact: every
    value came from a float32 tensor)."""
    recs = [r for p in run.phases for r in p.invocations]
    f32 = lambda vals: torch.tensor(vals, dtype=torch.float32)
    i32 = lambda vals: torch.tensor(vals, dtype=torch.int32)
    return tvec.EpisodeResult(
        phase_time=f32([p.wall_time for p in run.phases]),
        phase_offchip=f32([p.offchip_accesses for p in run.phases]),
        mode=i32([r.mode for r in recs]),
        state_idx=i32([r.state_idx for r in recs]),
        exec_time=f32([r.exec_time for r in recs]),
        offchip=f32([r.offchip_true for r in recs]),
        reward=f32([r.reward for r in recs]))


def test_policy_suite_one_call_matches(trained):
    jres, tres = trained
    japp = japps.make_application(jcfg.SOC_MOTIV_PAR, seed=900, n_phases=2)
    tapp = tapps.make_application(tcfg.SOC_MOTIV_PAR, seed=900, n_phases=2)
    seed = 5
    jsuite = ([jpol.FixedHomogeneous(JMode.NON_COH_DMA)]
              + [jpol.FixedHomogeneous(m) for m in JMode]
              + [jpol.RandomPolicy(), jpol.ManualPolicy(), jres.qpolicy(0)])
    jenv = jres.env
    jc = jvec.compile_app(japp, jenv.soc, seed=seed)
    jspecs = jvec.stack_specs([p.lower(jenv, jc) for p in jsuite])
    jout = jenv.episodes(jc, jspecs, keys=jax.vmap(jax.random.PRNGKey)(
        jnp.arange(len(jsuite)) + seed))

    tsuite = ([tpol.FixedHomogeneous(m) for m in TMode]
              + [tpol.RandomPolicy(), tpol.ManualPolicy(), tres.qpolicy(0)])
    cmp = torch_orch.compare_policies(tres.env, tapp, tsuite, seed=seed)
    assert cmp.policies == [p.name for p in jsuite[1:]]
    names = ["fixed-non-coh-dma"] + cmp.policies
    for i, name in enumerate(names):
        got = _episode(cmp.raw[name])
        for field in ("mode", "state_idx"):
            np.testing.assert_array_equal(
                getattr(got, field).numpy(),
                np.asarray(getattr(jout, field)[i]), err_msg=name)
        for field in ("phase_time", "phase_offchip", "exec_time",
                      "offchip", "reward"):
            np.testing.assert_allclose(
                getattr(got, field).numpy(),
                np.asarray(getattr(jout, field)[i]), err_msg=name, **TOL)
    # per-phase normalization as the reference's vecenv backend does it
    pt = np.asarray(jout.phase_time, np.float64)
    for i, name in enumerate(cmp.policies, start=1):
        np.testing.assert_allclose(cmp.norm_time[name], pt[i] / pt[0],
                                   **TOL)
        nt, nm = tvec.normalized_metrics(
            _episode(cmp.raw[name]), _episode(cmp.raw["fixed-non-coh-dma"]))
        jt, jm = jvec.normalized_metrics(
            jax.tree_util.tree_map(lambda x: x[i], jout),
            jax.tree_util.tree_map(lambda x: x[0], jout))
        np.testing.assert_allclose(float(nt), float(jt), **TOL)
        np.testing.assert_allclose(float(nm), float(jm), **TOL)
        np.testing.assert_allclose(cmp.geomean(name), (float(jt), float(jm)),
                                   **TOL)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)
        with pytest.raises(RuntimeError):
            tvec.VecEnv(tcfg.SOC_MOTIV_PAR)
        with pytest.raises(RuntimeError):
            torch_orch.train_cohmeleon_batched(tcfg.SOC_MOTIV_PAR,
                                               iterations=1, n_phases=1)
