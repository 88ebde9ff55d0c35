"""The port's Fig. 6 and Fig. 9 ``--fidelity`` drivers against the
reference's, on the CPU, at cut depth (Fig. 9's ``_run_des`` in
``tests/test_torch_fidelity_fig9.py``, with this file's helpers).

Both packages run the same driver code from the same seeds (the port with
``device="cpu"``):

* Fig. 6's ``_des_points`` (``benchmarks/torch_fig6_reward_dse.
  des_points``): the first two weightings, one iteration, the train and
  test apps cut from 6 phases to ``PHASES``;
* Fig. 9's ``_des_crosscheck`` (``torch_fig9_socs.des_crosscheck``) on
  two lanes, SoC0-streaming and SoC1-mixed (the full figure runs eight);
* Fig. 9's ``_run_des`` (``torch_fig9_socs.run_des``) on the SoC1-mixed
  lane, one iteration, quick (no profiled baseline), apps cut from 4
  phases to ``PHASES``.

Both packages' drivers run as they are, the ``train_cohmeleon`` and
``make_application`` they call wrapped to take ``PHASES`` phases, and
every ``compare_policies`` call recorded: each run's
``acc_id``, ``mode`` and ``state_idx`` per invocation and its per-phase
wall time and off-chip count.  The integers must equal both reference
builds' (the one jitted here and the one compiled without fused
multiply-add, ``test_torch_serve.reference_without_fma``, ROADMAP C1);
the floats (points, rows, headline, cross-check error, phase metrics)
must be bitwise the no-FMA build's and within rtol = 2e-6, atol = 1e-6
of the FMA build's (the DES's measured bound, ``tests/test_torch_des.py``;
measured here: 1.0e-8 relative).
"""
import numpy as np
import pytest

from benchmarks import torch_fig6_reward_dse as t6, torch_fig9_socs as t9
from test_torch_serve import reference_without_fma

PHASES = 2
TOL_FMA = dict(rtol=2e-6, atol=1e-6)
XCHECK_LANES = [("SoC0", "streaming"), ("SoC1", "mixed")]
DES_LANE = [("SoC1", "mixed")]
INT_FIELDS = ("acc_id", "mode", "state_idx")


def _recorder(out, prefix, compare):
    """``compare`` that records each call's runs into ``out``."""
    calls = []

    def recording(*args, **kwargs):
        cmp = compare(*args, **kwargs)
        tag = f"{prefix}/call{len(calls)}"
        calls.append(tag)
        for name, res in cmp.raw.items():
            recs = [r for p in res.phases for r in p.invocations]
            for f in INT_FIELDS:
                out[f"{tag}/{name}/{f}"] = np.asarray(
                    [int(getattr(r, f)) for r in recs])
            out[f"{tag}/{name}/phases"] = np.asarray(
                [[p.wall_time, p.offchip_accesses] for p in res.phases],
                np.float64)
        return cmp

    return recording


def _points(out, prefix, points):
    out[f"{prefix}/points"] = np.asarray(
        [[p["time"], p["mem"]] for p in points.values()], np.float64)


def _rows(out, prefix, results):
    for soc, row in results.items():
        if soc.startswith("_"):
            continue
        out[f"{prefix}/{soc}"] = np.asarray(
            [v for fam in sorted(row["all"]) for v in row["all"][fam]]
            + [row["speedup_vs_fixed"], row["mem_reduction_vs_fixed"]],
            np.float64)
    h = results["_headline"]
    out[f"{prefix}/headline"] = np.asarray(
        [h["mean_speedup_vs_fixed"], h["mean_mem_reduction_vs_fixed"]])


def _cut(fn):
    """``fn`` with its ``n_phases`` argument cut to ``PHASES``."""
    return lambda *args, **kwargs: fn(*args, **dict(kwargs,
                                                    n_phases=PHASES))


def _wrapped(driver, orchestrator, apps, prefix: str, run) -> dict:
    """``run(out)`` with the names ``driver`` looks up (the reference's
    driver module imports them; the port's drivers read them from
    ``orchestrator`` and ``apps`` when called) wrapped: apps cut to
    ``PHASES`` phases, ``compare_policies`` calls recorded under
    ``prefix``; returns the record."""
    out = {}
    names = (("train_cohmeleon", orchestrator), ("compare_policies",
                                                 orchestrator),
             ("make_application", apps))
    saved = {n: getattr(driver or m, n) for n, m in names}
    wrap = {"train_cohmeleon": _cut, "make_application": _cut,
            "compare_policies": lambda f: _recorder(out, prefix, f)}
    try:
        for n, m in names:
            setattr(driver or m, n, wrap[n](saved[n]))
        run(out)
    finally:
        for n, m in names:
            setattr(driver or m, n, saved[n])
    return out


def reference_driver(module, prefix: str, run) -> dict:
    """``run(module, out)`` on the reference's driver ``module``."""
    from repro.core import orchestrator
    from repro.soc import apps
    return _wrapped(module, orchestrator, apps, prefix,
                    lambda out: run(module, out))


def port_driver(prefix: str, run) -> dict:
    """``run(out)`` on the port's drivers."""
    from repro_torch.core import orchestrator
    from repro_torch.soc import apps
    return _wrapped(None, orchestrator, apps, prefix, run)


def reference_fidelity() -> dict:
    """The reference's ``_des_points`` and ``_des_crosscheck`` at cut
    depth (run without FMA by the fixture below, and in this process)."""
    from benchmarks import fig6_reward_dse as f6, fig9_socs as f9
    from repro.soc.config import SOCS
    from repro.soc.des import SoCSimulator
    from repro.soc.stacked import StackedVecEnv

    out = reference_driver(f6, "fig6", lambda m, o: _points(
        o, "fig6", m._des_points(t6.WEIGHTS[:2], 1)))
    sims = [SoCSimulator(SOCS[n], seed=1, flavor=f) for n, f in XCHECK_LANES]
    x = f9._des_crosscheck(StackedVecEnv.from_simulators(sims), sims)
    out["xcheck"] = np.asarray([x["max_rel_err"], float(x["agree"])])
    return out


def _port() -> dict:
    out = port_driver("fig6", lambda o: _points(o, "fig6", t6.des_points(
        t6.WEIGHTS[:2], 1, "cpu")[0]))
    x = t9.crosscheck_port("cpu", XCHECK_LANES)
    out["xcheck"] = np.asarray([x["max_rel_err"], float(x["agree"])])
    return out


def both(module: str, fn: str, tmp, port) -> tuple:
    """(the reference's ``module.fn()`` jitted here, the same without
    FMA, ``port()``), the three run side by side."""
    return reference_without_fma(module, fn, tmp,
                                 meanwhile=lambda: (getattr(
                                     __import__(module), fn)(), port()))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    (jit_tab, port), nofma = both("test_torch_fidelity", "reference_fidelity",
                                  tmp_path_factory.mktemp("nofma"), _port)
    return jit_tab, nofma, port


def _check(runs, prefix):
    jit_tab, nofma, port = runs
    keys = sorted(k for k in jit_tab if k.startswith(prefix))
    assert keys and keys == sorted(k for k in port if k.startswith(prefix))
    for k in keys:
        if k.rsplit("/", 1)[-1] in INT_FIELDS:
            np.testing.assert_array_equal(port[k], jit_tab[k], err_msg=k)
        else:
            np.testing.assert_allclose(port[k], jit_tab[k], err_msg=k,
                                       **TOL_FMA)
        np.testing.assert_array_equal(port[k], nofma[k], err_msg=k)
    return keys


def test_fig6_des_points(runs):
    """Two weightings' (time, mem) points and both compare calls' runs
    (NON_COH and the frozen agent on the test app)."""
    keys = _check(runs, "fig6")
    assert sum(k.endswith("/mode") for k in keys) == 2 * 2


def test_fig9_des_crosscheck(runs):
    """The cross-check's error and verdict on two lanes, ``agree``."""
    _check(runs, "xcheck")
    assert runs[2]["xcheck"][1] == 1.0
