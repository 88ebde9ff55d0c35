"""The port's Fig. 9 ``--fidelity`` path (``torch_fig9_socs.run_des``)
against the reference's ``fig9_socs._run_des``, on the CPU, at cut depth:
the SoC1-mixed lane, one iteration, quick (no profiled baseline), the
train and evaluation apps cut from 4 phases to 2.  The record, the
reference's wrapping and the bounds are ``tests/test_torch_fidelity.py``'s:
integer traces equal to both reference builds, floats bitwise the no-FMA
build's and within rtol = 2e-6, atol = 1e-6 of the FMA build's (measured:
1.4e-8 relative).

Beside it, ``vecenv.normalized_metrics`` (every batched figure's per-SoC
geomean) on 2,000 random 4- and 8-phase episodes against the reference's
eager one: bitwise the no-FMA build's, within two float32 ulps (2.4e-7
relative) of the FMA build's, whose log and exp polynomials are
contracted (measured 1.8e-7, 38 of 4,000 apart).  With ``torch.log`` /
``torch.exp`` 15% of them lay an ulp from the no-FMA build's (ROADMAP
C10).
"""
import numpy as np
import pytest
import torch

from benchmarks import torch_fig9_socs as t9
from test_torch_fidelity import (_check, _rows, both, port_driver,
                                 reference_driver)

DES_LANE = [("SoC1", "mixed")]


def _episodes():
    """Random (time, off-chip) phase metrics of 2,000 episodes and their
    baselines, 4 or 8 phases each."""
    rng = np.random.default_rng(0)
    for i in range(2000):
        k = 4 if i % 2 else 8
        yield (rng.uniform(1e-4, 1e-2, (2, k)).astype(np.float32),
               rng.integers(0, 10 ** 6, (2, k)).astype(np.float32))


def _norms(vec, tensor, np_of) -> np.ndarray:
    out = []
    for t, o in _episodes():
        res = [vec.EpisodeResult(tensor(t[i]), tensor(o[i]), *[None] * 5)
               for i in range(2)]
        out.append([np_of(x) for x in vec.normalized_metrics(*res)])
    return np.asarray(out, np.float32)


def reference_run_des() -> dict:
    """The reference's ``_run_des`` at cut depth and its normalized
    metrics."""
    import jax.numpy as jnp
    from benchmarks import fig9_socs as f9
    from repro.soc import vecenv
    out = reference_driver(f9, "fig9", lambda m, o: _rows(
        o, "fig9", m._run_des(DES_LANE, 1, True)))
    out["norms"] = _norms(vecenv, jnp.asarray, np.asarray)
    return out


def _port() -> dict:
    from repro_torch.soc import vecenv
    out = port_driver("fig9", lambda o: _rows(o, "fig9", t9.run_des(
        "cpu", DES_LANE, 1, quick=True)))
    out["norms"] = _norms(vecenv, torch.from_numpy, lambda x: x.numpy())
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    (jit_tab, port), nofma = both("test_torch_fidelity_fig9",
                                  "reference_run_des",
                                  tmp_path_factory.mktemp("nofma"), _port)
    return jit_tab, nofma, port


def test_fig9_run_des(runs):
    """One lane's rows (every family's geomean, speedup, off-chip
    reduction), the headline, and the compare call's 7 runs (the four
    fixed modes, NON_COH among them as the baseline, random, manual, the
    agent)."""
    keys = _check(runs, "fig9")
    assert sum(k.endswith("/mode") for k in keys) == 7


def test_normalized_metrics_bitwise_without_fma(runs):
    jit_tab, nofma, port = runs
    np.testing.assert_array_equal(port["norms"], nofma["norms"])
    np.testing.assert_allclose(port["norms"], jit_tab["norms"],
                               rtol=2.4e-7, atol=0)
