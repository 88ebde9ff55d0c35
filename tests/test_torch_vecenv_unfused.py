"""The unfused episode step (``VecEnv(fused_step=False)`` and its
``demand_cache`` / ``presample_noise`` ablations) against repro's, and
against the port's fused step, on the CPU.

Cases: SoC-motiv-par (12 accelerators) running a 3-thread chain app (3
phases of 3-invocation chains looped twice, 54 steps) under a fresh Q
agent, fixed NON_COH-to-FULLY_COH modes and manual, from ``PRNGKey(3)``,
at each flag set — fused (the default), unfused, unfused with the demand
recomputed every step, and that with per-step key splitting as well
(the reference's original step), plus unfused with DDR attribution and
an MLP agent through the fused and the unfused step.  Against the
reference the integer traces (mode, state_idx, visits, step) must equal
both builds and the floats be bitwise the build without fused
multiply-add (:func:`test_torch_serve.reference_without_fma`), the MLP's
weights included; against the FMA build within rtol = 2e-6, atol = 1e-6,
the MLP's weights within the measured 1.2e-7.  The port's
unfused and fused steps must be bitwise equal for q, fixed and manual,
for batched training (2 iterations, 3 agents) and for a 2-lane stacked
call, as ``tests/test_vecenv_equivalence.py`` asks of the reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qlearn as jq, rewards as jr
from repro.soc import nn as jnn, vecenv as jvec
from repro.soc.apps import make_phase as j_make_phase
from repro.soc.config import SOCS as JSOCS
from repro.soc.des import Application as JApp
from repro_torch import random as prng
from repro_torch.core import qlearn as tq, rewards as tr
from repro_torch.soc import nn as tnn, stacked as tstk, vecenv as tvec
from repro_torch.soc.apps import make_phase as t_make_phase
from repro_torch.soc.config import SOCS as TSOCS
from repro_torch.soc.des import Application as TApp
from test_torch_serve import reference_without_fma

SOC = "SoC-motiv-par"
TILE_SEED = 7
TOL_FMA = dict(rtol=2e-6, atol=1e-6)
FLAGS = {
    "fused": dict(),
    "unfused": dict(fused_step=False),
    "recompute": dict(demand_cache=False),
    "pr1": dict(demand_cache=False, presample_noise=False),
    "ddr": dict(fused_step=False, ddr_attribution=True),
}
POLICIES = ("q", "fixed", "manual")
INT_LEAVES = ("mode", "state_idx", "visits", "step")


def _app(make_phase, app_cls, soc, n_threads=3):
    rng = np.random.default_rng(6)
    phases = [make_phase(rng, soc, name=f"p{i}", n_threads=n_threads,
                         size_classes=[c], chain_len=3, loops=2)
              for i, c in enumerate(("S", "M", "L"))]
    return app_cls(name=f"{soc.name}-chain{n_threads}", phases=phases)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _record(out, tag, qs, res, port):
    for f in res._fields:
        out[f"{tag}/{f}"] = _np(getattr(res, f))
    for f in ("qtable", "visits", "step"):
        v = _np(getattr(qs, f))
        out[f"{tag}/{f}"] = v[0] if port else v


def _mlp_spec(port: bool, compiled):
    """A perturbed, learning "sense" network lowered as a spec.  Its
    initial pack comes from the port's initialiser, which is bitwise the
    no-FMA reference's, so that both builds and the port start from the
    same weights (the reference's own initialiser rounds apart between
    its builds, ROADMAP C5)."""
    jm = jnn.init_mlp_qstate(jax.random.PRNGKey(2), jnn.MLPConfig())
    w = tnn.init_mlp_qstate(prng.PRNGKey(2)).wpack[0].numpy().copy()
    w += np.random.default_rng(2).normal(0, 0.3, w.shape).astype(np.float32)
    if not port:
        return jvec.mlp_policy_spec(jm._replace(wpack=jnp.asarray(w)),
                                    compiled.schedule)
    mlp = tnn.mlp_from_numpy(w, np.asarray(jm.lr), np.asarray(jm.step),
                             np.asarray(jm.frozen), jm.cfg)
    return tvec.mlp_policy_spec(mlp, compiled.schedule)


def _tables(port: bool) -> dict:
    soc = (TSOCS if port else JSOCS)[SOC]
    if port:
        compiled = tvec.compile_app(_app(t_make_phase, TApp, soc), soc,
                                    seed=TILE_SEED)
        make = lambda **kw: tvec.VecEnv(soc, seed=0, device="cpu", **kw)
        key = prng.PRNGKey(3)
    else:
        compiled = jvec.compile_app(_app(j_make_phase, JApp, soc), soc,
                                    seed=TILE_SEED)
        make = lambda **kw: jvec.VecEnv(soc, seed=0, **kw)
        key = jax.random.PRNGKey(3)
    out = {}
    for name, kw in FLAGS.items():
        env = make(**kw)
        for pol in POLICIES:
            qs, res = env.episode(compiled, policy=pol, key=key)
            _record(out, f"{name}/{pol}", qs, res, port)
    for name in ("fused", "unfused"):
        env = make(**FLAGS[name])
        (qs, mlp), res = env.episode_spec(
            compiled, _mlp_spec(port, compiled), key=key)
        _record(out, f"{name}/mlp", qs, res, port)
        out[f"{name}/mlp/wpack"] = _np(mlp.wpack)[0] if port else \
            _np(mlp.wpack)
        out[f"{name}/mlp/mlp_step"] = _np(mlp.step).reshape(-1)
    return out


def reference_tables() -> dict:
    return _tables(False)


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """(reference as jitted here, reference without FMA, the port)."""
    jit_tab, nofma = reference_without_fma(
        "test_torch_vecenv_unfused", "reference_tables",
        tmp_path_factory.mktemp("nofma"), meanwhile=reference_tables)
    return jit_tab, nofma, _tables(True)


CASES = [f"{f}/{p}" for f in FLAGS for p in POLICIES] + ["fused/mlp",
                                                          "unfused/mlp"]
# The MLP's weights after the 54 steps, fused or unfused, against the FMA
# build: its contractions (ROADMAP C1) move 68 of 784 entries by one
# float32 ULP, 1.19e-7 absolute (measured).  Against the no-FMA build the
# pack is bitwise.
PACK_FMA_GAP = 1.2e-7


@pytest.mark.parametrize("case", CASES)
def test_unfused_matches_reference(tables, case):
    """Each flag set and policy: integer traces equal to both builds,
    floats bitwise the no-FMA build and within TOL_FMA of the FMA
    build."""
    jit_tab, nofma, port = tables
    keys = [k for k in port if k.startswith(case + "/")]
    assert len(keys) >= 10
    for k in keys:
        f = k.rsplit("/", 1)[1]
        if k.endswith("/mlp/wpack"):
            np.testing.assert_allclose(port[k], jit_tab[k], rtol=0.0,
                                       atol=PACK_FMA_GAP, err_msg=k)
            np.testing.assert_array_equal(port[k], nofma[k], err_msg=k)
            continue
        if f in INT_LEAVES:
            np.testing.assert_array_equal(port[k], jit_tab[k], err_msg=k)
        else:
            np.testing.assert_allclose(port[k], jit_tab[k], err_msg=k,
                                       **TOL_FMA)
        np.testing.assert_array_equal(port[k], nofma[k], err_msg=k)


@pytest.mark.parametrize("flags,policy", [
    (f, p) for f in ("unfused", "recompute") for p in POLICIES] + [
    ("unfused", "mlp")])
def test_unfused_equals_fused_bitwise(tables, flags, policy):
    """The port's unfused step (with or without the demand cache) equals
    its fused step bit for bit: traces, phase metrics, the trained
    Q-state and an MLP agent's weights."""
    port = tables[2]
    for k in [k for k in port if k.startswith(f"fused/{policy}/")]:
        np.testing.assert_array_equal(
            port[k], port[k.replace("fused/", f"{flags}/", 1)], err_msg=k)


def test_train_batched_unfused_equals_fused():
    """Two iterations of 3 agents on a 2-thread app: the trained QState
    (table, visits, step) and the evaluation histories are bitwise equal
    through both steps."""
    soc = TSOCS[SOC]
    compiled = tvec.compile_app(_app(t_make_phase, TApp, soc, 2), soc,
                                seed=TILE_SEED)
    cfg = tq.QConfig(decay_steps=compiled.n_steps * 2)
    wb = tr.stack_weights([tr.PAPER_DEFAULT_WEIGHTS] * 3)
    out = {}
    for fused in (False, True):
        env = tvec.VecEnv(soc, seed=0, fused_step=fused, device="cpu")
        out[fused] = env.train_batched([compiled] * 2, cfg, wb,
                                       prng.PRNGKey(np.arange(3)),
                                       eval_app=compiled)
    (qa, ha), (qb, hb) = out[False], out[True]
    for a, b in zip((*qa, *ha), (*qb, *hb)):
        assert torch.equal(a, b)


def test_stacked_unfused_equals_fused():
    """A 2-lane stacked call (padded, gated) through the unfused step,
    lane by lane, equals the fused one-launch call bitwise."""
    socs = [TSOCS["SoC1"], TSOCS[SOC]]
    apps = [_app(t_make_phase, TApp, s, t) for s, t in zip(socs, (1, 2))]
    res = {}
    for fused in (None, False):
        env = tstk.StackedVecEnv(socs, fused_step=fused, device="cpu")
        st = env.compile(apps, seed=TILE_SEED)
        from repro_torch.core.policies import FixedHomogeneous, ManualPolicy
        specs = env.lower(st, [FixedHomogeneous(2), ManualPolicy()])
        qs = tq.init_qstate_batch(tq.QConfig(), 2)
        specs = tstk._join_specs([specs, env.lower_qstates(
            st, tq.QState(*(v.expand(2, *v.shape) for v in qs)),
            freeze=False)], lambda vs: torch.cat(vs, 1))
        res[fused] = env.episodes(st, specs)
    for a, b in zip(res[None], res[False]):
        assert torch.equal(a, b)


def test_flag_rules():
    """The reference's rules: fused only on the fast path, DDR attribution
    only with the demand cache, MLP specs only on the fast path."""
    soc = TSOCS[SOC]
    env = tvec.VecEnv(soc, device="cpu")
    assert env.fused_step
    assert not tvec.VecEnv(soc, demand_cache=False,
                           device="cpu").fused_step
    assert not tvec.VecEnv(soc, presample_noise=False,
                           device="cpu").fused_step
    with pytest.raises(ValueError, match="fused_step requires"):
        tvec.VecEnv(soc, presample_noise=False, fused_step=True,
                    device="cpu")
    with pytest.raises(ValueError, match="ddr_attribution"):
        tvec.VecEnv(soc, demand_cache=False, ddr_attribution=True,
                    device="cpu")
    compiled = tvec.compile_app(_app(t_make_phase, TApp, soc, 1), soc,
                                seed=TILE_SEED)
    slow = tvec.VecEnv(soc, presample_noise=False, device="cpu")
    with pytest.raises(ValueError, match="MLP PolicySpecs"):
        slow.episode_spec(compiled, _mlp_spec(True, compiled))
