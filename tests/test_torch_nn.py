"""The neural agent (``repro_torch.soc.nn``), its MLP episode (the plain
version of the fused step's MLP branch), ``StackedVecEnv.lower_mlps``,
``train_portfolio`` and ``dse.sample_socs`` against repro's, on the CPU.

Cases (``tests/test_soc_nn.py`` and ``tests/test_policy_spec.py:186,211``
at a small size): SoC1 (7 accelerators, 4 memory tiles) and
SoC-motiv-iso running chain applications of two phases; the default
"sense" network (14, 16, 16, 4) and a one-hot (243, 8, 4) one; two lanes
(SoC6, SoC2) x two networks for ``lower_mlps``; a portfolio of two pairs
(SoC6, SoC2) trained for two iterations of two episodes.  The port's own
``init_mlp_qstate`` must be bitwise the reference's compiled without
fused multiply-add (``test_torch_serve.reference_without_fma``, ROADMAP
C1), which ``mlp_from_numpy`` carries across, and within 2e-5 of the FMA
build's; the port's episodes start from its own init.  Integer
columns must equal the no-FMA reference and floats lie within rtol = atol
= 2e-5 of it.  Measured: the SoC1 episode (sense and one-hot, healthy and
under a storm) and the stacked episodes bitwise; the portfolio's packs
within 3e-11 (SoC6's episode has one exec_time a ULP off, ROADMAP C1's
open Fig. 9 gap) and its reward history equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qlearn as jq
from repro.soc import dse as jdse, faults as jf, nn as jnn
from repro.soc import stacked as jstk, vecenv as jvec
from repro.soc.apps import make_phase as j_make_phase
from repro.soc.config import SOCS as JSOCS
from repro.soc.des import Application as JApp
from repro_torch import random as prng
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import qlearn as tq
from repro_torch.core.policies import ManualPolicy as TManual
from repro_torch.core.policies import QPolicy as TQPolicy
from repro_torch.soc import dse as tdse, faults as tf, nn as tnn
from repro_torch.soc import stacked as tstk, vecenv as tvec
from repro_torch.soc.apps import make_phase as t_make_phase
from repro_torch.soc.config import SOCS as TSOCS, SOC_MOTIV_ISO as T_ISO
from repro_torch.soc.des import Application as TApp
from test_torch_serve import reference_without_fma

TOL = dict(rtol=2e-5, atol=2e-5)
TILE_SEED = 11
ONEHOT = dict(features="onehot", hidden=(8,))
TP = dict(iterations=2, batch=2)


def _chain_app(make_phase, app_cls, soc, seed, n_threads=2, n_phases=2):
    rng = np.random.default_rng(seed)
    phases = [make_phase(rng, soc, name=f"p{i}", n_threads=n_threads,
                         size_classes=[c], chain_len=3, loops=2)
              for i, c in enumerate(("S", "M", "L")[:n_phases])]
    return app_cls(name=f"{soc.name}-nn{seed}", phases=phases)


def _flat(prefix, tree, out):
    for f in tree._fields:
        v = getattr(tree, f)
        if f != "cfg":
            out[f"{prefix}/{f}"] = np.asarray(v)


def _sub(tab, prefix):
    return {k[len(prefix) + 1:]: v for k, v in tab.items()
            if k.startswith(prefix + "/")}


def _j_mlps():
    return {"sense": jnn.init_mlp_qstate(jax.random.PRNGKey(7)),
            "onehot": jnn.init_mlp_qstate(jax.random.PRNGKey(5),
                                          jnn.MLPConfig(**ONEHOT))}


def _j_portfolio(n=2):
    items = []
    for i, name in enumerate(("SoC6", "SoC2")[:n]):
        soc = JSOCS[name]
        comps = [jvec.compile_app(
            _chain_app(j_make_phase, JApp, soc, 10 + i, n_threads=1), soc,
            seed=TILE_SEED)]
        items.append((jvec.VecEnv(soc, seed=0), comps))
    return items


def reference_tables() -> dict:
    """The reference's initial weights, MLP episodes (healthy and under a
    storm), stacked MLP episodes and portfolio training, as numpy."""
    out = {}
    soc = JSOCS["SoC1"]
    env = jvec.VecEnv(soc, seed=0)
    app = jvec.compile_app(_chain_app(j_make_phase, JApp, soc, 6), soc,
                           seed=TILE_SEED)
    cfg = jq.QConfig(decay_steps=app.n_steps)
    for name, mlp in _j_mlps().items():
        _flat(f"init/{name}", mlp, out)
        spec = jvec.mlp_policy_spec(mlp, app.schedule)
        for tag, fs in (("", None), ("storm", jf.storm(
                app.n_steps, 1.0, jax.random.PRNGKey(42)))):
            (qs, m), res = env.episode_spec(app, spec, cfg=cfg,
                                            key=jax.random.PRNGKey(3),
                                            faults=fs)
            _flat(f"ep{tag}/{name}/res", res, out)
            _flat(f"ep{tag}/{name}/qs", qs, out)
            _flat(f"ep{tag}/{name}/mlp", m, out)

    socs = [JSOCS["SoC6"], JSOCS["SoC2"]]
    senv = jstk.StackedVecEnv(socs, seed=0)
    st = senv.compile([_chain_app(j_make_phase, JApp, s, i, n_threads=1)
                       for i, s in enumerate(socs)])
    _flat("stk", senv.episodes(st, senv.lower_mlps(st, _j_grid()),
                               jq.QConfig()), out)

    mlp, hist = jnn.train_portfolio(_j_portfolio(), jq.QConfig(
        decay_steps=2048), key=jax.random.PRNGKey(1), **TP)
    _flat("tp", mlp, out)
    out["tp/hist"] = np.asarray(hist)
    return out


def _j_grid():
    per = [[jnn.init_mlp_qstate(jax.random.PRNGKey(k * 3 + b))
            for b in range(2)] for k in range(2)]
    stack = lambda *xs: jnp.stack(xs)
    return jax.tree_util.tree_map(
        stack, *[jax.tree_util.tree_map(stack, *row) for row in per])


def _t_mlps():
    return {"sense": tnn.init_mlp_qstate(prng.PRNGKey(7)),
            "onehot": tnn.init_mlp_qstate(prng.PRNGKey(5),
                                          tnn.MLPConfig(**ONEHOT))}


def _t_grid():
    """Lane k, network b from ``PRNGKey(3k + b)``, ``(2, 2, ...)`` leaves."""
    keys = prng.PRNGKey(np.array([0, 1, 3, 4]))
    g = tnn.init_mlp_qstate(keys)
    return tnn.MLPQState(*(v.reshape(2, 2, *v.shape[1:]) for v in g[:4]),
                         cfg=g.cfg)


def _t_portfolio(n=2, device="cpu"):
    items = []
    for i, name in enumerate(("SoC6", "SoC2")[:n]):
        soc = TSOCS[name]
        comps = [tvec.compile_app(
            _chain_app(t_make_phase, TApp, soc, 10 + i, n_threads=1), soc,
            seed=TILE_SEED)]
        items.append((tvec.VecEnv(soc, seed=0, device=device), comps))
    return items


def port_results() -> dict:
    """The port's episodes, stacked episodes and portfolio on the inputs
    of :func:`reference_tables`."""
    out = {}
    soc = TSOCS["SoC1"]
    env = tvec.VecEnv(soc, seed=0, device="cpu")
    app = tvec.compile_app(_chain_app(t_make_phase, TApp, soc, 6), soc,
                           seed=TILE_SEED)
    cfg = tq.QConfig(decay_steps=app.n_steps)
    for name, mlp in _t_mlps().items():
        spec = tvec.mlp_policy_spec(mlp, app.schedule)
        for tag, fs in (("", None), ("storm", tf.storm(
                app.n_steps, 1.0, prng.PRNGKey(42)))):
            out[f"ep{tag}/{name}"] = env.episode_spec(
                app, spec, cfg=cfg, key=prng.PRNGKey(3), faults=fs)
    socs = [TSOCS["SoC6"], TSOCS["SoC2"]]
    senv = tstk.StackedVecEnv(socs, seed=0, device="cpu")
    st = senv.compile([_chain_app(t_make_phase, TApp, s, i, n_threads=1)
                       for i, s in enumerate(socs)])
    out["stk"] = senv.episodes(st, senv.lower_mlps(st, _t_grid()),
                               tq.QConfig())
    out["tp"] = tnn.train_portfolio(
        _t_portfolio(), tq.QConfig(decay_steps=2048), key=prng.PRNGKey(1),
        **TP)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port results, reference without FMA, the reference's initial
    weights as jitted here)."""
    here = {}
    for name, mlp in _j_mlps().items():
        _flat(f"init/{name}", mlp, here)
    port, nofma = reference_without_fma(
        "test_torch_nn", "reference_tables",
        tmp_path_factory.mktemp("nofma"), meanwhile=port_results)
    return port, nofma, here


def _assert_tree(port, ref: dict, name):
    for f in port._fields:
        if f == "cfg":
            continue
        b = ref[f]
        a = getattr(port, f).cpu().numpy().reshape(b.shape)
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, err_msg=f"{name}.{f}", **TOL)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{name}.{f}")


# ------------------------------------------------------------------ units
def test_pack_shape_and_forward_match_reference():
    cfg = tnn.MLPConfig()
    dims = tnn.mlp_dims(cfg)
    assert dims == (tnn.N_SENSE_FEATURES, 16, 16, 4) == jnn.mlp_dims(
        jnn.MLPConfig())
    assert tnn.pack_shape(dims) == jnn.pack_shape(dims) == (49, 16)
    assert tnn.pack_shape(tnn.mlp_dims(tnn.MLPConfig(**ONEHOT))) == (
        jnn.pack_shape(jnn.mlp_dims(jnn.MLPConfig(**ONEHOT))))
    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 49, 16)).astype(np.float32)
    x = rng.uniform(0, 1, size=(3, 14)).astype(np.float32)
    want = np.stack([np.asarray(jnn.forward_packed(
        jnp.asarray(w[i]), jnp.asarray(x[i]), dims)) for i in range(3)])
    got = tnn.forward_packed(torch.from_numpy(w), torch.from_numpy(x), dims)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_fresh_network_is_all_tie_and_placeholder_deterministic():
    for mlp in (tnn.init_mlp_qstate(prng.PRNGKey(3)),
                tnn.frozen_mlp_qstate()):
        dims = tnn.mlp_dims(mlp.cfg)
        for t in np.linspace(0.0, 1.0, 5):
            x = torch.full((1, dims[0]), float(np.float32(t)))
            row = tnn.forward_packed(mlp.wpack, x, dims)
            assert torch.equal(row, torch.ones((1, 4)))
    a, b = tnn.frozen_mlp_qstate(), tnn.frozen_mlp_qstate()
    assert torch.equal(a.wpack, b.wpack)
    jph = jnn.frozen_mlp_qstate()
    assert np.array_equal(a.wpack[0].numpy(), np.asarray(jph.wpack))
    assert bool(a.frozen[0]) and float(a.lr[0]) == 0.0


def test_init_matches_reference(runs):
    """The port's own He-scaled init: bitwise the no-FMA reference's,
    within 2e-5 of the FMA build's (whose erf_inv polynomial is
    contracted)."""
    _, nofma, here = runs
    for name, got in _t_mlps().items():
        want = _sub(nofma, f"init/{name}")
        carried = tnn.mlp_from_numpy(want["wpack"], want["lr"],
                                     want["step"], want["frozen"], got.cfg)
        for a, b in zip(got[:4], carried[:4]):
            assert a.numpy().tobytes() == b.numpy().tobytes(), name
        np.testing.assert_allclose(got.wpack[0].numpy(),
                                   here[f"init/{name}/wpack"], **TOL)
        assert float(got.lr[0]) == float(want["lr"])
        assert int(got.step[0]) == 0 and not bool(got.frozen[0])


def test_td_update_matches_reference_and_gates_are_noops():
    dims = tnn.mlp_dims(tnn.MLPConfig())
    jm = jnn.init_mlp_qstate(jax.random.PRNGKey(1))
    wp = torch.from_numpy(np.array(jm.wpack))[None]
    x = np.linspace(0.1, 0.9, dims[0]).astype(np.float32)
    tx = torch.from_numpy(x)[None]
    act, one = torch.tensor([2]), torch.tensor([True])
    jw, tw = jm.wpack, wp
    for _ in range(5):
        jw = jnn.td_update_packed(jw, jnp.asarray(x), jnp.int32(2),
                                  jnp.float32(0.25), jnp.float32(0.05), dims,
                                  jnp.asarray(True))
        tw = tnn.td_update_packed(tw, tx, act, torch.tensor([0.25]),
                                  torch.tensor([0.05]), dims, one)
    np.testing.assert_allclose(tw[0].numpy(), np.asarray(jw), **TOL)
    q0 = float(tnn.forward_packed(wp, tx, dims)[0, 2])
    q5 = float(tnn.forward_packed(tw, tx, dims)[0, 2])
    assert abs(q5 - 0.25) < abs(q0 - 0.25)
    for lr, gate, r in ((0.05, False, 0.25), (0.0, True, 0.25),
                        (0.05, True, float("nan"))):
        out = tnn.td_update_packed(wp, tx, act, torch.tensor([r]),
                                   torch.tensor([lr]), dims,
                                   torch.tensor([gate]))
        assert out.numpy().tobytes() == wp.numpy().tobytes()


def test_onehot_distillation_reproduces_table_rows():
    rng = np.random.default_rng(0)
    qtable = torch.from_numpy(rng.normal(size=(243, 4)).astype(np.float32))
    mlp = tnn.mlp_from_qtable(qtable)
    dims = tnn.mlp_dims(mlp.cfg)
    assert dims == (243, 4) and mlp.wpack.shape == (1, 244, 4)
    s = torch.tensor([0, 7, 100, 242])
    x = tnn.step_features("onehot", None, s, footprint=None, tiles=None,
                          omask=None, omodes=None, ofps=None, odram=None,
                          warm_t=None, profile=None, slack=0.0, reuse=0.0)
    row = tnn.forward_packed(mlp.wpack.expand(4, -1, -1), x, dims)
    assert torch.equal(row, qtable[s])


def test_step_features_match_reference():
    """Both embeddings on random slot reads of SoC1 (``log2`` through
    XLA's log); the sense features within 2e-5 of the FMA build."""
    from repro.soc.memsys import SoCStatic as JStatic
    from repro_torch.soc.memsys import SoCStatic as TStatic, static_tensors
    rng = np.random.default_rng(4)
    b, n_t, n_tiles = 6, 5, 4
    fp = rng.choice([3e3, 5e4, 2e6, 9e6], b).astype(np.float32)
    tiles = rng.random((b, n_tiles)) < 0.6
    omask = rng.random((b, n_t)) < 0.7
    omodes = np.where(omask, rng.integers(0, 4, (b, n_t)), -1).astype(
        np.float32)
    ofps = np.where(omask, rng.uniform(0, 4e6, (b, n_t)), 0).astype(
        np.float32)
    odram = np.where(omask, rng.uniform(0, 8, (b, n_t)), 0).astype(np.float32)
    warm = rng.uniform(0, 1, b).astype(np.float32)
    prof = rng.uniform(0, 3, (b, 9)).astype(np.float32)
    prof[:, 0] = rng.integers(0, 3, b)
    sidx = rng.integers(0, 243, b)
    js = JStatic.from_config(JSOCS["SoC1"])
    ts = static_tensors(TStatic.from_config(TSOCS["SoC1"]), b)
    for feats in ("sense", "onehot"):
        got = tnn.step_features(
            feats, ts, torch.from_numpy(sidx), footprint=torch.from_numpy(fp),
            tiles=torch.from_numpy(tiles), omask=torch.from_numpy(omask),
            omodes=torch.from_numpy(omodes), ofps=torch.from_numpy(ofps),
            odram=torch.from_numpy(odram), warm_t=torch.from_numpy(warm),
            profile=torch.from_numpy(prof), slack=0.0, reuse=0.0)
        for i in range(b):
            want = jnn.step_features(
                feats, js, jnp.int32(sidx[i]), footprint=jnp.asarray(fp[i]),
                tiles=jnp.asarray(tiles[i]), omask=jnp.asarray(omask[i]),
                omodes=jnp.asarray(omodes[i]), ofps=jnp.asarray(ofps[i]),
                odram=jnp.asarray(odram[i]), warm_t=jnp.asarray(warm[i]),
                profile=jnp.asarray(prof[i]), slack=jnp.float32(0.0),
                reuse=jnp.float32(0.0))
            np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                       err_msg=feats, **TOL)


# ------------------------------------------------------------- episodes
@pytest.mark.parametrize("tag", ["", "storm"])
@pytest.mark.parametrize("name", ["sense", "onehot"])
def test_mlp_episode_matches_reference(runs, name, tag):
    """One learning MLP episode (``episode_ref``'s MLP branch; with
    ``tag='storm'`` MLP and fault columns together): traces, the untouched
    placeholder table and the trained pack against the no-FMA build."""
    port, nofma, _ = runs
    (qs, mlp), res = port[f"ep{tag}/{name}"]
    pre = f"ep{tag}/{name}"
    _assert_tree(res, _sub(nofma, f"{pre}/res"), f"{pre}.res")
    _assert_tree(qs, _sub(nofma, f"{pre}/qs"), f"{pre}.qs")
    _assert_tree(mlp, _sub(nofma, f"{pre}/mlp"), f"{pre}.mlp")
    assert torch.equal(qs.qtable, torch.ones_like(qs.qtable))
    assert int(mlp.step[0]) == res.mode.shape[0]
    assert not torch.equal(mlp.wpack, _t_mlps()[name].wpack)


def test_stacked_lower_mlps_matches_reference(runs):
    port, nofma, _ = runs
    res = port["stk"]
    assert res.mode.shape[:2] == (2, 2)
    _assert_tree(res, _sub(nofma, "stk"), "stk")


def test_lower_mlps_grid_shapes():
    socs = [TSOCS["SoC6"], TSOCS["SoC2"]]
    senv = tstk.StackedVecEnv(socs, seed=0, device="cpu")
    st = senv.compile([_chain_app(t_make_phase, TApp, s, i, n_threads=1)
                       for i, s in enumerate(socs)])
    keys = prng.PRNGKey(np.arange(6)).reshape(2, 3, 2)
    grid = tnn.init_mlp_qstate(keys.reshape(6, 2))
    grid = tnn.MLPQState(*(v.reshape(2, 3, *v.shape[1:]) for v in grid[:4]),
                         cfg=grid.cfg)
    specs = senv.lower_mlps(st, grid)
    assert specs.mlp.wpack.shape[:2] == (2, 3)
    assert bool(specs.qfun.all()) and bool(specs.mlp.frozen.all())
    assert not bool(specs.learned.any())
    assert specs.qstate.qtable.shape == (2, 3, 243, 4)


# ------------------------------------------------ spec-lowering contracts
@pytest.fixture(scope="module")
def iso():
    soc = T_ISO
    env = tvec.VecEnv(soc, seed=0, device="cpu")
    app = tvec.compile_app(_chain_app(t_make_phase, TApp, soc, 3,
                                      n_threads=1), soc, seed=TILE_SEED)
    return env, app


def test_placeholder_mlp_attach_is_bitwise_noop(iso):
    env, app = iso
    key = prng.PRNGKey(4)
    for pol in (TQPolicy(tq.QConfig()), TManual()):
        spec = pol.lower(env, app)
        qs0, res0 = env.episode_spec(app, spec, key=key)
        (qs1, mlp1), res1 = env.episode_spec(
            app, tvec.attach_placeholder_mlp(spec), key=key)
        for a, b in zip((*qs0, *res0), (*qs1, *res1)):
            assert a.numpy().tobytes() == b.numpy().tobytes(), pol.name
        ph = tnn.frozen_mlp_qstate()
        assert torch.equal(mlp1.wpack, ph.wpack)
        assert int(mlp1.step[0]) == 0


def test_placeholder_batches_with_mlp_specs(iso):
    """A table spec given the placeholder stacks with an MLP spec; each
    row of the batch equals its spec run alone."""
    env, app = iso
    cfg = tq.QConfig(decay_steps=app.n_steps)
    sched = app.schedule
    table = tvec.attach_placeholder_mlp(
        tvec.learned_policy_spec(tq.init_qstate(cfg), sched))
    mlp = tvec.mlp_policy_spec(tnn.init_mlp_qstate(prng.PRNGKey(2)), sched)
    keys = prng.PRNGKey(np.array([5, 6]))
    batch = env.episodes(app, tvec.stack_specs([table, mlp]), cfg,
                         keys=keys)
    for i, spec in enumerate((table, mlp)):
        _, solo = env.episode_spec(app, spec, cfg=cfg, key=keys[i])
        for a, b in zip(batch.index(i), solo):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="placeholder"):
        tvec.stack_specs([tvec.learned_policy_spec(tq.init_qstate(cfg),
                                                   sched), mlp])


def test_distilled_mlp_selects_identical_modes(iso):
    """``mlp_from_qtable`` of a trained, frozen table selects exactly the
    table spec's modes (and states) on the same key."""
    env, app = iso
    cfg = tq.QConfig(decay_steps=app.n_steps)
    qs, _ = env.episode(app, policy="q", cfg=cfg, key=prng.PRNGKey(2))
    qs = tq.freeze(qs)
    key = prng.PRNGKey(9)
    _, res_t = env.episode_spec(app, tvec.learned_policy_spec(
        qs, app.schedule), cfg=cfg, key=key)
    mspec = tvec.mlp_policy_spec(tnn.freeze(tnn.mlp_from_qtable(
        qs.qtable[0])), app.schedule)
    (_, _), res_m = env.episode_spec(app, mspec, cfg=cfg, key=key)
    assert torch.equal(res_t.mode, res_m.mode)
    assert torch.equal(res_t.state_idx, res_m.state_idx)
    assert len(set(res_t.mode.tolist())) > 1


def test_non_finite_weights_degrade_to_non_coh(iso):
    env, app = iso
    mlp = tnn.init_mlp_qstate(prng.PRNGKey(7))
    wp = mlp.wpack.clone()
    wp[0, 0, 0] = float("nan")
    bad = tnn.freeze(mlp._replace(wpack=wp))
    (_, _), res = env.episode_spec(app, tvec.mlp_policy_spec(
        bad, app.schedule), key=prng.PRNGKey(0))
    assert bool((res.mode == 0).all())


def test_mlp_serving_is_not_ported(iso):
    """(Named before MLP serving was ported; its agreement with the
    reference is in ``tests/test_torch_serve_mlp.py``.)  A network serves
    a short stream: the pack rides the carry, the placeholder Q-state
    stays frozen and untouched, and the served network is the spec's."""
    env, app = iso
    mlp = tnn.init_mlp_qstate(prng.PRNGKey(1))
    spec = tvec.mlp_policy_spec(mlp, app.schedule)
    from repro_torch.soc import traffic as ttraffic
    senv = tvec.ServeEnv(env, n_requests=4)
    carry, qs, res = senv.serve(app, spec, ttraffic.poisson(1e-5))
    assert carry.wpack.shape == mlp.wpack.shape
    assert bool(torch.isfinite(carry.wpack).all())
    assert bool(qs.frozen.all()) and int(qs.visits.sum()) == 0
    assert torch.equal(qs.qtable, spec.qstate.qtable)
    assert res.executed.shape == (4,)
    fresh = senv.init_carry(spec.qstate, spec.mlp, spec.qfun)
    assert torch.equal(fresh.wpack, mlp.wpack)


# ------------------------------------------------------ portfolio training
def test_train_portfolio_matches_reference(runs):
    port, nofma, _ = runs
    mlp, hist = port["tp"]
    _assert_tree(mlp, _sub(nofma, "tp"), "train_portfolio")
    np.testing.assert_allclose(hist.numpy(), nofma["tp/hist"], **TOL)
    assert int(mlp.step[0]) > 0 and bool(torch.isfinite(mlp.wpack).all())


@pytest.mark.parametrize("n", [5, 32, 33, 54, 432, 1025, 5000])
def test_xla_sum_is_the_reference_row_sum(n):
    """``ordered.xla_sum`` rounds a long row sum as the reference's jitted
    ``jnp.sum`` does on the CPU (the per-episode mean reward of
    ``train_portfolio``), bitwise."""
    from repro_torch.ordered import xla_sum
    x = (np.random.default_rng(n).standard_normal((3, n))
         * 10.0 ** np.arange(-1, 2)[:, None]).astype(np.float32)
    want = np.asarray(jax.jit(lambda r: jnp.sum(r, axis=-1))(x))
    got = xla_sum(torch.from_numpy(x)).numpy()
    assert got.tobytes() == want.tobytes()


class _Crash(Exception):
    pass


class _Killer:
    """A checkpoint manager that dies before its ``die_after + 1``-th
    save."""

    def __init__(self, inner, die_after: int):
        self._inner, self._left = inner, die_after

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def save(self, step, tree):
        if self._left <= 0:
            raise _Crash(f"simulated crash before checkpoint {step}")
        self._left -= 1
        self._inner.save(step, tree)
        self._inner.wait()


def test_train_portfolio_resume_is_bitwise(tmp_path):
    kw = dict(iterations=3, batch=2, key=prng.PRNGKey(4))
    cfg = tq.QConfig(decay_steps=2048)
    whole = tnn.train_portfolio(_t_portfolio(1), cfg, **kw)
    with pytest.raises(_Crash):
        tnn.train_portfolio(_t_portfolio(1), cfg, manager=_Killer(
            CheckpointManager(str(tmp_path)), 1), **kw)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 1
    resumed = tnn.train_portfolio(_t_portfolio(1), cfg, manager=mgr, **kw)
    for a, b in zip((*whole[0][:4], whole[1]), (*resumed[0][:4], resumed[1])):
        assert a.numpy().tobytes() == b.numpy().tobytes()
    assert resumed[0].cfg == whole[0].cfg


# -------------------------------------------------------------- sampler
def test_sample_socs_equal_reference():
    import dataclasses
    got, want = tdse.sample_socs(0, 14), jdse.sample_socs(0, 14)
    assert len(got) == len(want) == 14
    for g, w in zip(got, want):
        assert dataclasses.asdict(g.config) == dataclasses.asdict(w.config)
        assert g.seed == w.seed and g.axes == w.axes
    assert tdse.config_seed(3, 5) == jdse.config_seed(3, 5)
    from repro.soc import config as jc
    from repro_torch.soc import config as tc
    for g, w in zip(got[:3], want[:3]):
        assert tc.budget_report(g.config) == jc.budget_report(w.config)
