"""repro_torch.soc timing model and application lowering against repro.soc.

``invocation_perf_cached``/``dma_demand``/``warmth_after`` run over random
concurrent sets on two Table-4 SoCs; floats are held to rtol=atol=2e-5
(measured worst relative gap 1.0e-7, one ULP: the reference folds some
all-constant subexpressions in float64 before rounding, the port rounds
each in float32).  With the SoC's constants passed as arrays, as the
stacked environment passes them, and the reference built without fused
multiply-add (``test_torch_serve.reference_without_fma``, ROADMAP C1),
the timing is bitwise equal, on random sets and on the Fig. 9 evaluation
step where the two first parted before the controller bandwidths were
divided as XLA divides them.  Application generation and lowering are
numpy and must be identical.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.soc import accelerators as jacc
from repro.soc import apps as japps
from repro.soc import config as jcfg
from repro.soc import memsys as jmem
from repro.soc import vecenv as jvec
from repro_torch.soc import accelerators as tacc
from repro_torch.soc import apps as tapps
from repro_torch.soc import config as tcfg
from repro_torch.soc import memsys as tmem
from repro_torch.soc import vecenv as tvec

TOL = dict(rtol=2e-5, atol=2e-5)
NOFMA_SOC = "SoC0"
# Fig. 9's evaluation call, lane SoC0-streaming, policy 2 (fixed
# COH_DMA), step 9: the first element where the port (24791.846) and the
# no-FMA reference (24791.848) parted, through ``line / per_line /
# llc_slow``, which XLA compiles as ``line / (per_line * llc_slow)``
FIG9_ROW = dict(
    mode=np.int32(2),
    profile=np.float32([0.0, 1024.0, 0.13474996, 2.9371626, 0.79595017, 0.0,
                        1.0, 1.0, 1.0]),
    fp=np.float32(16366.899),
    my_tiles=np.array([False, False, True, False]),
    omodes=np.int32([2] * 9 + [-1] * 3),
    odram=np.float32([0.2096474, 0.019823655, 0.01417697, 0.05218142,
                      0.029101431, 0.03921915, 0.017038528, 0.082576446,
                      0.037643358, 0.0, 0.0, 0.0]),
    ollc=np.float32([1.4975855, 0.27386227, 0.24294424, 0.7218469,
                     0.37173516, 0.30933666, 0.25231495, 0.7275492,
                     0.47504225, 0.0, 0.0, 0.0]),
    ofps=np.float32([62579.89, 8116.1978, 6393.0156, 3160.1667, 3013.635,
                     62124.168, 15230.732, 45088.223, 2157.883, 0.0, 0.0,
                     0.0]),
    otiles=np.float32([[0, 0, 1, 0], [0, 0, 0, 1], [0, 0, 0, 1],
                       [0, 0, 1, 0], [0, 0, 0, 1], [0, 0, 0, 1],
                       [0, 0, 0, 1], [1, 0, 0, 0], [0, 1, 0, 0],
                       [0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]]),
    warm=np.float32(1.0))


def _t(a):
    return torch.from_numpy(np.array(a))


def _concurrent_sets(rng, b, n_slots, n_tiles, pmat):
    mode = rng.integers(0, 4, b).astype(np.int32)
    prof = pmat[rng.integers(0, len(pmat), b)]
    fp = np.exp(rng.uniform(np.log(1e2), np.log(2e7), b)).astype(np.float32)
    my_tiles = rng.uniform(size=(b, n_tiles)) < 0.6
    my_tiles[:, 0] |= ~my_tiles.any(-1)
    omodes = rng.integers(-1, 4, (b, n_slots)).astype(np.int32)
    oprof = pmat[rng.integers(0, len(pmat), (b, n_slots))]
    ofps = np.exp(rng.uniform(np.log(1e2), np.log(2e7),
                              (b, n_slots))).astype(np.float32)
    otiles = (rng.uniform(size=(b, n_slots, n_tiles)) < 0.5)
    warm = rng.uniform(0, 1, b).astype(np.float32)
    warm[::3] = 1.0
    return mode, prof, fp, my_tiles, omodes, oprof, ofps, otiles, warm


@pytest.mark.parametrize("soc_name", ["SoC3", "SoC-motiv-par"])
def test_invocation_perf_cached_matches(soc_name):
    jsoc, tsoc = jcfg.SOCS[soc_name], tcfg.SOCS[soc_name]
    pmat = jacc.profile_matrix(jacc.resolve_profiles(
        jsoc.accelerators, np.random.default_rng(0)))
    rng = np.random.default_rng(11)
    b = 128
    (mode, prof, fp, my_tiles, omodes, oprof, ofps, otiles,
     warm) = _concurrent_sets(rng, b, 12, jsoc.n_mem_tiles, pmat)
    js_ = jmem.SoCStatic.from_config(jsoc)
    ts_ = tmem.static_tensors(tmem.SoCStatic.from_config(tsoc), b)

    # the concurrent set's cached (dram, llc) demand, both packages
    jd = jax.vmap(jax.vmap(lambda m, p, f: jmem.dma_demand(m, p, f, js_)))(
        omodes, oprof, ofps)
    td = tmem.dma_demand(_t(omodes), _t(oprof), _t(ofps),
                         tmem.static_tensors(tmem.SoCStatic.from_config(tsoc),
                                             1))
    for a, c in zip(td, jd):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), **TOL)
    odram, ollc = (np.asarray(v) for v in jd)
    act = omodes >= 0
    ofps_m = np.where(act, ofps, 0).astype(np.float32)
    otiles_f = np.where(act[..., None], otiles, False).astype(np.float32)

    jm, jaux = jax.vmap(lambda *a: jmem.invocation_perf_cached(*a, js_))(
        mode, prof, fp, my_tiles, omodes, odram, ollc, ofps_m, otiles_f,
        warm)
    tm, taux = tmem.invocation_perf_cached(
        _t(mode), _t(prof), _t(fp), _t(my_tiles), _t(omodes), _t(odram),
        _t(ollc), _t(ofps_m), _t(otiles_f), _t(warm), ts_)
    for name in jm._fields:
        np.testing.assert_allclose(getattr(tm, name).numpy(),
                                   np.asarray(getattr(jm, name)),
                                   err_msg=name, **TOL)
    for k in ("demand_dram", "demand_llc", "overhead", "llc_hit_frac",
              "offchip_bytes"):
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(jaux[k]),
                                   err_msg=k, **TOL)
    cap = float(jsoc.llc_total_bytes + jsoc.n_cpus * jsoc.l2_bytes)
    np.testing.assert_allclose(
        tmem.warmth_after(_t(mode), _t(fp), cap).numpy(),
        np.asarray(jmem.warmth_after(mode, fp, cap)), **TOL)


@pytest.mark.parametrize("soc_name", ["SoC1", "SoC3", "SoC-motiv-par"])
@pytest.mark.parametrize("flavor", ["mixed", "irregular"])
def test_profiles_identical(soc_name, flavor):
    names = jcfg.SOCS[soc_name].accelerators
    jp = jacc.profile_matrix(jacc.resolve_profiles(
        names, np.random.default_rng(4), flavor))
    tp = tacc.profile_matrix(tacc.resolve_profiles(
        names, np.random.default_rng(4), flavor))
    assert jp.tobytes() == tp.tobytes()


@pytest.mark.parametrize("soc_name,seed,n_phases",
                         [("SoC-motiv-par", 11, 6), ("SoC3", 3, 4)])
def test_make_application_and_compile_app_identical(soc_name, seed,
                                                    n_phases):
    jsoc, tsoc = jcfg.SOCS[soc_name], tcfg.SOCS[soc_name]
    ja = japps.make_application(jsoc, seed=seed, n_phases=n_phases)
    ta = tapps.make_application(tsoc, seed=seed, n_phases=n_phases)
    assert [p.name for p in ja.phases] == [p.name for p in ta.phases]
    for jp, tp in zip(ja.phases, ta.phases):
        assert [(t.loops, [(i.acc_id, i.footprint) for i in t.chain])
                for t in jp.threads] == [
            (t.loops, [(i.acc_id, i.footprint) for i in t.chain])
            for t in tp.threads]
    for tile_seed in (seed, 77):
        jc = jvec.compile_app(ja, jsoc, seed=tile_seed)
        tc = tvec.compile_app(ta, tsoc, seed=tile_seed)
        assert (jc.n_phases, jc.n_threads, jc.n_steps) == (
            tc.n_phases, tc.n_threads, tc.n_steps)
        for name in jvec.Schedule._fields:
            a = np.asarray(getattr(jc.schedule, name))
            c = getattr(tc.schedule, name).numpy()
            assert a.dtype == c.dtype and a.tobytes() == c.tobytes(), name
    jc = [jvec.compile_app(ja, jsoc, seed=seed + i) for i in range(3)]
    tc = [tvec.compile_app(ta, tsoc, seed=seed + i) for i in range(3)]
    js_, ts_ = jvec.stack_schedules(jc), tvec.stack_schedules(tc)
    for name in jvec.Schedule._fields:
        assert (np.asarray(getattr(js_, name)).tobytes()
                == getattr(ts_, name).numpy().tobytes()), name


def _nofma_inputs(b=512):
    """Random concurrent sets on :data:`NOFMA_SOC` (cached demands drawn
    directly), with :data:`FIG9_ROW` as row 0."""
    soc = jcfg.SOCS[NOFMA_SOC]
    pmat = jacc.profile_matrix(jacc.resolve_profiles(
        soc.accelerators, np.random.default_rng(0)))
    rng = np.random.default_rng(17)
    (mode, prof, fp, my_tiles, omodes, _, ofps, otiles,
     warm) = _concurrent_sets(rng, b, 12, soc.n_mem_tiles, pmat)
    odram = rng.uniform(0, 0.5, omodes.shape).astype(np.float32)
    ollc = rng.uniform(0, 2, omodes.shape).astype(np.float32)
    act = omodes >= 0
    arrs = dict(mode=mode, profile=prof, fp=fp, my_tiles=my_tiles,
                omodes=omodes, odram=odram, ollc=ollc,
                ofps=np.where(act, ofps, 0).astype(np.float32),
                otiles=np.where(act[..., None], otiles, False)
                .astype(np.float32), warm=warm)
    for k, v in FIG9_ROW.items():
        arrs[k][0] = v
    return arrs


def reference_perf() -> dict:
    """The reference's timing on :func:`_nofma_inputs`, jitted with the
    SoC's constants as per-row arrays (as ``StackedVecEnv`` passes them);
    run in a process without FMA by the test below."""
    a = _nofma_inputs()
    b = len(a["mode"])
    s = jax.tree_util.tree_map(lambda v: jnp.full((b,), v, jnp.float32),
                               jmem.SoCStatic.from_config(
                                   jcfg.SOCS[NOFMA_SOC]))
    m, _ = jax.jit(jax.vmap(jmem.invocation_perf_cached))(
        a["mode"], a["profile"], a["fp"], a["my_tiles"], a["omodes"],
        a["odram"], a["ollc"], a["ofps"], a["otiles"], a["warm"], s)
    return {f: np.asarray(getattr(m, f)) for f in m._fields}


def test_invocation_perf_bitwise_without_fma(tmp_path):
    """``exec_time`` and the other timing outputs equal the no-FMA
    reference's bit for bit, Fig. 9's first divergent step included."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from test_torch_serve import reference_without_fma
    _, want = reference_without_fma("test_torch_memsys", "reference_perf",
                                    tmp_path)
    a = _nofma_inputs()
    tm, _ = tmem.invocation_perf_cached(
        *(_t(a[k]) for k in ("mode", "profile", "fp", "my_tiles", "omodes",
                             "odram", "ollc", "ofps", "otiles", "warm")),
        tmem.static_tensors(tmem.SoCStatic.from_config(
            tcfg.SOCS[NOFMA_SOC]), len(a["mode"])))
    assert np.float32(want["exec_time"][0]) == np.float32(24791.848)
    for f in tm._fields:
        np.testing.assert_array_equal(getattr(tm, f).numpy(), want[f],
                                      err_msg=f)
