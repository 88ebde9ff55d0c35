"""The Hopper episode kernel's premises and plan, on the CPU.

* The four coherence modes timed at once: on the plain version's step
  inputs at Fig. 6's shape (SOC_MOTIV_PAR, a short S), healthy and under
  the severe fault storm, with and without ``ddr`` and ``gated``, the
  timing (``memsys.invocation_perf_cached``), the DDR attribution and
  ``rewards.evaluate`` run at each of modes 0-3 on the state before a
  step and indexed by the mode the step chose equal the step's
  ``exec_time``, ``offchip``, reward, extrema and slot demands bitwise.
  The kernel computes the four candidates before the selection and picks
  one, so this is what makes the pick exact.
* ``kernel.plan``: one warp a block, the ring depth and the shared memory
  over T x n_tiles, with and without the largest MLP the repo builds,
  against the layout counted here independently; an MLP too large for
  shared memory raises.
* ``kernel.chain_ops``: the dependent chain the source note prices.
* ``coverage.coverage_case``: the synthetic inputs the card tests and
  ``chip_smoke.py`` hold the kernel to; the plain path runs them and the
  CPU dispatch of ``ops.fused_episode`` equals ``ref.episode_ref`` on
  them.
"""
import itertools

import numpy as np
import pytest
import torch

from repro_torch import random as prng
from repro_torch.core import qlearn, rewards
from repro_torch.kernels.soc_step import coverage, kernel, ops, ref
from repro_torch.ordered import seqsum
from repro_torch.soc import apps, faults, nn as socnn, vecenv
from repro_torch.soc.config import SOC_MOTIV_PAR
from repro_torch.soc.faults import StepFault
from repro_torch.soc.memsys import invocation_perf_cached, static_tensors

GRID_T = (1, 7, 16, 31, 32, 33, 64)
GRID_TILES = (1, 2, 4, 16)
# the largest network the repo configures: the one-hot embedding with the
# default hidden widths
LARGEST_MLP = (243, 16, 16, 4)
N_STEPS = 40


def _fig6_inputs(gated, faulted, b=4):
    """The first steps of a Fig. 6 training episode: SOC_MOTIV_PAR, the
    540-step app of seed 11, ``b`` learning agents."""
    soc = SOC_MOTIV_PAR
    env = vecenv.VecEnv(soc, device="cpu")
    compiled = vecenv.compile_app(
        apps.make_application(soc, seed=11, n_phases=6), soc, seed=11)
    sched = compiled.schedule
    cfg = qlearn.QConfig(decay_steps=compiled.n_steps)
    spec = vecenv.learned_policy_spec(
        qlearn.init_qstate_batch(cfg, b, "cpu"), sched)
    keys = prng.PRNGKey(np.arange(b), device="cpu")
    fs = (faults.storm(compiled.n_steps, 1.0, prng.PRNGKey(42, device="cpu"),
                       device="cpu") if faulted else None)
    xs, _ = vecenv.episode_inputs(env.params, sched, spec, cfg, keys,
                                  gated=gated, faults=fs)
    xs = ref.StepInputs(*(None if v is None else v[:, :N_STEPS]
                          for v in xs))
    w = rewards.stack_weights([(0.675, 0.075, 0.25), (0.125, 0.125, 0.75),
                               (0.05, 0.05, 0.9), (0.33, 0.33, 0.34)][:b],
                              device="cpu")
    return env, spec, xs, w


def _ddr_offchip(x, s, otiles, ofpt, odram, offchip, exec_time):
    """ref.fused_step's DDR attribution for one mode's measurement."""
    myt = x.tiles.to(torch.float32)
    n_my = torch.clamp(seqsum(myt, -1), min=1.0)
    o_nt = torch.clamp(seqsum(otiles, -1), min=1.0)
    my_fp_t = (x.footprint / n_my)[:, None] * myt
    o_fp_t = seqsum(ofpt[..., None] * otiles, -2)
    share = my_fp_t / torch.clamp(my_fp_t + o_fp_t, min=1e-9)
    my_bpt = (offchip * s.line / n_my)[:, None] * myt
    o_bpt = seqsum(((odram * exec_time[:, None]) / o_nt)[..., None]
                   * otiles, -2)
    return seqsum(share * (my_bpt + o_bpt), -1) / s.line


@pytest.mark.parametrize("ddr,gated,faulted",
                         list(itertools.product((False, True), repeat=3)))
def test_four_mode_speculation_equals_the_step(ddr, gated, faulted):
    env, spec, xs, w = _fig6_inputs(gated, faulted)
    b = xs.acc_id.shape[0]
    st = static_tensors(env.static, b, "cpu")
    geom, warm_cap = ref.derive_geom(st)
    qtable = spec.qstate.qtable.clone()
    rs = rewards.init_reward_state(SOC_MOTIV_PAR.n_accs, (b,), "cpu")
    tbl = ref.init_slot_table(xs.others.shape[-1], xs.tiles.shape[-1], b)
    ar = torch.arange(b)
    modes_seen = set()
    for i in range(N_STEPS):
        x = ref.step_slice(xs, i)
        omask = x.others & (tbl[..., ref.TBL_MODE] >= 0.0)
        otbl = torch.where(omask[..., None], tbl, ref._neutral_row(tbl))
        otiles = otbl[..., ref.N_TBL_COLS:]
        warm_t = torch.where(x.fresh, torch.ones_like(x.footprint),
                             tbl[ar, x.thread.long(), ref.TBL_WARM])
        fault = (StepFault(exec_scale=x.f_exec, ddr_scale=x.f_ddr,
                           llc_extra=x.f_llc, retry_cycles=x.f_retry)
                 if faulted else None)
        cand = []
        for mode in range(4):
            m, aux = invocation_perf_cached(
                torch.full((b,), mode, dtype=torch.int32), x.profile,
                x.footprint, x.tiles, otbl[..., ref.TBL_MODE],
                otbl[..., ref.TBL_DRAM], otbl[..., ref.TBL_LLC],
                otbl[..., ref.TBL_FP], otiles, warm_t, st, fault=fault)
            off = (_ddr_offchip(x, st, otiles, otbl[..., ref.TBL_FPT],
                                otbl[..., ref.TBL_DRAM], m.offchip_accesses,
                                m.exec_time)
                   if ddr else m.offchip_accesses)
            r, rs_m, _ = rewards.evaluate(rs, x.acc_id, rewards.Measurement(
                exec_time=m.exec_time, comm_cycles=m.comm_cycles,
                total_cycles=m.total_cycles, offchip_accesses=off,
                footprint=x.footprint), w)
            cand.append((m.exec_time, m.offchip_accesses, r, rs_m.extrema,
                         aux["demand_dram"], aux["demand_llc"]))
        rs_new, y = ref.fused_step(st, geom, warm_cap, spec.learned, w,
                                   qtable, rs, tbl, x, ddr_attribution=ddr,
                                   gated=gated)
        mode = y[:, 0].long()
        modes_seen.update(mode.tolist())
        pick = [torch.stack(c)[mode, ar] for c in zip(*cand)]
        for got, want in zip((y[:, 3], y[:, 4], y[:, 5]), pick[:3]):
            assert torch.equal(got, want)
        keep = (~x.valid if gated else torch.zeros_like(x.valid))
        want_ex = torch.where(keep[:, None, None], rs.extrema, pick[3])
        assert torch.equal(rs_new.extrema, want_ex)
        slot = tbl[ar, x.thread.long()]
        written = ~keep
        assert torch.equal(slot[written, ref.TBL_DRAM], pick[4][written])
        assert torch.equal(slot[written, ref.TBL_LLC], pick[5][written])
        rs = rs_new
    assert len(modes_seen) >= 2


def _words(T, n_tiles, n_feat, A, n_states, n_accs, ring, faulted,
           mlp_dims):
    """The episode kernel's shared-memory words, counted from its layout:
    Q-table, extrema, slot table, consts; the two-chunk ring of xf and xi
    rows and one chunk of y rows; the per-slot terms (rows padded to
    whole warps, plus one word) of the float sums (the tile products, four loads, five
    MLP sense sums), the two integer counts per tile and the four modes'
    DDR terms per tile, with their results; the weight pack, the layer
    outputs and two gradient rows."""
    nf = 4 + n_tiles + T + n_feat + 3 * A + (4 if faulted else 0)
    n_sums = n_tiles + 4 + (5 if mlp_dims else 0)
    padded = (32 if T <= 32 else 64) + 1
    words = (n_states * A + 4 * n_accs + T * (6 + n_tiles)
             + ref.N_CONSTS + (2 if mlp_dims else 0)
             + 2 * ring * nf + 2 * ring * 5 + 6 * ring
             + (n_sums + 2 * n_tiles + 4 * n_tiles) * (padded + 1))
    if mlp_dims:
        rows, cols = socnn.pack_shape(mlp_dims)
        words += rows * cols + sum(mlp_dims) + 2 * 243
    return words


@pytest.mark.parametrize("mlp_dims", [None, LARGEST_MLP])
@pytest.mark.parametrize("n_tiles", GRID_TILES)
@pytest.mark.parametrize("T", GRID_T)
def test_plan_over_the_grid(T, n_tiles, mlp_dims):
    for S, faulted in ((540, True), (638, False), (37, False), (1, True)):
        p = kernel.plan(T, n_tiles, 9, 4, 243, 12, S, faulted=faulted,
                        mlp_dims=mlp_dims)
        assert p.threads == 32
        assert p.ring == min(32, S)
        assert p.smem_bytes == 4 * _words(T, n_tiles, 9, 4, 243, 12, p.ring,
                                          faulted, mlp_dims)
        assert p.smem_bytes <= kernel.SMEM_LIMIT


def test_plan_shrinks_the_ring_then_refuses():
    # a network whose pack nearly fills shared memory leaves room for a
    # shorter ring only; a larger one does not fit at all
    roomy = kernel.plan(64, 16, 9, 4, 243, 12, 540,
                        mlp_dims=(243, 120, 4))
    assert 1 <= roomy.ring < 32
    assert roomy.smem_bytes <= kernel.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        kernel.plan(64, 16, 9, 4, 243, 12, 540, mlp_dims=(243, 243, 4))
    with pytest.raises(ValueError, match="limits"):
        kernel.plan(65, 2, 9, 4, 243, 12, 540)


def test_chain_ops_follow_the_shapes():
    base = kernel.chain_ops(12, 2, 4)
    assert base["add"] == (2 - 1) + (12 - 1) + 8 + 3 + 1
    assert base["div"] == 6 and base["sync"] == 3 and base["shfl"] == 1
    longer = kernel.chain_ops(64, 2, 4)
    assert longer["add"] - base["add"] == 64 - 12
    ddr = kernel.chain_ops(12, 2, 4, ddr=True)
    assert ddr["div"] == base["div"] + 2 and ddr["sync"] == base["sync"] + 2
    mlp = kernel.chain_ops(12, 2, 4, mlp_dims=(14, 16, 16, 4))
    assert mlp["log"] == 1
    # K2m's network warp: one log on either loop, the TD update's
    # __syncwarps on the network warp's only
    for na, nt in ((7, 4), (12, 2)):
        k2m = kernel.serve_chain_ops(na, nt, 4, mlp_dims=(14, 16, 16, 4))
        assert k2m["log"] == 1
        # the one-warp body's count: the step, network included, after the
        # admission, every piece in a row
        one_warp = kernel.chain_cycles(na, nt, 4, mlp_dims=(
            14, 16, 16, 4)) + sum(n * kernel.LATENCY[k]
                                  for k, n in kernel.ADMISSION.items())
        assert kernel.serve_chain_cycles(na, nt, 4, mlp_dims=(
            14, 16, 16, 4)) < one_warp
    assert kernel.chain_cycles(12, 2, 4, mlp_dims=(14, 16, 16, 4)) > (
        kernel.chain_cycles(12, 2, 4))
    # the count prices each kind at its measured latency
    assert kernel.chain_cycles(12, 2, 4) == pytest.approx(sum(
        n * kernel.LATENCY[k] for k, n in base.items()))


@pytest.mark.parametrize("T,n_tiles", [(1, 1), (33, 16), (64, 4)])
def test_coverage_case_runs_through_the_plain_path(T, n_tiles):
    for faulted in (False, True):
        c = coverage.coverage_case(T, n_tiles, 9, B=3, seed=T,
                                   faulted=faulted, device="cpu")
        assert c.xs.others.shape == (3, 9, T)
        assert c.xs.tiles.shape == (3, 9, n_tiles)
        assert bool(c.xs.tiles.any(-1).all())
        assert c.xs.faulted == faulted
        q, ys = ref.episode_ref(c.static, c.learned, c.weights, c.qtable0,
                                c.extrema0, c.xs, ddr_attribution=True)
        assert all(bool(torch.isfinite(v.float()).all()) for v in ys)
        ops.reset_launches()
        q2, ys2 = ops.fused_episode(c.static, c.learned, c.weights,
                                    c.qtable0, c.extrema0, c.xs,
                                    ddr_attribution=True)
        assert torch.equal(q, q2)
        assert all(torch.equal(a, b) for a, b in zip(ys, ys2))
        assert ops.launches == ops.fault_launches == 0


def test_coverage_case_is_seeded():
    a = coverage.coverage_case(7, 2, 5, seed=3, device="cpu")
    b = coverage.coverage_case(7, 2, 5, seed=3, device="cpu")
    for u, v in zip(a.xs, b.xs):
        assert u is None or torch.equal(u, v)
    assert torch.equal(a.qtable0, b.qtable0)


def test_qdiv_probe_inputs_cover_both_sides_of_the_range():
    a, b, ok = kernel.qdiv_probe_inputs(4096, seed=2)
    assert a.dtype == b.dtype == np.float32 and ok.dtype == bool
    assert 0.3 < ok.mean() < 0.95
    assert bool(((a == 0) & ok).any()) and bool((np.signbit(a) & (a == 0)
                                                 ).any())
    assert bool((np.abs(b) >= 2.0 ** 60).any())
    assert bool(((np.abs(a) < 2.0 ** -60) & (a != 0)).any())
    with pytest.raises(ValueError, match="CUDA"):
        kernel.qdiv_probe(torch.from_numpy(a), torch.from_numpy(b))


def test_plan_takes_the_four_modes_only():
    with pytest.raises(ValueError, match="4 actions"):
        kernel.plan(12, 2, 9, 3, 243, 12, 540)
