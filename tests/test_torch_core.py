"""repro_torch.core against repro.core on the same numpy inputs.

Integer outputs (state indices, actions, visits, steps) must match
exactly.  Float outputs are held to rtol=atol=2e-5 (the kernel tests'
bound); measured gap on these cases: 0 (bitwise) for rewards,
row_update and decay_arrays.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qlearn as jq
from repro.core import rewards as jr
from repro.core import state as js
from repro_torch.core import qlearn as tq
from repro_torch.core import rewards as tr
from repro_torch.core import state as ts
from repro_torch.soc import config as tcfg
from repro.soc import config as jcfg

TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _slot_tables(rng, b, n_slots, n_tiles, geom, halves=False):
    modes = rng.integers(-1, 4, (b, n_slots)).astype(np.float32)
    fps = np.exp(rng.uniform(np.log(1e3), np.log(8e6),
                             (b, n_slots))).astype(np.float32)
    fps = np.where(modes >= 0, fps, 0.0).astype(np.float32)
    tiles = rng.uniform(size=(b, n_slots, n_tiles)) < 0.5
    tiles = np.where(modes[..., None] >= 0, tiles, False)
    target = rng.uniform(size=(b, n_tiles)) < 0.5
    target[::5] = False                    # empty target-tile masks
    if halves:
        # counts whose per-tile average is exactly k + 0.5 (round-half-even)
        target[:, :] = False
        target[:, :2] = True
        tiles[:, :, :] = False
        modes[:, :] = -1
        modes[:, 0] = 0
        tiles[:, 0, 0] = True
        modes[1::2, 1] = 0
        tiles[1::2, 1, :2] = True
        modes[1::2, 2] = 0
        tiles[1::2, 2, 0] = True
    fpt = np.where(modes >= 0, fps / np.maximum(tiles.sum(-1), 1),
                   0.0).astype(np.float32)
    tfp = np.exp(rng.uniform(np.log(1e3), np.log(8e6), (b,)))
    tfp = tfp.astype(np.float32)
    tfp[:3] = [geom.l2_bytes, geom.llc_slice_bytes,
               np.nextafter(np.float32(geom.l2_bytes), np.float32(1e12))]
    return modes, fps, tiles, target, tfp, fpt


@pytest.mark.parametrize("soc_name", ["SoC0", "SoC-motiv-par"])
@pytest.mark.parametrize("halves", [False, True])
def test_observe_matches(soc_name, halves):
    geom = jcfg.SOCS[soc_name].geometry
    rng = np.random.default_rng(7)
    modes, fps, tiles, target, tfp, fpt = _slot_tables(
        rng, 64, 12, geom.n_mem_tiles, geom, halves)
    for use_fpt in (False, True):
        jf = jax.vmap(lambda m, f, t, g, p, q: js.observe(
            active_modes=m.astype(jnp.int32), active_footprints=f,
            needed_tiles=t, target_tiles=g, target_footprint=p, geom=geom,
            active_fp_per_tile=q if use_fpt else None))
        want = np.asarray(jf(modes, fps, tiles, target, tfp, fpt))
        got = ts.observe(
            active_modes=_t(modes), active_footprints=_t(fps),
            needed_tiles=_t(tiles), target_tiles=_t(target),
            target_footprint=_t(tfp), geom=tcfg.SOCS[soc_name].geometry,
            active_fp_per_tile=_t(fpt) if use_fpt else None)
        np.testing.assert_array_equal(got.numpy(), want)
    if halves:
        # 1.5 rounds to 2 and 0.5 to 0 (half to even) in both packages
        attrs = [ts.decode_state(int(i)) for i in got[:2]]
        assert attrs[0][1] == 0 and attrs[1][1] == 2


def test_encode_decode_roundtrip():
    for idx in range(ts.N_STATES):
        a = torch.tensor(ts.decode_state(idx))
        assert int(ts.encode_attrs(a)) == idx
        assert ts.decode_state(idx) == js.decode_state(idx)


def test_reward_evaluate_matches():
    rng = np.random.default_rng(1)
    b, n_accs, steps = 8, 5, 12
    w = np.stack([rng.uniform(0, 1, b) for _ in range(3)]).astype(np.float32)
    jrs = jax.vmap(lambda _: jr.init_reward_state(n_accs))(jnp.arange(b))
    trs = tr.init_reward_state(n_accs, (b,))
    np.testing.assert_array_equal(np.asarray(jrs.extrema),
                                  trs.extrema.numpy())
    jev = jax.vmap(lambda rs, a, m, wx, wy, wz: jr.evaluate(
        rs, a, m, jr.RewardWeights(wx, wy, wz)))
    for i in range(steps):
        acc = rng.integers(0, n_accs, b).astype(np.int32)
        vals = [rng.uniform(1, 1e5, b), rng.uniform(0, 50, b),
                rng.uniform(1, 100, b), rng.uniform(0, 1e3, b),
                rng.uniform(0, 1e6, b)]
        if i == 5:
            vals[3][:2] = 0.0               # zero-access regime
            vals[0][2] = np.inf             # non-finite timing
        m = [v.astype(np.float32) for v in vals]
        jr_r, jrs, jc = jev(jrs, acc, jr.Measurement(*m), *w)
        tr_r, trs, tc = tr.evaluate(trs, _t(acc),
                                    tr.Measurement(*map(_t, m)),
                                    tr.RewardWeights(*map(_t, w)))
        np.testing.assert_allclose(tr_r.numpy(), np.asarray(jr_r), **TOL)
        np.testing.assert_allclose(trs.extrema.numpy(),
                                   np.asarray(jrs.extrema), **TOL)
        for a, c in zip(tc, jc):
            np.testing.assert_allclose(a.numpy(), np.asarray(c), **TOL)


def _rows(rng, b):
    rows = rng.uniform(0, 1, (b, 4)).astype(np.float32)
    rows[0] = 1.0                                   # all ties
    rows[1] = [0.5, 0.5 + 5e-10, 0.2, 0.5]          # ties within 1e-9
    rows[2, 1] = np.nan                             # non-finite row
    rows[3, 3] = np.inf
    rows[4] = [1e-10, 2e-10, 0.0, 3e-10]            # ties near zero
    return rows


def test_row_select_presampled_matches():
    rng = np.random.default_rng(2)
    b = 256
    rows = _rows(rng, b)
    mask = rng.uniform(size=(b, 4)) < 0.7
    mask[:, 0] = True                       # NON_COH always available
    mask[5:9] = [True, False, False, True]
    eps = rng.uniform(0, 1, b).astype(np.float32)
    noise = jq.sample_select_noise(jax.random.PRNGKey(3), (b,), 4)
    want = jax.vmap(lambda r, e, u, gp, gt, m: jq.row_select_presampled(
        r, e, jq.SelectNoise(u, gp, gt), m))(
        rows, eps, noise.u_explore, noise.g_pick, noise.g_tie, mask)
    tn = tq.SelectNoise(*(_t(np.asarray(v)) for v in noise))
    got = tq.row_select_presampled(_t(rows), _t(eps), tn, _t(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[2:4] == 0).all()            # fallback to NON_COH


def test_row_update_matches():
    rng = np.random.default_rng(4)
    b = 64
    rows = rng.uniform(0, 2, (b, 4)).astype(np.float32)
    alpha = rng.uniform(0, 0.25, b).astype(np.float32)
    alpha[:4] = 0.0
    action = rng.integers(0, 4, b).astype(np.int32)
    r = rng.uniform(0, 1.2, b).astype(np.float32)
    r[5], r[6] = np.nan, np.inf
    want = jax.vmap(jq.row_update)(rows, alpha, action, r)
    got = tq.row_update(_t(rows), _t(alpha), _t(action), _t(r))
    assert got.numpy().tobytes() == np.asarray(want).tobytes()
    np.testing.assert_array_equal(got.numpy()[5:7], rows[5:7])


def test_decay_replay_watchdog_match():
    rng = np.random.default_rng(5)
    b, s = 6, 50
    cfg_j = jq.QConfig(decay_steps=120, collapse_frac=0.5)
    cfg_t = tq.QConfig(decay_steps=120, collapse_frac=0.5)
    step0 = rng.integers(0, 100, b).astype(np.int32)
    frozen = np.asarray([False, True, False, False, True, False])
    valid = rng.uniform(size=(b, s)) < 0.8
    inc = (valid & ~frozen[:, None]).astype(np.int32)
    je, ja = jax.vmap(lambda st, fz, i: jq.decay_arrays(cfg_j, st, fz, i))(
        step0, frozen, inc)
    te, ta = tq.decay_arrays(cfg_t, _t(step0), _t(frozen), _t(inc))
    assert te.numpy().tobytes() == np.asarray(je).tobytes()
    assert ta.numpy().tobytes() == np.asarray(ja).tobytes()

    qt = rng.uniform(0, 1, (b, 243, 4)).astype(np.float32)
    visits = rng.integers(0, 5, (b, 243, 4)).astype(np.int32)
    sidx = rng.integers(0, 243, (b, s)).astype(np.int32)
    act = rng.integers(0, 4, (b, s)).astype(np.int32)
    jqs0 = jq.QState(jnp.asarray(qt), jnp.asarray(visits),
                     jnp.asarray(step0), jnp.asarray(frozen))
    want = jax.vmap(jq.replay_visits)(jqs0, jnp.asarray(qt), sidx, act, inc)
    tqs0 = tq.qstate_from_numpy(qt, visits, step0, frozen)
    got = tq.replay_visits(tqs0, tqs0.qtable, _t(sidx), _t(act), _t(inc))
    np.testing.assert_array_equal(got.visits.numpy(), np.asarray(want.visits))
    np.testing.assert_array_equal(got.step.numpy(), np.asarray(want.step))

    ep_r = rng.uniform(0, 1, b).astype(np.float32)
    best = np.asarray([-np.inf, 0.9, 0.9, 0.1, 0.9, 0.0], np.float32)
    jn, jb = jax.vmap(lambda q, e, bb: jq.reward_watchdog(cfg_j, q, e, bb))(
        jqs0, ep_r, best)
    tn, tb = tq.reward_watchdog(cfg_t, tqs0, _t(ep_r), _t(best))
    np.testing.assert_array_equal(tn.step.numpy(), np.asarray(jn.step))
    assert tb.numpy().tobytes() == np.asarray(jb).tobytes()


def test_qstate_numpy_round_trip_and_freeze():
    cfg = jq.QConfig()
    jqs = jq.init_qstate(cfg)
    tqs = tq.qstate_from_numpy(*jqs)
    assert tqs.qtable.shape == (1, 243, 4)
    np.testing.assert_array_equal(tqs.qtable.numpy()[0],
                                  np.asarray(jqs.qtable))
    back = tq.qstate_to_numpy(tq.freeze(tqs))
    assert back["frozen"].all() and (back["step"] == 0).all()
    np.testing.assert_array_equal(
        tq.init_qstate_batch(tq.QConfig(), 3).qtable.numpy(),
        np.asarray(jq.init_qstate_batch(cfg, 3).qtable))
