"""The port's design-space sweep (``repro_torch.soc.dse.run_sweep``,
``rank_axes``) against repro's, and its bucketing contracts, on the CPU.

``run_sweep`` on ``sample_socs(11, 6)`` (2 training iterations, 2
phases, up to 3 buckets) must give the reference's bucket groups, call
counts and padded volumes exactly, ``norm_time`` and ``norm_mem`` (every
SoC x the 7 families) bitwise the reference compiled without fused
multiply-add (:func:`test_torch_serve.reference_without_fma`) and within
rtol = atol = 2e-5 of the FMA build (measured: 1.6e-6), and the same
axis ranking.  The contracts of ``tests/test_soc_dse.py`` hold for the
port: one train and one eval call per bucket, deterministic families
independent of the bucket count, ``sharded=True`` bitwise the plain
sweep (and a forced two-chunk split of it), ``rank_axes`` recovering a
planted signal.
"""
import numpy as np
import pytest
import torch

from repro.soc import dse as jdse
from repro_torch.soc import dse as tdse, shard
from test_torch_serve import reference_without_fma

TOL = dict(rtol=2e-5, atol=2e-5)
SWEEP = dict(iters=2, n_phases=2, max_buckets=3, min_gain=0.0)


def _sweep_tables(out) -> dict:
    tab = {"norm_time": np.asarray(out["norm_time"]),
           "norm_mem": np.asarray(out["norm_mem"]),
           "groups": np.asarray([i for g in out["groups"] for i in g]),
           "group_sizes": np.asarray([len(g) for g in out["groups"]])}
    for k in ("train", "eval", "n_buckets"):
        tab[f"calls/{k}"] = np.asarray(out["calls"][k])
    for k, v in out["waste"].items():
        tab[f"waste/{k}"] = np.asarray(v)
    for k, v in out["margins"].items():
        tab[f"margins/{k}"] = np.asarray(v)
    for k, v in out["axis_ranking"].items():
        tab[f"rank/{k}/axes"] = np.asarray(
            [a for a, _ in v["ranked_coefficients"]])
        tab[f"rank/{k}/coef"] = np.asarray(
            [c for _, c in v["ranked_coefficients"]])
    return tab


def reference_tables() -> dict:
    return _sweep_tables(jdse.run_sweep(jdse.sample_socs(11, 6), **SWEEP))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the port's sweep, reference without FMA, reference as jitted
    here)."""
    port = {}

    def meanwhile():
        port["out"] = tdse.run_sweep(tdse.sample_socs(11, 6), device="cpu",
                                     **SWEEP)
        return reference_tables()

    here, nofma = reference_without_fma(
        "test_torch_dse_sweep", "reference_tables",
        tmp_path_factory.mktemp("nofma"), meanwhile=meanwhile)
    return port["out"], nofma, here


def test_constants_match_reference():
    assert tdse.FEATURE_AXES == jdse.FEATURE_AXES
    assert tdse.EVAL_FAMILIES == jdse.EVAL_FAMILIES
    assert (tdse._BASE_IDX, tdse._N_FIXED) == (jdse._BASE_IDX,
                                               jdse._N_FIXED)
    seeds = np.asarray([s.seed for s in tdse.sample_socs(3, 5)], np.int64)
    np.testing.assert_array_equal(
        tdse._eval_keys(seeds, 7).numpy().astype(np.uint32),
        np.asarray(jdse._eval_keys(seeds, 7)))


def test_run_sweep_matches_reference(runs):
    """Groups, calls and waste exactly; the normalized metrics bitwise
    the no-FMA build and within TOL of the FMA build; margins and the
    axis ranking follow."""
    out, nofma, here = runs
    got = _sweep_tables(out)
    assert set(got) == set(nofma)
    for k in got:
        if k.startswith(("groups", "group_sizes", "calls/", "waste/",
                         "rank/") ) and not k.endswith("/coef"):
            np.testing.assert_array_equal(got[k], nofma[k], err_msg=k)
            np.testing.assert_array_equal(got[k], here[k], err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], nofma[k], err_msg=k)
            np.testing.assert_allclose(got[k], here[k], err_msg=k, **TOL)


def test_sweep_one_call_pair_per_bucket_and_reassembly(runs):
    """Exactly one train and one eval call per bucket, margins finite,
    the NON_COH row normalizes to exactly 1."""
    out = runs[0]
    calls = out["calls"]
    assert calls["train"] == calls["n_buckets"] <= 3
    assert calls["eval"] == calls["n_buckets"]
    assert sorted(i for g in out["groups"] for i in g) == list(range(6))
    nt, nm = out["norm_time"], out["norm_mem"]
    assert nt.shape == (6, len(tdse.EVAL_FAMILIES))
    np.testing.assert_array_equal(nt[:, 0], np.ones(6))
    np.testing.assert_array_equal(nm[:, 0], np.ones(6))
    for v in out["margins"].values():
        assert np.isfinite(v).all()
    assert out["waste"]["padded_volume_bucketed"] \
        <= out["waste"]["padded_volume_single_call"]
    t = out["timing"]
    assert t["train_s"] + t["lower_s"] + t["eval_s"] <= t["train_eval_s"]


def test_sweep_results_independent_of_bucket_count():
    """Deterministic families do not depend on the bucketing; keyed
    families stay finite and positive."""
    samples = tdse.sample_socs(12, 5)
    one = tdse.run_sweep(samples, iters=2, n_phases=2, max_buckets=1,
                         device="cpu")
    many = tdse.run_sweep(samples, iters=2, n_phases=2, max_buckets=3,
                          min_gain=0.0, device="cpu")
    assert len(many["groups"]) > 1
    det = [i for i, f in enumerate(tdse.EVAL_FAMILIES)
           if f.startswith("fixed") or f == "manual"]
    np.testing.assert_array_equal(one["norm_time"][:, det],
                                  many["norm_time"][:, det])
    np.testing.assert_array_equal(one["norm_mem"][:, det],
                                  many["norm_mem"][:, det])
    for out in (one, many):
        assert np.isfinite(out["norm_time"]).all()
        assert (out["norm_time"] > 0).all()


def test_sweep_sharded_is_bitwise(monkeypatch):
    """``sharded=True`` on one device is the plain sweep bitwise, and so
    is each bucket's training split in two chunks over ``[cpu, cpu]``."""
    samples = tdse.sample_socs(13, 4)
    kw = dict(iters=2, n_phases=2, max_buckets=2, min_gain=0.0,
              device="cpu")
    plain = tdse.run_sweep(samples, **kw)
    one = tdse.run_sweep(samples, sharded=True, **kw)
    split = shard.sharded_train_batched_stacked
    monkeypatch.setattr(shard, "sharded_train_batched_stacked",
                        lambda *a, **k: split(*a, devices=["cpu", "cpu"],
                                              force=True, **k))
    two = tdse.run_sweep(samples, sharded=True, **kw)
    for out in (one, two):
        np.testing.assert_array_equal(plain["norm_time"], out["norm_time"])
        np.testing.assert_array_equal(plain["norm_mem"], out["norm_mem"])
        assert plain["groups"] == out["groups"]


def test_rank_axes_recovers_a_planted_signal():
    samples = tdse.sample_socs(0, 48)
    y = np.asarray([0.5 * s.axes["no_l2_frac"] - 0.05 for s in samples])
    out = tdse.rank_axes(samples, {"planted": y})
    top = out["planted"]["ranked_coefficients"][0]
    assert top[0] == "no_l2_frac" and top[1] > 0
    assert out["planted"]["r2"] > 0.99
    ref = jdse.rank_axes(jdse.sample_socs(0, 48), {"planted": y})
    assert out == ref


def test_normalized_is_the_reference_arithmetic():
    """The sweep's normalization, on random phase metrics with padded
    phases, equals the reference's eager nested-vmapped
    ``normalized_metrics`` at least to the last ULP of XLA's CPU
    ``log``/``exp`` (bitwise where XLA has no FMA: the sweep test)."""
    import jax
    from repro.soc import vecenv as jvec
    from repro_torch.soc import vecenv as tvec
    rng = np.random.default_rng(5)
    k, n, p = 4, 7, 3
    pt = rng.uniform(1e-4, 1e-2, (k, n, p)).astype(np.float32)
    po = rng.uniform(0, 1e5, (k, n, p)).astype(np.float32)
    mask = np.ones((k, p), bool)
    mask[1, 2] = mask[3, 1:] = False
    z = np.zeros((k, n, 1), np.float32)
    mk = lambda mod, lib, t, o: mod.EpisodeResult(
        phase_time=lib(t), phase_offchip=lib(o), mode=lib(z),
        state_idx=lib(z), exec_time=lib(z), offchip=lib(z), reward=lib(z))
    jres = mk(jvec, np.asarray, pt, po)
    jbase = jax.tree_util.tree_map(lambda x: x[:, 0], jres)
    jt, jm = jax.vmap(jax.vmap(jvec.normalized_metrics,
                               in_axes=(0, None, None)),
                      in_axes=(0, 0, 0))(jres, jbase, mask)
    tres = mk(tvec, torch.as_tensor, pt, po)
    tt, tm = tdse._normalized(
        tres, type(tres)(*(v[:, 0] for v in tres)), torch.as_tensor(mask))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=2e-7)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=2e-7)
