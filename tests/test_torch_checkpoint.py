"""Crash-resumable state in the port: ``repro_torch.checkpoint`` and the
checkpointed training and serving of ``repro_torch.soc.vecenv``, on the
CPU.

The contract (``tests/test_train_checkpoint.py`` and the checkpoint cases
of ``tests/test_soc_traffic.py`` for the reference): a checkpointed run is
a re-chunking of the uninterrupted one, so any interleaving of saves,
crashes and restarts ends bitwise equal to one uninterrupted run with the
same arguments.  Cases: SoC1 chain applications of two phases, two agents
trained for three iterations (so two-iteration chunks leave a remainder)
inside a fault storm with the collapse watchdog on; one learning stream
served in three chunks of 32 requests under a storm.
"""
import json
import os
from typing import NamedTuple

import numpy as np
import pytest
import torch

from repro_torch import random as prng
from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import qlearn, rewards
from repro_torch.soc import faults, traffic, vecenv
from repro_torch.soc.apps import make_phase
from repro_torch.soc.config import SOCS
from repro_torch.soc.des import Application

ITERS, B, N_CHUNKS, N_REQ = 3, 2, 3, 32


def _chain_app(soc, seed):
    rng = np.random.default_rng(seed)
    phases = [make_phase(rng, soc, name=f"p{i}", n_threads=1,
                         size_classes=[c], chain_len=3, loops=2)
              for i, c in enumerate(("S", "M"))]
    return Application(name=f"{soc.name}-ckpt{seed}", phases=phases)


@pytest.fixture(scope="module")
def setting():
    soc = SOCS["SoC1"]
    env = vecenv.VecEnv(soc, seed=1, device="cpu")
    apps = [vecenv.compile_app(_chain_app(soc, s), soc, seed=7 + s)
            for s in range(ITERS)]
    wb = rewards.stack_weights([rewards.RewardWeights()] * B)
    keys = prng.PRNGKey(np.arange(B))
    cfg = qlearn.QConfig(collapse_frac=0.5)
    fs = faults.storm(apps[0].n_steps, 0.5, prng.PRNGKey(9))
    return env, apps, cfg, wb, keys, fs


def _bitwise(a, b):
    if a is None:          # an optional leaf (a table stream's wpack)
        assert b is None
        return
    if torch.is_tensor(a):
        assert torch.equal(a, b)
        return
    assert type(a) is type(b) and len(a) == len(b)
    for x, y in zip(a, b):
        _bitwise(x, y)


class _Killer:
    """A manager that dies (before writing) once ``die_after`` saves
    went through, as a killed host would, leaving the directory in its
    last consistent state."""

    def __init__(self, inner: CheckpointManager, die_after: int):
        self._inner, self._left = inner, die_after

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def save(self, step, tree):
        if self._left <= 0:
            raise KeyboardInterrupt("simulated crash")
        self._left -= 1
        self._inner.save(step, tree)
        self._inner.wait()


# ------------------------------------------------------------------ ckpt
class _Pair(NamedTuple):
    a: torch.Tensor
    b: object


def _tree():
    return {"state": qlearn.init_qstate_batch(qlearn.QConfig(), 2),
            "pair": _Pair(torch.arange(6, dtype=torch.int64).reshape(3, 2),
                          None),
            "mask": torch.tensor([True, False]),
            "list": [torch.tensor(1.5), torch.zeros(2, dtype=torch.int32)],
            "done": 4, "t0": 2.5}


def test_ckpt_round_trip(tmp_path):
    tree = _tree()
    tree["state"] = tree["state"]._replace(
        qtable=torch.randn(2, 243, 4), step=torch.tensor([3, 9],
                                                         dtype=torch.int32))
    ckpt.save(str(tmp_path / "c"), tree)
    got = ckpt.restore(str(tmp_path / "c"), _tree())
    assert isinstance(got["state"], qlearn.QState)
    assert got["pair"].b is None
    assert got["done"] == 4 and type(got["done"]) is int
    assert got["t0"] == 2.5
    for key in ("state", "mask", "list"):
        _bitwise(got[key], tree[key])
    _bitwise(got["pair"].a, tree["pair"].a)
    names = json.load(open(tmp_path / "c" / ckpt.MANIFEST))["leaves"]
    assert [e["key"] for e in names][:2] == ["done", "list.0"]
    # saving over an existing checkpoint replaces it atomically
    ckpt.save(str(tmp_path / "c"), {**tree, "done": 5})
    assert ckpt.restore(str(tmp_path / "c"), _tree())["done"] == 5


def test_ckpt_restore_refuses_mismatches(tmp_path):
    ckpt.save(str(tmp_path / "c"), _tree())
    bad_shape = {**_tree(), "mask": torch.zeros(3, dtype=torch.bool)}
    with pytest.raises(ValueError, match="mask"):
        ckpt.restore(str(tmp_path / "c"), bad_shape)
    bad_dtype = {**_tree(), "mask": torch.zeros(2, dtype=torch.int32)}
    with pytest.raises(ValueError, match="mask"):
        ckpt.restore(str(tmp_path / "c"), bad_dtype)
    with pytest.raises(KeyError, match="extra"):
        ckpt.restore(str(tmp_path / "c"), {**_tree(), "extra": 1})
    with pytest.raises(TypeError, match="object"):
        ckpt.save(str(tmp_path / "d"), {"x": object()})


def test_manager_retention_discovery_and_damage(tmp_path):
    d = str(tmp_path / "m")
    os.makedirs(os.path.join(d, ".ckpt-tmp-orphan"))
    mgr = CheckpointManager(d, keep=2)
    assert not os.path.exists(os.path.join(d, ".ckpt-tmp-orphan"))
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(_tree())
    tree = _tree()
    for step in (1, 2, 3):
        tree["done"] = step
        mgr.save(step, tree)
        tree["mask"][0] = not tree["mask"][0]   # after save: not written
    mgr.wait()
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    got = mgr.restore(_tree())
    assert got["done"] == 3 and got["mask"].tolist() == [True, False]
    newest = os.path.join(d, "step_00000003")
    os.remove(os.path.join(newest, "done.npy"))
    assert mgr.restore(_tree())["done"] == 2          # walks past it
    with pytest.raises(FileNotFoundError):
        mgr.restore(_tree(), step=3)                  # pinned: no fallback
    sync = CheckpointManager(str(tmp_path / "s"), async_write=False)
    sync.save(7, tree)
    assert sync.latest_step() == 7


def test_manager_reraises_a_failed_write(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "m"))
    blocker = tmp_path / "m" / "step_00000001.old"
    blocker.write_text("a file where the writer needs a directory")
    os.makedirs(tmp_path / "m" / "step_00000001")
    mgr.save(1, _tree())
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()   # reported once


# -------------------------------------------------- checkpointed training
@pytest.mark.parametrize("ckpt_every", [1, 2])
def test_chunked_training_equals_monolithic(setting, tmp_path, ckpt_every):
    env, apps, cfg, wb, keys, fs = setting
    ref = env.train_batched(apps, cfg, wb, keys, eval_app=apps[0],
                            faults=fs)
    mgr = CheckpointManager(str(tmp_path / f"ck{ckpt_every}"), keep=2)
    got = env.train_batched_checkpointed(apps, cfg, wb, keys, mgr,
                                         ckpt_every=ckpt_every,
                                         eval_app=apps[0], faults=fs)
    _bitwise(got, ref)
    assert mgr.latest_step() == ITERS and len(mgr.all_steps()) <= 2


def test_chunked_training_no_eval_no_faults(setting, tmp_path):
    env, apps, cfg, wb, keys, _ = setting
    ref_qs, _ = env.train_batched(apps, cfg, wb, keys)
    qs, hist = env.train_batched_checkpointed(
        apps, cfg, wb, keys, CheckpointManager(str(tmp_path / "ck")),
        ckpt_every=2)
    _bitwise(qs, ref_qs)
    assert hist[0].shape == (B, ITERS) and not hist[0].any()


@pytest.mark.parametrize("die_after", [1, 2])
def test_training_kill_and_resume_bitwise(setting, tmp_path, die_after):
    env, apps, cfg, wb, keys, fs = setting
    ref = env.train_batched(apps, cfg, wb, keys, eval_app=apps[0],
                            faults=fs)
    d = str(tmp_path / f"kill{die_after}")
    with pytest.raises(KeyboardInterrupt):
        env.train_batched_checkpointed(
            apps, cfg, wb, keys, _Killer(CheckpointManager(d), die_after),
            eval_app=apps[0], faults=fs)
    mgr = CheckpointManager(d)
    assert mgr.latest_step() == die_after
    _bitwise(env.train_batched_checkpointed(apps, cfg, wb, keys, mgr,
                                            eval_app=apps[0], faults=fs),
             ref)


def test_training_resumes_past_damaged_newest(setting, tmp_path):
    """A crash during the newest save (a torn checkpoint) falls back to
    the previous complete one and still ends bitwise equal."""
    env, apps, cfg, wb, keys, fs = setting
    ref = env.train_batched(apps, cfg, wb, keys, eval_app=apps[0],
                            faults=fs)
    d = str(tmp_path / "torn")
    with pytest.raises(KeyboardInterrupt):
        env.train_batched_checkpointed(
            apps, cfg, wb, keys, _Killer(CheckpointManager(d), 2),
            eval_app=apps[0], faults=fs)
    newest = os.path.join(d, "step_00000002")
    os.remove(os.path.join(newest, sorted(
        f for f in os.listdir(newest) if f.endswith(".npy"))[0]))
    _bitwise(env.train_batched_checkpointed(
        apps, cfg, wb, keys, CheckpointManager(d), eval_app=apps[0],
        faults=fs), ref)


def test_fresh_directory_trains_from_scratch(setting, tmp_path):
    env, apps, cfg, wb, keys, _ = setting
    mgr = CheckpointManager(str(tmp_path / "fresh"))
    assert mgr.latest_step() is None
    qs, _ = env.train_batched_checkpointed(apps, cfg, wb, keys, mgr,
                                           ckpt_every=ITERS)
    _bitwise(qs, env.train_batched(apps, cfg, wb, keys)[0])
    with pytest.raises(ValueError):
        env.train_batched_checkpointed(apps, cfg, wb, keys, mgr,
                                       ckpt_every=0)


# --------------------------------------------------- checkpointed serving
def _stream(setting):
    env, apps, *_ = setting
    serve_env = vecenv.ServeEnv(env, queue_cap=4, n_requests=N_REQ)
    spec = vecenv.learned_policy_spec(qlearn.init_qstate(),
                                      apps[1].schedule)
    tspec = traffic.bursty(4e-3, mix=(0.7, 0.3), deadline=(6000.0, 0.0),
                           priority=(1.0, 0.25), backoff=400.0,
                           overload_frac=0.35, prio_reserve=0.25, seed=3)
    fs = faults.storm(N_REQ, 0.7, prng.PRNGKey(42))
    return serve_env, apps[1], spec, tspec, fs


def _monolithic_stream(setting, key):
    """The uninterrupted stream, chained by hand."""
    serve_env, app, spec, tspec, fs = _stream(setting)
    carry, qs, t0, outs = None, spec.qstate, 0.0, []
    for i in range(N_CHUNKS):
        carry, qs, res = serve_env.serve(
            app, spec._replace(qstate=qs), traffic.chunk_key(tspec, i),
            cfg=qlearn.QConfig(decay_steps=200), key=prng.fold_in(key, i),
            carry=carry, t0=t0, faults=fs)
        outs.append(res)
        t0 = res.t_arr[-1]
    return carry, qs, vecenv.ServeResult(*(torch.cat(vs)
                                           for vs in zip(*outs)))


def _checkpointed_stream(setting, mgr, key):
    serve_env, app, spec, tspec, fs = _stream(setting)
    return serve_env.serve_checkpointed(
        app, spec, tspec, mgr, n_chunks=N_CHUNKS,
        cfg=qlearn.QConfig(decay_steps=200), key=key, faults=fs)


def test_serve_checkpointed_matches_monolithic(setting, tmp_path):
    key = prng.PRNGKey(8)
    ref = _monolithic_stream(setting, key)
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    got = _checkpointed_stream(setting, mgr, key)
    _bitwise(got, ref)
    assert mgr.latest_step() == N_CHUNKS
    assert 0 < int(got[2].executed.sum()) < N_CHUNKS * N_REQ


@pytest.mark.parametrize("die_after", [1, 2])
def test_serve_kill_and_resume_bitwise(setting, tmp_path, die_after):
    key = prng.PRNGKey(8)
    ref = _monolithic_stream(setting, key)
    d = str(tmp_path / f"kill{die_after}")
    with pytest.raises(KeyboardInterrupt):
        _checkpointed_stream(setting, _Killer(CheckpointManager(d),
                                              die_after), key)
    mgr = CheckpointManager(d)
    assert mgr.latest_step() == die_after
    _bitwise(_checkpointed_stream(setting, mgr, key), ref)


def test_serve_resumes_past_damaged_newest(setting, tmp_path):
    key = prng.PRNGKey(8)
    ref = _monolithic_stream(setting, key)
    d = str(tmp_path / "torn")
    with pytest.raises(KeyboardInterrupt):
        _checkpointed_stream(setting, _Killer(CheckpointManager(d), 2), key)
    with open(os.path.join(d, "step_00000002", ckpt.MANIFEST), "w") as f:
        f.write("{torn")
    _bitwise(_checkpointed_stream(setting, CheckpointManager(d), key), ref)
