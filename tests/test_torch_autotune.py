"""The memory-mode autotuner (``repro_torch.core.autotune``) against the
reference's (``repro.core.autotune``).

The Q chain is held to the reference's on the same inputs: the sensed
state index over a grid of batch, sequence and allocated-byte readings;
then 60 decisions from the same seed over a seeded sequence of states
and step times, each the select from the reference's key (split as the
reference splits it), the reward of its measurement and the table's
update: every action equal, every reward and the final table bitwise
the reference built without fused multiply-add (a subprocess with
``XLA_FLAGS=--xla_cpu_max_isa=AVX``) and within 2.4e-7 relative of the
FMA build's.  Then
``tests/test_system.py``'s convergence check on the port, the
``microbatch2`` split failing on a VLM batch in both packages (ROADMAP
C11), and the launcher's ``--autotune``.
"""
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.torch_no_fma import without_fma
from repro.configs import smoke_config as j_smoke
from repro.configs.shapes import ShapeSpec as JShapeSpec
from repro.core import autotune as j_autotune
from repro.core.rewards import Measurement as JMeasurement
from repro.data.synthetic import DataConfig, host_batch
from repro.launch import steps as j_steps
from repro.launch.mesh import make_host_mesh
from repro_torch.configs import smoke_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core import autotune
from repro_torch.launch import steps, train

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
CHAIN = 60


def _orchestrators(total_steps):
    jo = j_autotune.MemoryModeOrchestrator(
        j_smoke("qwen3-8b"), JShapeSpec("t", "train", 64, 8),
        make_host_mesh(), seed=0, total_steps=total_steps)
    to = autotune.MemoryModeOrchestrator(
        smoke_config("qwen3-8b"), ShapeSpec("t", "train", 64, 8), seed=0,
        total_steps=total_steps)
    return jo, to


def test_state_index_matches_reference_sense():
    jo, _ = _orchestrators(10)
    jo._step_no = 1            # no refresh: the cached reading is used
    for b in (1, 7, 8, 9, 63, 64, 65, 300):
        for s in (16, 511, 512, 513, 8191, 8192, 9000):
            for live in (0.0, 0.99e9, 1e9, 1.01e9, 7.9e9, 8e9, 9e9, 80e9):
                jo._live_cache = live
                want = jo._sense({"tokens": np.zeros((b, s), np.int32)})
                assert autotune.state_index(b, s, live) == want, (
                    b, s, live)


def _chain_inputs():
    rng = np.random.default_rng(0)
    return [(int(rng.choice([0, 13, 40, 80])),
             float(np.float32(rng.uniform(0.01, 0.05))),
             float(rng.choice([512.0, 4096.0]))) for _ in range(CHAIN)]


def reference_chain() -> dict:
    """The reference orchestrator's decisions, rewards and table over
    :func:`_chain_inputs`, driven through its own jitted functions."""
    jo = j_autotune.MemoryModeOrchestrator(
        j_smoke("qwen3-8b"), JShapeSpec("t", "train", 64, 8),
        make_host_mesh(), seed=0, total_steps=CHAIN)
    actions, rewards = [], []
    for s_idx, dt, tokens in _chain_inputs():
        jo._key, sub = jax.random.split(jo._key)
        a = int(jo._select(jo.qs, jnp.int32(s_idx), sub))
        m = JMeasurement(
            exec_time=jnp.float32(dt), comm_cycles=jnp.float32(dt),
            total_cycles=jnp.float32(dt),
            offchip_accesses=jnp.float32(jo._bytes_proxy(
                j_autotune.MODES[a])),
            footprint=jnp.float32(tokens))
        r, jo.rstate, _ = jo._eval(jo.rstate, m)
        jo.qs = jo._update(jo.qs, jnp.int32(s_idx), jnp.int32(a), r)
        actions.append(a)
        rewards.append(np.float32(r))
    return {"actions": np.asarray(actions), "rewards": np.asarray(rewards),
            "qtable": np.asarray(jo.qs.qtable),
            "visits": np.asarray(jo.qs.visits),
            "step": np.asarray(jo.qs.step)}


def test_q_chain_matches_reference():
    """Actions equal to both reference builds; rewards and the table
    bitwise the reference compiled without fused multiply-add, and within
    2.4e-7 relative, two float32 ulps, of the FMA build's (its reward ``x
    R_exec + y R_comm + z R_mem`` is contracted: ROADMAP C1; measured one
    ulp on one reward and one table entry)."""
    to = autotune.MemoryModeOrchestrator(
        smoke_config("qwen3-8b"), ShapeSpec("t", "train", 64, 8), seed=0,
        total_steps=CHAIN)
    actions, rewards = [], []
    for s_idx, dt, tokens in _chain_inputs():
        a = to._decide(s_idx)
        actions.append(a)
        rewards.append(np.float32(to._learn(s_idx, a, dt, tokens)))
    got = {"actions": np.asarray(actions), "rewards": np.asarray(rewards),
           "qtable": to.qs.qtable[0].numpy(),
           "visits": to.qs.visits[0].numpy(),
           "step": to.qs.step[0].numpy()}
    path = Path(tempfile.mkdtemp()) / "chain.npz"
    code = (f"import sys, numpy as np; sys.path[:0] = [{str(SRC)!r}, "
            f"{str(TESTS)!r}]; import test_torch_autotune as t; "
            f"np.savez({str(path)!r}, **t.reference_chain())")
    env = dict(os.environ, XLA_FLAGS=without_fma(os.environ.get(
        "XLA_FLAGS", "")), JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(path) as z:
        no_fma = {k: z[k] for k in z.files}
    fma = reference_chain()
    for k in got:
        np.testing.assert_array_equal(got[k], no_fma[k], err_msg=k)
    np.testing.assert_array_equal(got["actions"], fma["actions"])
    np.testing.assert_array_equal(got["visits"], fma["visits"])
    for k in ("rewards", "qtable"):
        np.testing.assert_allclose(got[k], fma[k], rtol=2.4e-7, atol=0,
                                   err_msg=k)
    assert autotune.MODES == j_autotune.MODES
    jo = j_autotune.MemoryModeOrchestrator.__new__(
        j_autotune.MemoryModeOrchestrator)
    assert all(autotune.BYTES_PROXY[m] == jo._bytes_proxy(m)
               for m in autotune.MODES)


def test_autotuner_converges_and_is_cheap():
    """``tests/test_system.py``'s check on the port: after 40 steps of
    Qwen3-8B's smoke config the decisions concentrate on one mode and the
    decide path stays negligible."""
    cfg = smoke_config("qwen3-8b")
    orch = autotune.MemoryModeOrchestrator(cfg, ShapeSpec("t", "train", 64,
                                                          8),
                                           seed=0, total_steps=40)
    state = steps.make_train_state(cfg, 0, "cpu")
    for step in range(40):
        batch = {k: torch.from_numpy(v) for k, v in
                 host_batch(cfg, DataConfig(64, 8, seed=step), step).items()}
        state, m = orch.step(state, batch)
        assert np.isfinite(float(m["loss"]))
    counts = orch.decision_counts()
    assert sum(counts.values()) == 40
    assert max(counts.values()) >= 0.5 * 40, counts
    assert orch.decide_overhead_s() < 0.1
    orch.freeze()
    before = orch.qs.qtable.clone()
    orch.step(state, batch)
    assert torch.equal(orch.qs.qtable, before)


def test_microbatch2_on_a_vlm_batch_fails_in_both_packages():
    """The reference's ``microbatch2`` cuts every batch leaf along axis 0,
    and a VLM's ``mrope_positions`` is (3, B, S): its step fails while
    tracing, and the port's raises the same error type before running."""
    jcfg, cfg = j_smoke("qwen2-vl-2b"), smoke_config("qwen2-vl-2b")
    batch = host_batch(jcfg, DataConfig(16, 8, seed=0), 0)
    jo = j_autotune.MemoryModeOrchestrator(
        jcfg, JShapeSpec("t", "train", 16, 8), make_host_mesh(), seed=0,
        total_steps=4)
    jstate = j_steps.make_train_state(jcfg, jax.random.PRNGKey(0))
    with pytest.raises(TypeError):
        jo._variants["microbatch2"](jstate, {k: jnp.asarray(v)
                                             for k, v in batch.items()})
    to = autotune.MemoryModeOrchestrator(cfg, ShapeSpec("t", "train", 16, 8),
                                         seed=0, total_steps=4)
    state = steps.make_train_state(cfg, 0, "cpu")
    before = {k: p.clone() for k, p in state["params"].named_parameters()}
    with pytest.raises(TypeError, match="mrope_positions"):
        to._variants["microbatch2"](state, {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
    for k, p in state["params"].named_parameters():
        assert torch.equal(p, before[k])
    # a text batch splits into two steps whose metrics are averaged
    tcfg = smoke_config("qwen3-8b")
    to = autotune.MemoryModeOrchestrator(tcfg, ShapeSpec("t", "train", 16,
                                                         4), total_steps=4)
    state = steps.make_train_state(tcfg, 0, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in
          host_batch(tcfg, DataConfig(16, 4, seed=0), 0).items()}
    state, m = to._variants["microbatch2"](state, tb)
    assert int(state["opt"].step) == 2 and np.isfinite(float(m["loss"]))


def test_launcher_autotune_on_cpu(capsys):
    losses = train.main(["--arch", "rwkv6-3b", "--smoke", "--device", "cpu",
                         "--steps", "6", "--batch", "2", "--seq", "16",
                         "--autotune", "--log-every", "3"])
    assert len(losses) == 6 and all(np.isfinite(losses))
    out = capsys.readouterr().out
    assert "autotune decisions:" in out and "step     6 loss" in out
