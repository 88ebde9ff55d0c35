"""Cohmeleon's Q-learning orchestrating the *memory mode* of each train
step (``repro.core.autotune``).

The analogy to the paper, mode for mode:

  paper (SoC)                          here (one training card)
  -----------------------------------  --------------------------------
  coherence mode per LCA invocation    remat/microbatch mode per step
  NON_COH_DMA (bypass caches)          remat="full"  (recompute, least memory)
  LLC_COH_DMA                          remat="dots"  (keep the matmuls)
  COH_DMA                              remat="none"  (keep activations)
  FULLY_COH (private cache)            remat="none" + 2x microbatch
  hardware monitors                    step wall time + a bytes proxy
  Table-3 state (footprint/load)       (batch bucket, seq bucket,
                                        allocated-memory bucket,
                                        footprint bucket)
  multi-objective reward (R_exec,      the same functional forms over
  R_comm, R_mem)                       (step time, step time, bytes proxy)

Each mode is a step variant (``make_train_step`` at its remat setting);
the Q-agent senses the discretized state (|S| = 3^4), picks a variant
per step, measures it and updates its table.  The agent (its table, keys
and reward extrema) lives on the host whatever device trains: a decision
is a few small CPU operations, the paper's negligible overhead
(``decide_overhead_s``, ``benchmarks/torch_overhead.py``).  The
memory-pressure reading is ``torch.cuda.memory_allocated()`` on the card
(where the reference sums ``jax.live_arrays()``), on the CPU the bytes of
the train state and batch, refreshed every 16 steps as there.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.checkpoint.ckpt import flatten
from repro_torch.core import qlearn
from repro_torch.core.rewards import (Measurement, PAPER_DEFAULT_WEIGHTS,
                                      RewardWeights, evaluate,
                                      init_reward_state)
from repro_torch.launch import steps as steps_lib

MODES = ("remat_none", "remat_dots", "remat_full", "microbatch2")
# remat trades bytes for operations: the proxy orders the modes' traffic
BYTES_PROXY = {"remat_none": 3.0, "remat_dots": 2.0, "remat_full": 1.0,
               "microbatch2": 1.5}


def _bucket(x, edges) -> int:
    return int(np.searchsorted(np.asarray(edges, np.float64), x))


def state_index(batch: int, seq: int, live_bytes: float) -> int:
    """The sensed state: buckets of the batch, the sequence length, the
    allocated bytes and the tokens, each in 0..2, as one base-3 index."""
    attrs = [_bucket(batch, [8, 64]), _bucket(seq, [512, 8192]),
             _bucket(live_bytes / 1e9, [1.0, 8.0]),
             _bucket(float(batch * seq) / 1e6, [0.25, 4.0])]
    idx = 0
    for a in attrs:
        idx = idx * 3 + min(a, 2)
    return idx


def _halves(batch: dict):
    """Every batch leaf split along axis 0, as the reference's
    ``microbatch2`` splits it.  A leaf whose axis 0 is not the batch (a
    VLM's ``mrope_positions`` (3, B, S)) makes the reference's halves
    inconsistent and its step fail while tracing (ROADMAP C11); the port
    raises the same ``TypeError`` before it runs anything."""
    b = batch["tokens"].shape[0]
    h1 = {k: _rows(v, 0) for k, v in batch.items()}
    h2 = {k: _rows(v, 1) for k, v in batch.items()}
    for h, want in ((h1, b // 2), (h2, b - b // 2)):
        bad = {k: tuple(v.shape) for k, v in h.items()
               if v.shape[0] != want}
        if bad:
            raise TypeError(f"microbatch2: axis 0 of {bad} is not the batch "
                            f"axis ({want} rows a half)")
    return h1, h2


def _rows(v, half: int):
    """The first or second half of ``v`` along axis 0; a DTensor split
    over data along axis 0 gives each rank's own half, so the halves stay
    split as the batch is (a global half would be one rank's rows)."""
    from repro_torch.distributed import sharding as shd
    if shd.is_dtensor(v) and any(p.is_shard(0) for p in v.placements):
        from torch.distributed.tensor import DTensor
        loc = v.to_local()
        n = loc.shape[0] // 2
        part = loc[:n] if half == 0 else loc[n:]
        return DTensor.from_local(part, v.device_mesh, v.placements,
                                  run_check=False)
    n = v.shape[0] // 2
    return v[:n] if half == 0 else v[n:]


class MemoryModeOrchestrator:
    """Per-step memory-mode selection for the train step."""

    def __init__(self, cfg, spec, mesh=None, seed: int = 0,
                 weights: RewardWeights = PAPER_DEFAULT_WEIGHTS,
                 total_steps: int = 1000, decay_frac: float = 0.5):
        """``mesh``: the (data, model) mesh the train state is placed on
        (None: one device).  The arms are the same step functions, which
        run as DTensor programs on a placed state; ``microbatch2``'s
        halves are taken from each rank's own rows."""
        self.cfg = cfg
        self.spec = spec
        self.mesh = mesh
        self.weights = weights
        self._variants = {m: self._build(m, total_steps) for m in MODES}
        self.qcfg = qlearn.QConfig(
            n_states=3 ** 4, n_actions=len(MODES),
            decay_steps=max(int(total_steps * decay_frac), 1))
        self.qs = qlearn.init_qstate(self.qcfg)
        self.rstate = init_reward_state(1, (1,))
        self._key = prng.PRNGKey(seed)
        self._counts = {m: 0 for m in MODES}
        self._decide_s: list[float] = []
        self._live_cache = 0.0
        self._step_no = 0

    # ------------------------------------------------------------- build
    def _build(self, mode: str, total_steps: int):
        remat = {"remat_dots": "dots", "remat_full": "full"}.get(mode, "none")
        base = steps_lib.make_train_step(self.cfg.replace(remat=remat),
                                         total_steps=total_steps)
        if mode != "microbatch2":
            return base

        def micro2(state, batch):
            half, half2 = _halves(batch)
            state, m1 = base(state, half)
            state, m2 = base(state, half2)
            return state, {k: (m1[k] + m2[k]) / 2.0 for k in m1}

        return micro2

    # ------------------------------------------------------------- sense
    def _live_bytes(self, state, batch) -> float:
        params = state["params"]
        dev = next(params.parameters()).device
        if dev.type == "cuda":
            return float(torch.cuda.memory_allocated(dev))
        tree = [steps_lib.state_tree(state), batch]
        return float(sum(t.nbytes for _, t in flatten(tree)
                         if torch.is_tensor(t)))

    def _sense(self, state, batch) -> int:
        tokens = batch["tokens"]
        # the memory reading is refreshed every 16 steps
        if self._step_no % 16 == 0:
            self._live_cache = self._live_bytes(state, batch)
        return state_index(tokens.shape[0], tokens.shape[-1],
                           self._live_cache)

    # ----------------------------------------------------------- decide
    def _decide(self, s_idx: int) -> int:
        keys = prng.split(self._key)
        self._key, sub = keys[0], keys[1]
        return int(qlearn.select(self.qs, self.qcfg,
                                 torch.tensor([s_idx], dtype=torch.int32),
                                 sub[None])[0])

    def _learn(self, s_idx: int, action: int, dt: float, tokens: float):
        """Reward the measured step and update the table; returns the
        reward."""
        f = lambda x: torch.tensor([x], dtype=torch.float32)
        m = Measurement(exec_time=f(dt), comm_cycles=f(dt),
                        total_cycles=f(dt),
                        offchip_accesses=f(BYTES_PROXY[MODES[action]]),
                        footprint=f(tokens))
        reward, self.rstate, _ = evaluate(
            self.rstate, torch.zeros(1, dtype=torch.int32), m, self.weights)
        self.qs = qlearn.update(self.qs, self.qcfg,
                                torch.tensor([s_idx], dtype=torch.int32),
                                torch.tensor([action], dtype=torch.int32),
                                reward)
        return float(reward[0])

    # -------------------------------------------------------------- step
    def step(self, state, batch):
        t0 = time.perf_counter()
        self._step_no += 1
        s_idx = self._sense(state, batch)
        action = self._decide(s_idx)
        mode = MODES[action]
        self._decide_s.append(time.perf_counter() - t0)

        dev = next(state["params"].parameters()).device
        t1 = time.perf_counter()
        new_state, metrics = self._variants[mode](state, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t1

        self._learn(s_idx, action, dt,
                    float(np.prod(batch["tokens"].shape)))
        self._counts[mode] += 1
        return new_state, metrics

    # --------------------------------------------------------------- api
    def decision_counts(self) -> dict:
        return dict(self._counts)

    def decide_overhead_s(self) -> float:
        return float(np.mean(self._decide_s)) if self._decide_s else 0.0

    def freeze(self):
        self.qs = qlearn.freeze(self.qs)
