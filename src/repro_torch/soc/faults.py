"""Presampled fault injection for the SoC environments.

Production SoCs are not always healthy: accelerators brown out, DDR
channels lose bandwidth, the LLC sees contention bursts from co-tenants,
and invocations get dropped by flaky drivers and must be retried.  A
:class:`FaultSpec` expresses all of that for one episode; every
environment of the port accepts one (``VecEnv``, ``ServeEnv``,
``StackedVecEnv``, the fused step in both its CUDA and plain versions).
Semantics, field meanings and random draws follow ``repro.soc.faults``:

  * **Presampled**: the drop coins come from ONE threefry draw per episode
    against the spec's OWN ``key`` (:mod:`repro_torch.random`), lowered to
    per-step rows (:func:`sample_fault_arrays`).  The episode's main key
    stream is never touched, so a zero spec (:func:`no_faults`) is bitwise
    the ``faults=None`` episode: every perturbation reduces to ``x * 1.0``
    or ``x + 0.0``.
  * **Window-based**: each fault class is a ``[start, end)`` window in
    invocation-start order (the order the compiled episode runs in).

Fault classes: an accelerator slowdown multiplies the victim's compute
cost per byte (``slow_factor``); DDR throttling scales the SoC's DRAM
bandwidth (``ddr_scale``); an LLC spike adds ``llc_extra`` bytes/cycle
of foreign LLC load; dropped invocations fail each attempt with
``drop_prob`` up to :data:`FAULT_MAX_RETRIES` times, costing
``backoff * (2**retries - 1)`` extra driver cycles.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import random as prng

# Bounded retry budget per invocation: at most this many re-submissions
# before the driver runs the invocation anyway at the accumulated backoff.
FAULT_MAX_RETRIES = 3

_ALL_ACCS = -1  # "every accelerator is a victim"

_INT_FIELDS = ("slow_start", "slow_end", "slow_acc", "ddr_start", "ddr_end",
               "llc_start", "llc_end", "drop_start", "drop_end", "drop_acc")


class FaultSpec(NamedTuple):
    """One episode's fault scenario: 0-d int32/float32 tensors and a
    ``(2,)`` port key.  Windows are ``[start, end)`` in invocation-start
    order (empty when ``end <= start``); ``slow_acc``/``drop_acc`` pick a
    victim accelerator id, or ``-1`` for all."""

    slow_start: torch.Tensor   # int32
    slow_end: torch.Tensor     # int32
    slow_acc: torch.Tensor     # int32, -1 = all accelerators
    slow_factor: torch.Tensor  # float32 compute-cost multiplier (>= 1)
    ddr_start: torch.Tensor    # int32
    ddr_end: torch.Tensor      # int32
    ddr_scale: torch.Tensor    # float32 dram_bw multiplier (<= 1)
    llc_start: torch.Tensor    # int32
    llc_end: torch.Tensor      # int32
    llc_extra: torch.Tensor    # float32 extra LLC bytes/cycle of load
    drop_start: torch.Tensor   # int32
    drop_end: torch.Tensor     # int32
    drop_acc: torch.Tensor     # int32, -1 = all accelerators
    drop_prob: torch.Tensor    # float32 per-attempt drop probability
    backoff: torch.Tensor      # float32 driver cycles of the first retry
    key: torch.Tensor          # (2,) the spec's own threefry key

    def to(self, device) -> "FaultSpec":
        return FaultSpec(*(v.to(device) for v in self))


class StepFault(NamedTuple):
    """Per-step perturbation rows (``(..., S)`` leaves); the neutral row
    (1, 1, 0, 0) is an exact arithmetic no-op."""

    exec_scale: torch.Tensor    # compute-cost multiplier (1.0 = healthy)
    ddr_scale: torch.Tensor     # dram_bw multiplier (1.0 = healthy)
    llc_extra: torch.Tensor     # extra LLC bytes/cycle (0.0 = none)
    retry_cycles: torch.Tensor  # extra driver cycles from drop retries


def _spec(key, device=None, **values) -> FaultSpec:
    def leaf(name):
        dt = torch.int32 if name in _INT_FIELDS else torch.float32
        # Python doubles cast to float32 once, as jnp.asarray(v, f32) does
        return torch.tensor(values[name], dtype=dt, device=device)

    key = prng.PRNGKey(0) if key is None else torch.as_tensor(key)
    return FaultSpec(*(leaf(f) for f in FaultSpec._fields[:-1]),
                     key=key.to(device=device, dtype=torch.int64))


def no_faults(key=None, device=None) -> FaultSpec:
    """An all-neutral spec: episodes under it are bitwise the
    ``faults=None`` episodes."""
    return _spec(key, device, slow_start=0, slow_end=0, slow_acc=_ALL_ACCS,
                 slow_factor=1.0, ddr_start=0, ddr_end=0, ddr_scale=1.0,
                 llc_start=0, llc_end=0, llc_extra=0.0, drop_start=0,
                 drop_end=0, drop_acc=_ALL_ACCS, drop_prob=0.0, backoff=0.0)


def neutral_step_fault(device=None) -> StepFault:
    """The healthy per-step row (an exact no-op when applied)."""
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    return StepFault(t(1.0), t(1.0), t(0.0), t(0.0))


def storm(n_steps: int, intensity: float, key, slow_acc: int = _ALL_ACCS,
          drop_acc: int = _ALL_ACCS, backoff: float = 5000.0,
          device=None) -> FaultSpec:
    """A composite fault storm scaled by ``intensity`` in [0, 1]: an
    accelerator brownout over the middle half, DDR throttling over the
    second third, an LLC spike over the first half and a drop window over
    the last third.  ``intensity=0`` is neutral."""
    n = int(n_steps)
    return _spec(key, device, slow_start=n // 4, slow_end=n - n // 4,
                 slow_acc=slow_acc, slow_factor=1.0 + 4.0 * intensity,
                 ddr_start=n // 3, ddr_end=2 * n // 3,
                 ddr_scale=1.0 / (1.0 + 3.0 * intensity), llc_start=0,
                 llc_end=n // 2, llc_extra=4.0 * intensity,
                 drop_start=2 * n // 3, drop_end=n, drop_acc=drop_acc,
                 drop_prob=0.5 * intensity, backoff=backoff)


def faults_from_numpy(spec, device=None) -> FaultSpec:
    """A port spec from a reference ``FaultSpec`` whose leaves are (or
    convert to) numpy arrays; its key's uint32 words carry over."""
    values = {f: np.asarray(getattr(spec, f)).item()
              for f in FaultSpec._fields[:-1]}
    return _spec(prng.key_from_numpy(np.asarray(spec.key)), device, **values)


def backoff_cycles(backoff, retries):
    """``backoff * (2**retries - 1)`` for integer ``retries`` in 0..3,
    exact (the reference's ``exp2`` of a small integer is exact); zero
    retries give ``+0.0``."""
    r = torch.as_tensor(retries).to(torch.int64)
    return backoff * ((1 << r) - 1).to(torch.float32)


def fault_row(spec: FaultSpec, t, acc_id, u_retry) -> StepFault:
    """Lower the spec to the rows of invocations ``t`` (global
    invocation-start indices) on accelerators ``acc_id``, with ``u_retry
    (..., FAULT_MAX_RETRIES)`` the per-attempt drop coins."""
    f32 = torch.float32

    def in_window(a, b):
        return (t >= a) & (t < b)

    one = torch.ones((), dtype=f32, device=u_retry.device)
    zero = torch.zeros((), dtype=f32, device=u_retry.device)
    slow_hit = (in_window(spec.slow_start, spec.slow_end)
                & ((spec.slow_acc < 0) | (acc_id == spec.slow_acc)))
    exec_scale = torch.where(slow_hit, spec.slow_factor, one)
    ddr_scale = torch.where(in_window(spec.ddr_start, spec.ddr_end),
                            spec.ddr_scale, one)
    llc_extra = torch.where(in_window(spec.llc_start, spec.llc_end),
                            spec.llc_extra, zero)
    drop_hit = (in_window(spec.drop_start, spec.drop_end)
                & ((spec.drop_acc < 0) | (acc_id == spec.drop_acc)))
    p = torch.where(drop_hit, spec.drop_prob, zero)
    # attempt i fails iff its coin is below p and every earlier one failed
    failed = (u_retry < p[..., None]).to(torch.int64)
    retries = torch.cumprod(failed, -1).sum(-1)
    return StepFault(exec_scale=exec_scale, ddr_scale=ddr_scale,
                     llc_extra=llc_extra,
                     retry_cycles=backoff_cycles(spec.backoff, retries))


def sample_fault_uniforms(spec: FaultSpec, n_steps: int) -> torch.Tensor:
    """The episode's ``(n_steps, FAULT_MAX_RETRIES)`` drop coins: one
    threefry draw from the spec's own key."""
    return prng.uniform(spec.key, (int(n_steps), FAULT_MAX_RETRIES))


def sample_fault_arrays(spec: FaultSpec, acc_id) -> StepFault:
    """A spec's per-step rows for a schedule's ``(S,)`` accelerator
    column (``(S,)`` leaves).  The coins are drawn over the full, possibly
    padded, length ``S``."""
    acc_id = torch.as_tensor(acc_id).to(torch.int32)
    n_steps = acc_id.shape[0]
    spec = spec.to(acc_id.device)
    u = sample_fault_uniforms(spec, n_steps)
    t = torch.arange(n_steps, dtype=torch.int32, device=acc_id.device)
    return fault_row(spec, t, acc_id, u)
