"""The comparison that decides ``correct``: the reference's episodes and
streams, recomputed for a sample of rows, against what the program's
timed path produced for them.

The reference makes every input itself (schedules, profiles, noise,
decay values, lowered policies, arrival tables) from the records and
keys the benchmark made.  Where a launch starts from an agent's state
after earlier launches, the reference takes that state from the
program's previous launch and checks it on its way: its own replay of
the glue between launches (visits, counter, watchdog, freezing) must
give the program's next input, and the first launch starts from a fresh
agent the reference builds itself.  So every launch of a unit is
recomputed for the sampled rows, all of them in one batch.

Numbers compared: integer mismatches (counts, limit 0 where the
configuration asks for exact decisions) and float gaps, each the largest
``|program - reference|`` over the largest ``|reference|`` of its field.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from perfbench.reference import episodes as ep
from perfbench.reference import qlearn, rewards, step as ref_step
from perfbench.reference.memsys import SoCStatic
from perfbench.reference.step import StepInputs

# the padding a row of a batch takes past its real extent (the same
# neutral values the program pads lanes with)
_PAD = dict(acc_id=0, footprint=1.0, tiles=False, thread=0, fresh=True,
            others=False, valid=False, pre_mode=0, profile=0.0, avail=True,
            eps=0.0, alpha=0.0, u_explore=0.0, g_pick=0.0, g_tie=0.0)


def rel_gap(prog, ref) -> float:
    """``max |prog - ref| / max |ref|`` (0 when both are all zero); a
    non-finite value where the other side differs reads ``inf``."""
    a = torch.as_tensor(prog).double().cpu()
    b = torch.as_tensor(ref).double().cpu()
    if a.shape != b.shape:
        return math.inf
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    if bool(same.all()):
        return 0.0
    diff = torch.where(same, 0.0, (a - b).abs())
    if not bool(torch.isfinite(diff).all()):
        return math.inf
    scale = float(b[torch.isfinite(b)].abs().max()) if b.numel() else 0.0
    return float(diff.max()) / max(scale, 1e-30)


def mismatches(prog, ref) -> int:
    """How many entries differ (a shape mismatch counts every entry)."""
    a = torch.as_tensor(prog).cpu()
    b = torch.as_tensor(ref).cpu()
    if a.shape != b.shape:
        return max(a.numel(), b.numel(), 1)
    return int((a != b).sum())


class Tally:
    """The running maxima and counts of one check, by name."""

    def __init__(self, names):
        self.v = {n: 0 for n in names}
        self.worst = {}             # the field behind each nonzero reading

    def gap(self, name, prog, ref, what: str = ""):
        g = rel_gap(prog, ref)
        if g > self.v[name]:
            self.v[name], self.worst[name] = g, what

    def count(self, name, prog, ref, what: str = ""):
        n = mismatches(prog, ref)
        if n:
            self.v[name] += n
            self.worst.setdefault(name, what)


@dataclasses.dataclass
class Job:
    """One episode the reference recomputes: a lane's constants, the
    schedule it runs (unpadded), its lowered one-row spec, its QConfig,
    reward weights and key."""

    params: ep.LaneParams
    sched: ep.Schedule
    spec: ep.PolicySpec
    cfg: qlearn.QConfig
    weights: rewards.RewardWeights
    key: torch.Tensor


def _pad_to(v: torch.Tensor, dim: int, n: int, fill) -> torch.Tensor:
    if v.shape[dim] == n:
        return v
    shape = list(v.shape)
    shape[dim] = n - v.shape[dim]
    return torch.cat([v, torch.full(shape, fill, dtype=v.dtype,
                                    device=v.device)], dim)


def run_batch(jobs: list, device="cpu"):
    """Every job's episode in one plain batch on ``device`` (rows padded
    to the longest schedule, the widest thread, tile and accelerator axes
    with gated no-op steps); returns per job ``(qtable (243, A), ys)`` on
    the host, ``ys`` the six per-step columns over the job's real steps."""
    parts = [ep.episode_inputs(j.params, j.sched, j.spec, j.cfg,
                               j.key[None], gated=True)[0] for j in jobs]
    n_s = max(p.acc_id.shape[1] for p in parts)
    n_t = max(p.others.shape[-1] for p in parts)
    n_tiles = max(p.tiles.shape[-1] for p in parts)
    n_accs = max(j.params.pmat.shape[0] for j in jobs)
    cols = {}
    for f in StepInputs._fields:
        vs = [getattr(p, f) for p in parts]
        if vs[0] is None:
            cols[f] = None
            continue
        if f == "others":
            vs = [_pad_to(v, 2, n_t, False) for v in vs]
        if f == "tiles":
            vs = [_pad_to(v, 2, n_tiles, False) for v in vs]
        cols[f] = torch.cat([_pad_to(v.contiguous(), 1, n_s, _PAD[f])
                             for v in vs])
    xs = StepInputs(**cols)
    static = SoCStatic(*(torch.tensor(
        [float(np.float32(getattr(j.params.static, f))) for j in jobs],
        dtype=torch.float32) for f in SoCStatic._fields))
    weights = rewards.RewardWeights(*(torch.tensor(
        [float(getattr(j.weights, f)) for j in jobs], dtype=torch.float32)
        for f in rewards.RewardWeights._fields))
    learned = torch.cat([j.spec.learned.reshape(1) for j in jobs])
    qtable0 = torch.cat([j.spec.qstate.qtable for j in jobs])
    extrema0 = rewards.init_reward_state(n_accs, (len(jobs),)).extrema
    dev = lambda v: None if v is None else v.to(device)
    qtable, ys = ref_step.episode_ref(
        SoCStatic(*map(dev, static)), dev(learned),
        rewards.RewardWeights(*map(dev, weights)), dev(qtable0),
        dev(extrema0), StepInputs(*map(dev, xs)), gated=True)
    qtable, ys = qtable.cpu(), tuple(y.cpu() for y in ys)
    out = []
    for i, j in enumerate(jobs):
        n = j.sched.acc_id.shape[0]
        out.append((qtable[i], tuple(y[i, :n] for y in ys)))
    return out


def keys_chain(key0: torch.Tensor, iterations: int):
    """Training's key protocol for one agent: each iteration splits the
    agent's key three ways (next key, training episode, evaluation
    episode).  Returns ``[(train_key, eval_key), ...]``."""
    out, key = [], key0
    for _ in range(iterations):
        ks = qlearn.prng.split(key, 3)
        out.append((ks[1], ks[2]))
        key = ks[0]
    return out

