"""Discrete-event simulator of the ESP-like SoC running phased applications.

This is the fidelity path (the scale path is :mod:`repro_torch.soc.vecenv`).
It mirrors the paper's runtime structure:

  * an *application* is a list of phases; a *phase* is a set of software
    threads; a *thread* is a chain of accelerator invocations over one
    dataset (output of one feeds the next), optionally looped (paper §5);
  * at each invocation the runtime senses the Table-3 state, asks the
    policy for a coherence mode, actuates it, and on completion evaluates
    the paper's multi-objective reward from the hardware monitors —
    including the paper's *attributed* (approximate) DRAM counts;
  * invocation timing comes from the memory-system model
    (:func:`repro_torch.soc.memsys.invocation_perf`), evaluated against
    the set of concurrently-active accelerators at start time
    (single-rate approximation).

The event loop is host Python (a heap, like a real driver stack), and so
are the continuous DDR counters and their attribution (numpy float64).
The timing model, the reward evaluation and the sensing run as tensor
code on the simulator's device (``device=None``: the CUDA card, where the
timing model replays as a CUDA graph); each invocation reads the timing
model's outputs back in one transfer.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import rewards, state as cstate
from repro_torch.core.modes import CoherenceMode, N_MODES
from repro_torch.core.policies import DecisionContext, Policy
from repro_torch.soc import faults as fault_mod
from repro_torch.soc.accelerators import (AccProfile, profile_matrix,
                                          resolve_profiles)
from repro_torch.soc.config import SoCConfig
from repro_torch.soc.memsys import SoCStatic, invocation_perf, static_tensors

MAX_SLOTS = 32           # fixed concurrency slots of the timing model
# Allocation interleaving across memory tiles: ESP partitions the address
# space per memory tile and accelerator data spreads across partitions
# (the paper's ddr(k,m) attribution sums footprint(acc, m) over tiles m,
# and its L workload class "smaller than the AGGREGATE LLC" presumes
# multi-partition residency).  256KB page-set striping reproduces that.
_STRIPE_BYTES = 256 << 10
_NC = int(CoherenceMode.NON_COH_DMA)


def stripe_tiles(rng: np.random.Generator, n_tiles: int,
                 footprint: float) -> np.ndarray:
    """Memory-tile mask for one invocation: contiguous 256KB-page-set
    striping from a random start tile.  One ``rng.integers`` draw per
    invocation, shared with the batched environment's tracer, so a seed
    gives the same masks on both paths."""
    span = int(min(n_tiles, max(1, int(np.ceil(footprint / _STRIPE_BYTES)))))
    start = int(rng.integers(0, n_tiles))
    mask = np.zeros(n_tiles, bool)
    for k in range(span):
        mask[(start + k) % n_tiles] = True
    return mask


@dataclasses.dataclass(frozen=True)
class Invocation:
    acc_id: int
    footprint: float


@dataclasses.dataclass(frozen=True)
class Thread:
    chain: Sequence[Invocation]
    loops: int = 1


@dataclasses.dataclass(frozen=True)
class Phase:
    name: str
    threads: Sequence[Thread]


@dataclasses.dataclass(frozen=True)
class Application:
    name: str
    phases: Sequence[Phase]


@dataclasses.dataclass
class InvocationRecord:
    acc_id: int
    acc_name: str
    footprint: float
    mode: int
    state_idx: int
    start: float
    end: float
    exec_time: float
    offchip_true: float       # ground-truth line accesses
    offchip_attr: float       # paper-attributed line accesses
    reward: float


@dataclasses.dataclass
class PhaseResult:
    name: str
    wall_time: float
    offchip_accesses: float
    invocations: list[InvocationRecord]


@dataclasses.dataclass
class RunResult:
    policy: str
    phases: list[PhaseResult]
    decide_overhead_s: float   # mean host-side seconds per decision

    @property
    def total_time(self) -> float:
        return sum(p.wall_time for p in self.phases)

    @property
    def total_offchip(self) -> float:
        return sum(p.offchip_accesses for p in self.phases)


class _Active:
    """Bookkeeping for one in-flight invocation."""

    __slots__ = ("acc_id", "mode", "footprint", "tiles", "start", "end",
                 "offchip_per_tile", "meas", "state_idx", "ddr_before")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


class _TimingModel:
    """The timing model of one invocation on ``pmat``'s device.

    ``fn(packed, fault=None)`` takes one float32 host row — ``[mode,
    acc_id, footprint, warm, my_tiles (n_tiles), then per slot
    (MAX_SLOTS): mode (-1 inactive), acc_id, footprint, tiles
    (n_tiles)]`` — copies it to the device in one transfer, gathers the
    profile rows there and returns ``(exec_time, comm_cycles,
    total_cycles, offchip_accesses, offchip_bytes)`` as one host float32
    array (one read back).  ``fault`` is a
    :class:`~repro_torch.soc.faults.StepFault` of ``(1,)`` rows.

    On a CUDA device each variant (healthy, faulted) runs as a CUDA graph
    captured on its first call — the same kernels in the same order as
    :meth:`eager`, replayed from static buffers, so one launch instead of
    some three hundred."""

    def __init__(self, s: SoCStatic, pmat: torch.Tensor, n_tiles: int):
        self.pmat = pmat
        self.dev = pmat.device
        self.st = static_tensors(s, 1, self.dev)
        self.n_tiles = n_tiles
        self.width = 4 + n_tiles + MAX_SLOTS * (3 + n_tiles)
        self._graph: dict = {}

    def eager(self, x: torch.Tensor, fault=None) -> torch.Tensor:
        """The five outputs ``(5,)`` of a packed row already on the
        device."""
        nt = self.n_tiles
        head = x[:4 + nt]
        slots = x[4 + nt:].reshape(MAX_SLOTS, 3 + nt)
        m, aux = invocation_perf(
            head[0:1].to(torch.int32), self.pmat[head[1:2].long()],
            head[2:3], head[None, 4:] > 0.5,
            slots[None, :, 0].to(torch.int32),
            self.pmat[slots[:, 1].long()][None], slots[None, :, 2],
            slots[None, :, 3:] > 0.5, head[3:4], self.st, fault=fault)
        return torch.cat([m.exec_time, m.comm_cycles, m.total_cycles,
                          m.offchip_accesses, aux["offchip_bytes"]])

    def _capture(self, faulted: bool):
        """Static input buffers (a pinned host row, its device copy, a
        fault row) and the graph that reads them."""
        host = torch.zeros(self.width, dtype=torch.float32, pin_memory=True)
        x = torch.zeros(self.width, dtype=torch.float32, device=self.dev)
        fbuf = torch.tensor([1.0, 1.0, 0.0, 0.0], device=self.dev)
        fault = (fault_mod.StepFault(*fbuf.reshape(4, 1)) if faulted
                 else None)
        side = torch.cuda.Stream(self.dev)
        side.wait_stream(torch.cuda.current_stream(self.dev))
        with torch.cuda.stream(side):
            for _ in range(2):
                self.eager(x, fault)
        torch.cuda.current_stream(self.dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self.eager(x, fault)
        return host, x, fbuf, graph, out

    def __call__(self, packed: np.ndarray, fault=None) -> np.ndarray:
        if self.dev.type != "cuda":
            return self.eager(torch.from_numpy(packed).to(self.dev),
                              fault).cpu().numpy()
        faulted = fault is not None
        if faulted not in self._graph:
            self._graph[faulted] = self._capture(faulted)
        host, x, fbuf, graph, out = self._graph[faulted]
        host.numpy()[:] = packed
        x.copy_(host, non_blocking=True)
        if faulted:
            fbuf.copy_(torch.cat(list(fault)))
        graph.replay()
        return out.cpu().numpy()


class SoCSimulator:
    """Event-driven simulator for one SoC + accelerator set.

    ``device=None`` runs the timing model, the reward evaluation and the
    sensing on the CUDA card (raising without one); ``device="cpu"`` runs
    them on the CPU.  A policy's own state (a Q-table, a network) stays
    where the policy keeps it.  ``invocations`` counts the invocations
    started since construction."""

    def __init__(self, soc: SoCConfig,
                 profiles: Sequence[AccProfile] | None = None,
                 seed: int = 0, flavor: str = "mixed", device=None):
        self.soc = soc
        self.device = resolve_device(device)
        rng = np.random.default_rng(seed)
        self.profiles = list(profiles) if profiles is not None else (
            resolve_profiles(soc.accelerators, rng, flavor))
        assert len(self.profiles) == soc.n_accs
        self.pmat = profile_matrix(self.profiles)
        self.static = SoCStatic.from_config(soc)
        self.perf_fn = _TimingModel(
            self.static, torch.as_tensor(self.pmat, device=self.device),
            soc.n_mem_tiles)
        self.geom = soc.geometry
        # Per-accelerator action masks (SoC3: some lack a private cache).
        self.masks = np.ones((soc.n_accs, N_MODES), bool)
        for i in soc.no_private_cache:
            self.masks[i, CoherenceMode.FULLY_COH] = False
        self._acc_t = [torch.tensor([i], dtype=torch.int32,
                                    device=self.device)
                       for i in range(soc.n_accs)]
        self.invocations = 0

    # ---------------------------------------------------------------- tiles
    def _tiles_for(self, rng: np.random.Generator,
                   footprint: float) -> np.ndarray:
        return stripe_tiles(rng, self.soc.n_mem_tiles, footprint)

    # ----------------------------------------------------------------- run
    def run(self, app: Application, policy: Policy, seed: int = 0,
            train: bool = True, cycle_time: float = 1e-8,
            weights: rewards.RewardWeights | None = None,
            faults: fault_mod.FaultSpec | None = None) -> RunResult:
        rng = np.random.default_rng(seed)
        n_tiles = self.soc.n_mem_tiles
        dev = self.device
        reward_state = rewards.init_reward_state(self.soc.n_accs, (1,),
                                                 device=dev)
        w = weights or rewards.PAPER_DEFAULT_WEIGHTS

        # Fault injection mirrors the batched environment: one uniform
        # draw from the spec's own key over the app's total invocation
        # count, indexed by a global invocation-start counter.  On
        # single-thread applications start order equals the compiled
        # schedule's row order, so the simulator sees the exact per-step
        # fault rows the batched episode consumes.
        fault_u = None
        if faults is not None:
            faults = faults.to(dev)
            n_total = sum(len(th.chain) * th.loops
                          for ph in app.phases for th in ph.threads)
            fault_u = fault_mod.sample_fault_uniforms(faults, n_total)
        inv_counter = 0

        phase_results: list[PhaseResult] = []
        decide_times: list[float] = []

        for phase in app.phases:
            now = 0.0
            active: dict[int, _Active] = {}       # thread_id -> in-flight
            completed_traffic = np.zeros(n_tiles, np.float64)
            records: list[InvocationRecord] = []
            # thread program counters
            progs: list[list[Invocation]] = []
            for th in phase.threads:
                seqs: list[Invocation] = []
                for _ in range(th.loops):
                    seqs.extend(th.chain)
                progs.append(seqs)
            pcs = [0] * len(progs)
            warm: list[float] = [1.0] * len(progs)  # data warm at phase start
            heap: list[tuple[float, int, int]] = []  # (time, seq, thread)
            seq = 0
            for t in range(len(progs)):
                heapq.heappush(heap, (0.0, seq, t)); seq += 1
            pending_start = set(range(len(progs)))
            # Device locking: an accelerator instance is serially shared —
            # the driver queues concurrent requests (paper §1: accelerators
            # are "shared among multiple cores on an as-needed basis").
            busy_until = [0.0] * self.soc.n_accs

            def ddr_counters(at: float) -> np.ndarray:
                """Continuous-counter model: completed + prorated in-flight."""
                out = completed_traffic.copy()
                for a in active.values():
                    frac = 0.0 if a.end <= a.start else np.clip(
                        (at - a.start) / (a.end - a.start), 0.0, 1.0)
                    out += a.offchip_per_tile * frac
                return out

            def footprint_map() -> np.ndarray:
                fp = np.zeros((self.soc.n_accs, n_tiles), np.float64)
                for a in active.values():
                    fp[a.acc_id][a.tiles] += a.footprint / a.tiles.sum()
                return fp

            while heap:
                now, _, tid = heapq.heappop(heap)
                if tid in active and tid not in pending_start:
                    # completion event for thread tid
                    a = active.pop(tid)
                    completed_traffic += a.offchip_per_tile
                    fp_map = footprint_map()
                    fp_map[a.acc_id][a.tiles] += a.footprint / a.tiles.sum()
                    ddr_after = ddr_counters(now)
                    delta = np.maximum(ddr_after - a.ddr_before, 0.0)
                    tot = fp_map.sum(axis=0)
                    share = np.divide(
                        fp_map[a.acc_id], np.maximum(tot, 1e-9))
                    attr = float((delta * share).sum())
                    meas = np.asarray(
                        [a.meas["exec_time"], a.meas["comm_cycles"],
                         a.meas["total_cycles"], attr, a.footprint],
                        np.float32)
                    mt = torch.from_numpy(meas).to(dev)
                    r, reward_state, _ = rewards.evaluate(
                        reward_state, self._acc_t[a.acc_id],
                        rewards.Measurement(*mt[:, None]), w)
                    r = float(r[0])
                    ctx = self._ctx(a.acc_id, a.footprint, a.state_idx,
                                    active, rng)
                    if train:
                        policy.observe_reward(ctx, a.mode, r)
                    records.append(InvocationRecord(
                        acc_id=a.acc_id,
                        acc_name=self.profiles[a.acc_id].name,
                        footprint=a.footprint, mode=a.mode,
                        state_idx=a.state_idx, start=a.start, end=now,
                        exec_time=a.meas["exec_time"],
                        offchip_true=float(a.offchip_per_tile.sum()),
                        offchip_attr=attr, reward=r))
                    # producer mode determines how warm the next stage's
                    # input is (NON_COH leaves data off-chip).
                    warm[tid] = self._warmth_after(a.mode, a.footprint)
                    pending_start.add(tid)
                    heapq.heappush(heap, (now, seq, tid)); seq += 1
                    continue

                # start event for thread tid
                if pcs[tid] >= len(progs[tid]):
                    pending_start.discard(tid)
                    continue
                inv = progs[tid][pcs[tid]]
                if busy_until[inv.acc_id] > now:
                    # instance busy: the driver queues us; retry at release
                    heapq.heappush(heap, (busy_until[inv.acc_id], seq, tid))
                    seq += 1
                    continue
                pending_start.discard(tid)
                pcs[tid] += 1
                tiles = self._tiles_for(rng, inv.footprint)
                state_idx = self._sense(inv, tiles, active)
                ctx = self._ctx(inv.acc_id, inv.footprint, state_idx,
                                active, rng, target_tiles=tiles,
                                warm=warm[tid])
                t0 = time.perf_counter()
                mode = int(policy.decide(ctx))
                decide_times.append(time.perf_counter() - t0)
                if (not self.masks[inv.acc_id][mode]
                        or not np.isfinite(inv.footprint)):
                    mode = _NC

                frow = None
                if faults is not None:
                    fr = fault_mod.fault_row(
                        faults, inv_counter, inv.acc_id,
                        fault_u[inv_counter])
                    frow = fault_mod.StepFault(*(v.reshape(1) for v in fr))
                inv_counter += 1
                self.invocations += 1
                packed = np.concatenate([
                    np.asarray([mode, inv.acc_id, inv.footprint, warm[tid]],
                               np.float32),
                    tiles.astype(np.float32), self._slots(active)])
                exec_t, comm_c, tot_c, off_acc, _ = (
                    float(v) for v in self.perf_fn(packed, frow))
                per_tile = np.zeros(n_tiles, np.float64)
                per_tile[tiles] = off_acc / tiles.sum()
                active[tid] = _Active(
                    acc_id=inv.acc_id, mode=mode, footprint=inv.footprint,
                    tiles=tiles, start=now, end=now + exec_t * cycle_time,
                    offchip_per_tile=per_tile,
                    meas={"exec_time": exec_t, "comm_cycles": comm_c,
                          "total_cycles": tot_c},
                    state_idx=state_idx,
                    ddr_before=ddr_counters(now))
                busy_until[inv.acc_id] = active[tid].end
                heapq.heappush(heap, (active[tid].end, seq, tid)); seq += 1

            offchip = float(completed_traffic.sum())
            phase_results.append(PhaseResult(
                name=phase.name, wall_time=now, offchip_accesses=offchip,
                invocations=records))

        return RunResult(
            policy=policy.name, phases=phase_results,
            decide_overhead_s=(float(np.mean(decide_times))
                               if decide_times else 0.0))

    # ------------------------------------------------------------- serving
    def serve(self, sched, policy: Policy, arrivals, *,
              queue_cap: int = 8, backoff: float = 0.0,
              prio_reserve: float = 0.0, overload_frac: float = 0.0,
              pressure_beta: float = 0.05, max_retries: int = 3,
              train: bool = False,
              weights: rewards.RewardWeights | None = None,
              faults: fault_mod.FaultSpec | None = None,
              seed: int = 0) -> list:
        """Host mirror of the batched serving loop (``vecenv.ServeEnv``).

        Consumes a compiled :class:`~repro_torch.soc.vecenv.Schedule` and
        a presampled :class:`~repro_torch.soc.traffic.Arrivals` table —
        the table the batched path scans, so both see the same offered
        traffic — and replays it request by request through this
        simulator's timing model: bounded per-accelerator admission rings
        of ``queue_cap`` finish times, deadline shedding after
        ``max_retries`` exponentially backed-off attempts,
        priority-weighted effective capacity, and the shed-pressure
        overload latch forcing NON_COH.

        Fault rows index by offered-request position (executed or shed),
        as the batched path's ``sample_fault_arrays`` over the request
        stream does.  Requests run in arrival order with the
        per-accelerator slot table carrying each device's last admitted
        invocation: the batched path's concurrency approximation, so the
        two compare like with like.  The serving state (rings, slot
        table, latch) is host numpy float64; times are cycles.

        Returns a list of per-request record dicts (arrival, admission
        outcome, start/finish, exec cycles, reward)."""
        host = lambda t: t.cpu().numpy() if torch.is_tensor(t) else \
            np.asarray(t)
        s_acc, s_fp, s_tiles = (host(sched.acc_id), host(sched.footprint),
                                host(sched.tiles))
        a_t, a_row, a_dl, a_pr, a_ten = (
            host(arrivals.t_arr), host(arrivals.row),
            host(arrivals.deadline), host(arrivals.priority),
            host(arrivals.tenant))
        n_accs = self.soc.n_accs
        n_tiles = self.soc.n_mem_tiles
        n = int(a_t.shape[0])
        dev = self.device
        w = weights or rewards.PAPER_DEFAULT_WEIGHTS
        reward_state = rewards.init_reward_state(n_accs, (1,), device=dev)
        rng = np.random.default_rng(seed)

        fault_u = None
        if faults is not None:
            faults = faults.to(dev)
            fault_u = fault_mod.sample_fault_uniforms(faults, n)

        # Per-accelerator serving state (the ServeCarry, host-side).
        busy = np.zeros(n_accs)
        fin = np.zeros((n_accs, queue_cap))
        head = np.zeros(n_accs, np.int64)
        slot_mode = np.full(n_accs, -1, np.int64)
        slot_fp = np.zeros(n_accs)
        slot_tiles = np.zeros((n_accs, n_tiles), bool)
        pressure, tripped = 0.0, False

        records: list[dict] = []
        for i in range(n):
            row = int(a_row[i])
            acc = int(s_acc[row])
            t_a = float(a_t[i])
            dl = float(a_dl[i])
            pr = float(a_pr[i])
            footprint = float(s_fp[row])
            tiles = np.asarray(s_tiles[row], bool)

            # ---- admission: bounded retry-with-backoff ----------------
            cap_eff = queue_cap - prio_reserve * queue_cap * (1.0 - pr)
            executed, attempt, start = False, max_retries + 1, 0.0
            for r in range(max_retries + 1):
                t_r = t_a + backoff * (2.0 ** r - 1.0)
                depth_r = float((fin[acc] > t_r).sum())
                s_r = max(t_r, busy[acc])
                if depth_r < cap_eff and s_r <= dl:
                    executed, attempt, start = True, r, s_r
                    break
            degraded = tripped
            rec = {"t_arr": t_a, "acc_id": acc, "tenant": int(a_ten[i]),
                   "executed": executed, "retries": attempt,
                   "depth": float((fin[acc] > t_a).sum()),
                   "degraded": bool(degraded and executed),
                   "mode": -1, "state_idx": -1, "start": 0.0,
                   "finish": 0.0, "exec_time": 0.0, "latency": 0.0,
                   "reward": 0.0}

            if executed:
                # ---- sense against each device's last admitted work ---
                omask = busy > start
                omask[acc] = False
                omask &= slot_mode >= 0
                idx = np.nonzero(omask)[0]
                o_modes = [int(slot_mode[j]) for j in idx]
                o_fps = [float(slot_fp[j]) for j in idx]
                state_idx = cstate.observe_host(
                    active_modes=o_modes, active_footprints=o_fps,
                    needed_tiles=[slot_tiles[j] for j in idx],
                    target_tiles=tiles, target_footprint=footprint,
                    geom=self.geom, device=dev)
                ctx = DecisionContext(
                    acc_id=acc, acc_name=self.profiles[acc].name,
                    footprint=footprint, state_idx=state_idx,
                    active_modes=o_modes,
                    active_footprint=float(slot_fp[idx].sum()),
                    available=self.masks[acc].tolist(),
                    soc=self.soc, rng=rng, active_footprints=o_fps,
                    target_tiles=tiles, profile=self.pmat[acc],
                    warm=1.0, slack=dl - t_a,
                    reuse=t_a - float(busy[acc]))
                mode = int(policy.decide(ctx))
                if degraded:
                    # graceful overload degradation (the serve step's rule)
                    mode = _NC
                if not self.masks[acc][mode] or not np.isfinite(footprint):
                    mode = _NC

                frow = None
                if faults is not None:
                    fr = fault_mod.fault_row(faults, i, acc, fault_u[i])
                    frow = fault_mod.StepFault(*(v.reshape(1) for v in fr))
                # the other devices' last admitted work, in accelerator
                # order, as the timing model's slots
                slots = np.zeros((MAX_SLOTS, 3 + n_tiles), np.float32)
                slots[:, 0] = -1.0
                for k, j in enumerate(idx[:MAX_SLOTS]):
                    slots[k, 0] = slot_mode[j]
                    slots[k, 1] = j
                    slots[k, 2] = slot_fp[j]
                    slots[k, 3:] = slot_tiles[j]
                self.invocations += 1
                packed = np.concatenate([
                    np.asarray([mode, acc, footprint, 1.0], np.float32),
                    tiles.astype(np.float32), slots.reshape(-1)])
                out = self.perf_fn(packed, frow)
                exec_t = float(out[0])
                finish = start + exec_t
                meas = np.asarray([out[0], out[1], out[2], out[3],
                                   footprint], np.float32)
                mt = torch.from_numpy(meas).to(dev)
                r, reward_state, _ = rewards.evaluate(
                    reward_state, self._acc_t[acc],
                    rewards.Measurement(*mt[:, None]), w)
                r = float(r[0])
                if train:
                    policy.observe_reward(ctx, mode, r)
                fin[acc][head[acc]] = finish
                head[acc] = (head[acc] + 1) % queue_cap
                busy[acc] = finish
                slot_mode[acc] = mode
                slot_fp[acc] = footprint
                slot_tiles[acc] = tiles
                rec.update(mode=mode, state_idx=state_idx, start=start,
                           finish=finish, exec_time=exec_t,
                           latency=finish - t_a, reward=r)

            # ---- overload watchdog (EMA of the shed indicator) --------
            pressure = ((1.0 - pressure_beta) * pressure
                        + pressure_beta * (0.0 if executed else 1.0))
            if overload_frac > 0.0 and pressure > overload_frac:
                tripped = True
            elif pressure < 0.5 * overload_frac:
                tripped = False
            records.append(rec)
        return records

    # ------------------------------------------------------------- helpers
    def _warmth_after(self, mode: int, footprint: float) -> float:
        """:func:`repro_torch.soc.memsys.warmth_after` of one invocation,
        in float32 on the host."""
        if mode == _NC:
            return 0.0
        cap = np.float32(self.soc.llc_total_bytes
                         + self.soc.n_cpus * self.soc.l2_bytes)
        return float(min(np.float32(1.0),
                         cap / max(np.float32(footprint), np.float32(1.0))))

    def _slots(self, active: dict[int, _Active]) -> np.ndarray:
        """The concurrent set as the timing model's ``MAX_SLOTS`` rows of
        ``[mode, acc_id, footprint, tiles]`` (float32; mode -1 marks an
        inactive slot)."""
        n_tiles = self.soc.n_mem_tiles
        rows = np.zeros((MAX_SLOTS, 3 + n_tiles), np.float32)
        rows[:, 0] = -1.0
        for i, a in enumerate(list(active.values())[:MAX_SLOTS]):
            rows[i, 0] = a.mode
            rows[i, 1] = a.acc_id
            rows[i, 2] = a.footprint
            rows[i, 3:] = a.tiles
        return rows.reshape(-1)

    def _sense(self, inv: Invocation, tiles: np.ndarray,
               active: dict[int, _Active]) -> int:
        return cstate.observe_host(
            active_modes=[a.mode for a in active.values()],
            active_footprints=[a.footprint for a in active.values()],
            needed_tiles=[a.tiles for a in active.values()],
            target_tiles=tiles,
            target_footprint=inv.footprint,
            geom=self.geom, device=self.device)

    def _ctx(self, acc_id: int, footprint: float, state_idx: int,
             active: dict[int, _Active], rng, *, target_tiles=None,
             warm: float = 1.0, slack: float = 0.0,
             reuse: float = 0.0) -> DecisionContext:
        return DecisionContext(
            acc_id=acc_id,
            acc_name=self.profiles[acc_id].name,
            footprint=footprint,
            state_idx=state_idx,
            active_modes=[a.mode for a in active.values()],
            active_footprint=sum(a.footprint for a in active.values()),
            available=self.masks[acc_id].tolist(),
            soc=self.soc,
            rng=rng,
            active_footprints=[a.footprint for a in active.values()],
            target_tiles=target_tiles,
            profile=self.pmat[acc_id],
            warm=warm, slack=slack, reuse=reuse)
