"""The serve kernel's lane-parallel admission (K2/K2f, ``csrc/soc_step.cu``)
emulated on the CPU and held against ``ref.serve_step``'s serial
admission, and the serve kernel's plan and chain bound.

The kernel gives lane k slot k of the accelerator's finish-time ring (k +
32, ... past 32), counts the slots past the arrival and each retry time
with ``__popc(__ballot_sync(...))`` and takes the first admissible retry
with ``__ffs``; :func:`lane_admission` does the same, one 32-bit mask a
word of slots, in float32 where the kernel computes in float32.  Over a
seeded grid of rings (ties with the retry times included), busy times,
deadlines, priorities, reserves, backoffs and ring sizes (one word and
two), the queue depth, retries, admission and start time must equal the
plain version's bitwise.
"""
import numpy as np
import pytest
import torch

from repro_torch import random as prng
from repro_torch.core import qlearn, rewards
from repro_torch.kernels.soc_step import coverage, kernel, ref
from repro_torch.soc import traffic, vecenv
from repro_torch.soc.apps import make_application
from repro_torch.soc.config import SOCS

F32 = np.float32
MAX_RETRIES = 3


def _popc(x: int) -> int:
    return bin(x).count("1")


def lane_admission(frow, busy_a, t_arr, deadline, priority, backoff,
                   prio_reserve):
    """One stream's admission as the kernel's warp computes it: returns
    ``(executed, attempt, start, depth0)`` (attempt -1 when shed)."""
    qcap = frow.shape[0]
    qc = F32(qcap)
    cap_eff = qc - F32(prio_reserve) * qc * (F32(1.0) - F32(priority))
    t_r = [F32(t_arr) + F32(backoff) * F32((1 << a) - 1)
           for a in range(MAX_RETRIES + 1)]

    def count(t):
        n = 0
        for k0 in range(0, qcap, 32):   # one ballot a word of 32 slots
            bits = 0
            for lane in range(32):
                k = k0 + lane
                if k < qcap and frow[k] > t:
                    bits |= 1 << lane
            n += _popc(bits)
        return n

    okm, start, start0 = 0, F32(0.0), F32(0.0)
    for a in range(MAX_RETRIES, -1, -1):
        start_r = max(t_r[a], F32(busy_a))
        ok = (F32(count(t_r[a])) < cap_eff) and (start_r <= F32(deadline))
        okm |= (1 << a) if ok else 0
        start = start_r if ok else start
        if a == 0:
            start0 = start_r
    executed = okm != 0
    attempt = (okm & -okm).bit_length() - 1   # __ffs(okm) - 1
    if not executed:
        start = start0
    return executed, attempt, start, F32(count(F32(t_arr)))


def _grid(n: int, qcap: int, seed: int):
    """``n`` streams of one accelerator's state and one request each."""
    rng = np.random.default_rng(seed)
    backoff = rng.choice(F32([0.0, 1.0, 37.5, 400.25]), n)
    t_arr = F32(1000.0) + rng.integers(0, 50, n).astype(F32)
    span = np.maximum(backoff, F32(1.0)) * F32(8.0)
    fin = (t_arr[:, None] + rng.uniform(-1.0, 1.0, (n, qcap)).astype(F32)
           * span[:, None]).astype(F32)
    # ties: some slots exactly at the arrival or a retry time
    tie = rng.random((n, qcap)) < 0.2
    which = rng.integers(0, MAX_RETRIES + 1, (n, qcap))
    retry_t = (t_arr[:, None] + backoff[:, None]
               * ((1 << which) - 1).astype(F32)).astype(F32)
    fin = np.where(tie, retry_t, fin).astype(F32)
    fin[rng.random(n) < 0.1] = F32(0.0)          # empty rings
    busy = (t_arr + rng.uniform(-2.0, 10.0, n).astype(F32)
            * np.maximum(backoff, F32(1.0))).astype(F32)
    deadline = (t_arr + rng.uniform(-1.0, 9.0, n).astype(F32)
                * np.maximum(backoff, F32(1.0))).astype(F32)
    priority = rng.choice(F32([0.25, 0.5, 1.0]), n)
    reserve = rng.choice(F32([0.0, 0.25, 1.0]), n)
    return fin, busy, t_arr, deadline, priority, backoff, reserve


@pytest.mark.parametrize("qcap,seed", [(1, 0), (4, 1), (8, 2), (8, 3),
                                       (31, 4), (40, 5)])
def test_lane_admission_matches_serial_serve_step(qcap, seed):
    """The emulated lane-parallel admission against ``ref.serve_step``'s
    serial one on 48 streams: executed, retries, depth and start time
    bitwise."""
    n = 48
    soc = SOCS["SoC1"]
    env = vecenv.VecEnv(soc, seed=1, device="cpu")
    app = vecenv.compile_app(make_application(soc, seed=50, n_phases=2),
                             soc, seed=4)
    sched = app.schedule
    specs = vecenv.stack_specs(
        [vecenv.fixed_policy_spec(env.params, sched, 0)] * n)
    tspec = traffic.bursty(1e-4, mix=(0.7, 0.3), deadline=(6000.0, 0.0),
                           priority=(1.0, 0.25), backoff=1.0,
                           overload_frac=0.35, prio_reserve=0.25, seed=3,
                           device="cpu")
    arr = traffic.sample_arrivals(tspec, 1, sched.acc_id.shape[0])
    xs = vecenv.serve_inputs(env.params, sched, specs, arr,
                             prng.PRNGKey(np.arange(n), device="cpu"))
    fin, busy, t_arr, deadline, priority, backoff, reserve = _grid(
        n, qcap, seed)
    acc = xs.acc_id[:, 0].long()
    qs0 = specs.qstate
    carry0 = ref.init_serve_carry(
        qs0.qtable,
        rewards.init_reward_state(soc.n_accs, (n,), "cpu").extrema,
        soc.n_accs, soc.n_mem_tiles, qcap, qs0.step)
    ar = torch.arange(n)
    carry0.fin[ar, acc] = torch.from_numpy(fin)
    carry0.busy[ar, acc] = torch.from_numpy(busy)
    sp = vecenv.serve_params(qlearn.QConfig(decay_steps=200), qs0.frozen,
                             tspec)
    sp = sp._replace(backoff=torch.from_numpy(backoff),
                     prio_reserve=torch.from_numpy(reserve))
    col = lambda v: torch.from_numpy(v)[:, None]
    _, y = ref.serve_episode_ref(env.static, specs.learned,
                                 rewards.PAPER_DEFAULT_WEIGHTS, sp, carry0,
                                 xs, col(t_arr), col(deadline),
                                 col(priority))
    y = y[:, 0].numpy()
    c = {name: i for i, name in enumerate(ref.SERVE_YCOLS)}
    n_exec = 0
    for b in range(n):
        executed, attempt, start, depth0 = lane_admission(
            fin[b], busy[b], t_arr[b], deadline[b], priority[b], backoff[b],
            reserve[b])
        n_exec += executed
        assert y[b, c["executed"]] == F32(executed), b
        assert y[b, c["retries"]] == F32(attempt if executed
                                         else MAX_RETRIES + 1), b
        assert y[b, c["depth"]] == depth0, b
        assert y[b, c["start"]] == start * F32(executed), b
    assert 0 < n_exec < n   # the grid admits some requests and sheds some


def test_serve_plan_ring_and_bytes():
    """The serve kernel's ring: 32 requests where S allows, S below that,
    halved until the block fits; the bytes count every word
    ``serve_words`` counts."""
    soc = SOCS["SoC1"]
    args = (soc.n_mem_tiles, 9, 4, 243, soc.n_accs, 8)
    assert kernel.serve_plan(*args, 1024).ring == 32
    assert kernel.serve_plan(*args, 5).ring == 5
    assert kernel.serve_plan(*args, 1).ring == 1
    p32, p16 = kernel.serve_plan(*args, 32), kernel.serve_plan(*args, 16)
    nf = 4 + soc.n_mem_tiles + soc.n_accs + 9 + 12
    assert p32.smem_bytes - p16.smem_bytes == 4 * 16 * (2 * (nf + 8) + 13)
    f = kernel.serve_plan(*args, 32, faulted=True)
    assert f.smem_bytes - p32.smem_bytes == 4 * 2 * 32 * 4
    big = kernel.serve_plan(soc.n_mem_tiles, 9, 4, 243, 64, 820, 1024)
    assert big.ring < 32 and big.smem_bytes <= kernel.SMEM_LIMIT
    with pytest.raises(ValueError):
        kernel.serve_plan(soc.n_mem_tiles, 9, 4, 243, 65, 8, 10)


def test_serve_chain_adds_the_admission_to_the_step():
    """A request's chain is the episode step's over n_accs slots plus the
    admission's ring read, ballot, start time and ring write."""
    for na, nt, ddr in ((7, 4, False), (7, 4, True), (16, 2, False)):
        step = kernel.chain_ops(na, nt, 4, ddr=ddr)
        req = kernel.serve_chain_ops(na, nt, 4, ddr=ddr)
        extra = {k: req[k] - step[k] for k in req}
        assert extra == dict(add=5, mul=0, div=0, log=0, tmin=1, smem=2,
                             shfl=1, sync=2)
        assert (kernel.serve_chain_cycles(na, nt, 4, ddr=ddr)
                > kernel.chain_cycles(na, nt, 4, ddr=ddr))


@pytest.mark.parametrize("seed,faulted", [(0, False), (1, False),
                                          (2, True)])
def test_serve_edge_case_reaches_its_edges(seed, faulted):
    """Each stream of ``coverage.serve_edge_case`` drives the edge it is
    named for, in the plain version: a full queue and a priority reserve
    (depth at the ring's size, most requests shed), admissions after one,
    two and three retries beside shed requests, every request whose
    deadline lies before its arrival shed, and the watchdog tripping,
    releasing and tripping again."""
    c = coverage.serve_edge_case(seed=seed, faulted=faulted)
    carry, y = ref.serve_episode_ref(c.static, c.learned, c.weights, c.sp,
                                     c.carry0, c.xs, c.t_arr, c.deadline,
                                     c.priority)
    col = {n: i for i, n in enumerate(ref.SERVE_YCOLS)}
    retries = y[..., col["retries"]].long()
    executed = y[..., col["executed"]]
    degraded = y[..., col["degraded"]]
    assert y[0, :, col["depth"]].max() == 2.0
    assert executed[0].mean() < 0.5
    hist = torch.bincount(retries[1], minlength=MAX_RETRIES + 2)
    assert (hist > 0).all(), hist
    missed = c.deadline[2] < c.t_arr[2]
    assert missed.any() and (executed[2][missed] == 0).all()
    d3 = degraded[3]
    rises = ((d3[1:] == 1) & (d3[:-1] == 0)).sum()
    falls = ((d3[1:] == 0) & (d3[:-1] == 1)).sum()
    assert rises >= 2 and falls >= 1
    assert carry.step[3] < (executed[3] == 1).sum()   # the rewinds
