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
from repro_torch.soc import nn as socnn, traffic, vecenv
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


@pytest.mark.parametrize("mlp_dims", [(14, 16, 16, 4), (243, 16, 16, 4),
                                      (14, 64, 64, 64, 4)])
def test_serve_plan_runs_k2m_in_two_warps(mlp_dims):
    """K2m's block: a step warp and a network warp (64 threads, the
    table instantiations one warp); its words are the table stream's plus
    the network's (``serve_words``: the MLP sense sums, the pack, the
    layers' outputs, two backward rows) and the handoff's (two requests'
    inputs, action and reward), and the two consts [qfun, mlp_lr]."""
    soc = SOCS["SoC1"]
    na = soc.n_accs
    args = (soc.n_mem_tiles, 9, 4, 243, na, 8, 32)
    table = kernel.serve_plan(*args)
    assert table.threads == 32
    m = kernel.serve_plan(*args, mlp_dims=mlp_dims)
    assert m.threads == 64
    rows, cols = socnn.pack_shape(mlp_dims)
    tp = -(-na // 32) * 32 + 1
    net = rows * cols + sum(mlp_dims) + 2 * kernel.MAX_WIDTH
    assert kernel.NET_WORDS == 2 * 11 + 2
    if m.ring == table.ring:
        assert m.smem_bytes - table.smem_bytes == 4 * (
            2 + kernel.N_MLP_SUMS * (tp + 1) + net + kernel.NET_WORDS)
    assert m.smem_bytes <= kernel.SMEM_LIMIT
    assert kernel.serve_plan(*args, faulted=True,
                             mlp_dims=mlp_dims).threads == 64


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


@pytest.mark.parametrize("faulted", [False, True])
@pytest.mark.parametrize("net", coverage.SERVE_MLP_NETS)
def test_serve_mlp_edge_case_reaches_its_edges(net, faulted):
    """Each stream of ``coverage.serve_mlp_edge_case`` drives the edge it
    is named for, in the plain version: the watchdog trips and releases
    (so every network is gated off and on again), the learning network's
    pack moves and the frozen copy's and the placeholders' stay bitwise,
    the table stream learns its table, NON_COH serves NON_COH, and the
    stream with a +inf NON_COH value takes NON_COH on every request it
    decides and never updates (its delta is not finite).  The paths'
    sense network runs K2m's register path, the others its
    shared-memory path."""
    mc = coverage.serve_mlp_edge_case(net, seed=1, faulted=faulted)
    c = mc.case
    dims = tuple(socnn.mlp_dims(mc.mlp.cfg))
    assert kernel.serve_net_in_registers(dims) == (net == "sense")
    if net == "onehot":
        assert dims[0] == 243
    if net == "widest":
        w = dims[1]
        assert w > 2 * kernel.WARP and len(dims) == 5
        with pytest.raises(ValueError):
            kernel.serve_plan(2, c.xs.profile.shape[-1], 4, 243, 12, 2, 96,
                              faulted=True,
                              mlp_dims=(14, w + 1, w + 1, w + 1, 4))
    carry, y = ref.serve_episode_ref(
        c.static, c.learned, c.weights, c.sp, c.carry0, c.xs, c.t_arr,
        c.deadline, c.priority, qfun=mc.qfun, mlp_lr=mc.mlp.lr,
        mlp_dims=dims, mlp_feats=mc.mlp.cfg.features)
    col = {n: i for i, n in enumerate(ref.SERVE_YCOLS)}
    executed = y[..., col["executed"]] == 1
    degraded = y[..., col["degraded"]] == 1
    for s in range(len(coverage.SERVE_MLP_EDGES)):
        d = degraded[s].int()
        assert ((d[1:] - d[:-1]) == 1).sum() >= 1, s      # trips
        assert ((d[1:] - d[:-1]) == -1).sum() >= 1, s     # releases
    decided = executed & ~degraded
    assert decided[0].sum() > 10 and decided[4].sum() > 10
    w0 = c.carry0.wpack
    assert not torch.equal(carry.wpack[0], w0[0])
    for s in (1, 2, 3, 4):
        assert torch.equal(carry.wpack[s], w0[s]), s
    assert not torch.equal(carry.qtable[2], c.carry0.qtable[2])
    assert (y[3, executed[3], col["mode"]] == 0).all()
    assert (y[4, decided[4], col["action"]] == 0).all()
    assert torch.isinf(w0[4]).sum() == 1


@pytest.mark.parametrize("na,nt,ddr", [(7, 4, False), (7, 4, True),
                                       (12, 2, False)])
def test_k2m_chain_overlaps_the_update_with_the_next_request(na, nt, ddr):
    """K2m's chain (a network warp beside the step warp) is the longer of
    the step warp's loop (the admission and the step up to the
    observation, the handoffs, features, forward, Q-row read, selection
    and pick) and the network warp's (the TD update, then the next
    request's handoff, features, forward, Q-row, selection, pick and the
    action's handoff); the one-warp body's ran everything in a row
    (1,857 cycles at SoC1's shape, Fig. 11), so the new count is shorter
    and at least the table stream's."""
    dims = (14, 16, 16, 4)
    # the one-warp body's count: the admission, then the step with its
    # network, every piece in a row
    serial = kernel.chain_ops(na, nt, 4, ddr=ddr, mlp_dims=dims)
    old = sum(n * kernel.LATENCY[k] for k, n in serial.items()) + sum(
        n * kernel.LATENCY[k] for k, n in kernel.ADMISSION.items())
    new = kernel.serve_chain_cycles(na, nt, 4, ddr=ddr, mlp_dims=dims)
    table = kernel.serve_chain_cycles(na, nt, 4, ddr=ddr)
    assert table < new < old
    # without a network the serve chain is the admission and the step
    assert kernel.serve_chain_ops(na, nt, 4, ddr=ddr) == {
        k: v + kernel.ADMISSION.get(k, 0)
        for k, v in kernel.chain_ops(na, nt, 4, ddr=ddr).items()}
    if (na, nt, ddr) == (7, 4, False):
        assert old == pytest.approx(1856.75)
    # the register forward trades each layer's shared load and __syncwarp
    # for one shuffle; a network in shared memory keeps them
    regs = kernel.serve_chain_ops(na, nt, 4, ddr=ddr, mlp_dims=dims)
    wide = kernel.serve_chain_ops(na, nt, 4, ddr=ddr,
                                  mlp_dims=(14, 16, 16, 16, 4))
    assert wide["smem"] > regs["smem"] and wide["sync"] > regs["sync"]
    assert kernel.serve_net_in_registers(dims)
    assert not kernel.serve_net_in_registers((14, 16, 16, 16, 4))
