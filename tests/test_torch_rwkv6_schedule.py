"""The RWKV-6 scan kernel's schedule (K5, ``kernels/rwkv6_scan/csrc/
rwkv6_scan.cu``) emulated in plain PyTorch on the CPU and held against
the port's step-by-step ``wkv_ref`` and the reference's
``repro.kernels.rwkv6_scan.ref.wkv_ref`` at rtol = atol = 2e-5.

:func:`schedule_scan` does what a block of the kernel does for its head,
in float64: per chunk of 16 rows, the cumsum as two halves of eight rows
(the second half starting from the first's sum), the two exponentials of
each element once, A as its two 16 x 8 column tiles over the 8-column
tiles of k in two chains (even and odd tiles), strictly causal with the
bonus on the diagonal, then the chain: y = (A v + q S over the even k
tiles) + q S over the odd ones, with the state's tiles as the tensor
core's A operand, and S = (S + k_in^T v) e^{cum_end}.  The layout claims
of the source (padded row strides, the fewest shared-memory wavefronts
for every operand load of a warp) are checked beside it, and the
coverage probe's inputs make the emulation exact.
"""
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_scan import ref as jref
from repro_torch.kernels.rwkv6_scan import coverage
from repro_torch.kernels.rwkv6_scan import ops as rw_ops
from repro_torch.kernels.rwkv6_scan.ref import wkv_ref

TOL = dict(rtol=2e-5, atol=2e-5)
CHUNK = 16


def schedule_scan(r, k, v, logw, u, s0):
    """The kernel's schedule, float64 throughout, rounded to float32 at
    the end: returns ``(y (B, H, T, K), s_final (B, H, K, K))``."""
    b, h, t_len, kd = r.shape
    d = torch.float64
    uk = (u[None, :, None, :] * k).to(d)     # the float32 product, as the
    r, k, v, logw = (x.to(d) for x in (r, k, v, logw))   # kernel's
    s = s0.to(d)
    tiles = [slice(8 * i, 8 * i + 8) for i in range(kd // 8)]
    ys = []
    for c0 in range(0, t_len, CHUNK):
        rows = slice(c0, c0 + CHUNK)
        # the cumsum: two halves of eight rows, the second from the first's
        # sum
        lw = logw[:, :, rows].reshape(b, h, 2, 8, kd)
        loc = torch.zeros_like(lw)
        run = torch.zeros_like(lw[:, :, :, 0])
        for i in range(8):
            run = run + lw[:, :, :, i]
            loc[:, :, :, i] = run
        pre = torch.stack([torch.zeros_like(run[:, :, 0]), run[:, :, 0]], 2)
        incl = (pre[:, :, :, None] + loc).reshape(b, h, CHUNK, kd)
        excl = torch.cat([pre[:, :, :, None],
                          pre[:, :, :, None] + loc[:, :, :, :7]],
                         dim=3).reshape(b, h, CHUNK, kd)
        q = r[:, :, rows] * torch.exp(excl)
        kin = k[:, :, rows] * torch.exp(-incl)
        eend = torch.exp(incl[:, :, -1])
        # A: two 16 x 8 column tiles, two chains over the k tiles; strictly
        # causal; the bonus on the diagonal
        chains = [sum(q[..., tiles[i]] @ kin[..., tiles[i]].transpose(-1, -2)
                      for i in range(c, kd // 8, 2)) for c in (0, 1)]
        a = torch.tril(chains[0] + chains[1], -1)
        bonus = (r[:, :, rows] * uk[:, :, rows]).sum(-1)
        a = a + torch.diag_embed(bonus)
        vv = v[:, :, rows]
        ya = a @ vv + sum(q[..., tiles[i]] @ s[:, :, tiles[i]]
                          for i in range(0, kd // 8, 2))
        yb = sum(q[..., tiles[i]] @ s[:, :, tiles[i]]
                 for i in range(1, kd // 8, 2))
        ys.append(ya + yb)
        s = (s + kin.transpose(-1, -2) @ vv) * eend[..., None]
    y = torch.cat(ys, dim=2) if ys else torch.zeros_like(v)
    return y.to(torch.float32), s.to(torch.float32)


def _inputs(shape, state, seed=0):
    b, h, t, kd = shape
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    r, k, v = mk(b, h, t, kd), mk(b, h, t, kd), mk(b, h, t, kd)
    logw = torch.clamp(-torch.exp(0.5 * mk(b, h, t, kd)), min=-4.0)
    u = mk(h, kd)
    s0 = mk(b, h, kd, kd) if state else torch.zeros((b, h, kd, kd))
    return r, k, v, logw, u, s0


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("shape", [(1, 2, 48, 16), (2, 2, 64, 32),
                                   (1, 3, 48, 64), (1, 1, 160, 64)])
def test_schedule_matches_both_plain_versions(shape, state):
    """The emulated schedule against the port's and the reference's
    step-by-step scans, at every head dim, from a zero and a random
    state, over whole and several chunks."""
    r, k, v, logw, u, s0 = _inputs(shape, state)
    y, s_fin = schedule_scan(r, k, v, logw, u, s0)
    y_p, s_p = wkv_ref(r, k, v, logw, u, s0)
    y_j, s_j = jref.wkv_ref(*(x.numpy() for x in (r, k, v, logw, u, s0)))
    for got, want in ((y, y_p), (s_fin, s_p), (y, y_j), (s_fin, s_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("k,t,state", [c for c in coverage.probe_cases()
                                       if c[1] <= 48])
def test_schedule_is_exact_on_the_coverage_probe(k, t, state):
    """On the probe's integer inputs the schedule (sums in its own order,
    in double) equals the float32 step-by-step scan bitwise, and so does
    the port's CPU path."""
    args = coverage.probe_inputs(2, 2, t, k, state=state)
    want = wkv_ref(*args)
    got = schedule_scan(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    cpu = rw_ops.rwkv6_scan(*args)
    assert all(torch.equal(g, w) for g, w in zip(cpu, want))


def test_coverage_probe_reaches_every_term():
    """The probe's results move with each input: a row of k, of v or of
    the initial state changed by one changes y (so a kernel that dropped
    it would not pass), and its magnitudes stay far below 2^24."""
    args = list(coverage.probe_inputs(1, 1, 48, 16, state=True, seed=3))
    y, s = wkv_ref(*args)
    assert y.abs().max() < 2 ** 20 and s.abs().max() < 2 ** 20
    for which, idx in ((1, (0, 0, 17, 5)), (2, (0, 0, 31, 2)),
                       (5, (0, 0, 4, 9))):
        moved = [a.clone() for a in args]
        moved[which][idx] += 1.0
        y2, _ = wkv_ref(*moved)
        assert not torch.equal(y, y2)


def _wavefronts(word_addrs):
    """Shared-memory wavefronts of one warp's load: the most distinct
    4-byte words any of the 32 banks must deliver."""
    banks = {}
    for w in word_addrs:
        banks.setdefault(w % 32, set()).add(w)
    return max(len(s) for s in banks.values())


@pytest.mark.parametrize("K", [16, 32, 64])
def test_operand_loads_take_the_fewest_wavefronts(K):
    """With q and k_in rows padded to K + 4 doubles, A's rows to 16 + 4
    and the staged float rows to K + 8, every operand load of a warp in
    the source takes the fewest shared-memory wavefronts its bytes need:
    two for a double a lane, four for the y product's two adjacent
    doubles a lane, one for a float a lane; lane (g, j) = (lane / 4,
    lane % 4) as in the tensor core's fragments."""
    qs, as_, fs = K + 4, CHUNK + 4, K + 8
    lanes = [(lane >> 2, lane & 3) for lane in range(32)]
    dbl = lambda pos: (2 * pos, 2 * pos + 1)   # a double's two words
    loads = []
    for i in range(K // 8):
        for m in range(4):
            # A's tiles: q[g + 8 (m & 1)][8i + j + 4 (m >> 1)], k_in alike
            loads.append([w for g, j in lanes for w in dbl(
                (g + 8 * (m & 1)) * qs + 8 * i + j + 4 * (m >> 1))])
            # the state update: k_in[j + 4m][8i + g]
            loads.append([w for g, j in lanes
                          for w in dbl((j + 4 * m) * qs + 8 * i + g)])
    for tt in range(2):
        for m in range(4):
            # A v: A[8 tt + g][j + 4m]
            loads.append([w for g, j in lanes
                          for w in dbl((8 * tt + g) * as_ + j + 4 * m)])
    assert all(_wavefronts(ld) == 2 for ld in loads)
    for i in range(K // 8):
        for tt in range(2):
            # y: q[8 tt + g][8i + 2j .. +1], 16 bytes a lane
            words = [w for g, j in lanes for p in (0, 1)
                     for w in dbl((8 * tt + g) * qs + 8 * i + 2 * j + p)]
            assert _wavefronts(words) == 4
    for w0 in range(0, K, 16):
        for m in range(8):
            # v^T's fragment: v[j + 4 (m >> 1)][v0 + g + 8 (m & 1)]
            assert _wavefronts([(j + 4 * (m >> 1)) * fs + w0 + g + 8 * (m & 1)
                                for g, j in lanes]) == 1
