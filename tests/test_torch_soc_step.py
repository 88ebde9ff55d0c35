"""The port's soc_step episode (plain PyTorch version and CUDA kernel)
against repro's reference scan and its interpreted Pallas kernel.

Case: ``tests/test_soc_step_kernel.py``'s ``_soc_step_case`` at batch
B=3 with a different reward weighting per row, for the three
(ddr_attribution, gated, learned) combinations.  Integer traces must match
exactly; floats and Q-tables are held to rtol=atol=2e-5, the bound of the
reference's own kernel test (measured gap: bitwise on 8 of 9 rows, one
ULP on the reward of one row, 6e-8 absolute).
"""
import numpy as np
import pytest
import torch

from repro.core import rewards as jr
from repro.kernels.soc_step import ops as jops
from repro_torch.core import rewards as tr
from repro_torch.kernels.soc_step import kernel as tkernel
from repro_torch.kernels.soc_step import ops as tops
from repro_torch.kernels.soc_step import ref as tref
from repro_torch.soc.memsys import SoCStatic
from test_soc_step_kernel import _soc_step_case

TOL = dict(rtol=2e-5, atol=2e-5)
WEIGHTS = [(0.675, 0.075, 0.25), (0.125, 0.125, 0.75), (0.4, 0.4, 0.2)]
COMBOS = [(False, False, True), (True, True, True), (False, False, False)]


def _port_inputs(args, device="cpu"):
    s, learned, _, qt, ex, xs = args
    b = len(WEIGHTS)
    rep = lambda v: torch.as_tensor(
        np.repeat(np.asarray(v)[None], b, 0), device=device)
    txs = tref.StepInputs(*(rep(v) for v in xs[:15]))
    ts = SoCStatic(*(float(v) for v in s))
    tw = tr.RewardWeights(*(torch.tensor([w[i] for w in WEIGHTS],
                                         device=device) for i in range(3)))
    return (ts, torch.full((b,), bool(learned), device=device), tw, rep(qt),
            rep(ex), txs)


def _assert_close(q, ys, q_want, ys_want):
    np.testing.assert_allclose(q, q_want, **TOL)
    for name, a, c in zip(tref.YCOLS, ys, ys_want):
        a, c = np.asarray(a), np.asarray(c)
        if np.issubdtype(c.dtype, np.integer):
            np.testing.assert_array_equal(a, c, err_msg=name)
        else:
            np.testing.assert_allclose(a, c, err_msg=name, **TOL)


@pytest.mark.parametrize("ddr,gated,learned", COMBOS)
def test_episode_ref_matches_reference(ddr, gated, learned):
    args, _ = _soc_step_case(learned)
    s, l, _, qt, ex, xs = args
    tq, tys = tref.episode_ref(*_port_inputs(args), ddr_attribution=ddr,
                               gated=gated)
    for b, w in enumerate(WEIGHTS):
        for kernel in (False, True):
            jq, jys = jops.fused_episode(
                s, l, jr.RewardWeights(*w), qt, ex, xs, ddr_attribution=ddr,
                gated=gated, kernel=kernel, interpret=True)
            _assert_close(tq[b].numpy(), [v[b].numpy() for v in tys],
                          np.asarray(jq), jys)


def test_ops_dispatches_cpu_to_ref_without_counting():
    args, _ = _soc_step_case(True)
    tops.reset_launches()
    q1, y1 = tops.fused_episode(*_port_inputs(args))
    q2, y2 = tref.episode_ref(*_port_inputs(args))
    assert torch.equal(q1, q2) and all(torch.equal(a, b)
                                       for a, b in zip(y1, y2))
    assert tops.launches == 0


def _packed(args, device="cpu"):
    ts, learned, tw, qt, ex, xs = _port_inputs(args, device)
    xf, xi = tref.pack_inputs(xs)
    consts = tref.pack_consts(ts, learned, tw, qt.shape[0], device)
    return xf, xi, consts, qt.contiguous(), ex.contiguous(), xs


def test_kernel_wrapper_refuses_cpu_faulted_and_mlp():
    """The CUDA wrappers refuse CPU tensors, the healthy, the faulted and
    the MLP instantiation alike; the faulted rows carry four more columns,
    and on the CPU ``ops`` runs them through the plain version (neutral
    rows: the healthy result, bitwise)."""
    args, _ = _soc_step_case(True)
    xf, xi, consts, qt, ex, xs = _packed(args)
    assert xf.shape[-1] == 4 + 2 + xs.others.shape[-1] + 9 + 3 * 4
    assert consts.shape == (3, tref.N_CONSTS)
    kw = dict(n_threads=xs.others.shape[-1], n_tiles=xs.tiles.shape[-1],
              n_actions=4)
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.soc_step_episode(xf, xi, consts, qt, ex, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.soc_step_episode(xf, xi, consts, qt, ex,
                                 wpack0=torch.zeros(3, 49, 16),
                                 mlp_dims=(14, 16, 16, 4), **kw)
    faulty = xs._replace(f_exec=torch.ones_like(xs.footprint),
                         f_ddr=torch.ones_like(xs.footprint),
                         f_llc=torch.zeros_like(xs.footprint),
                         f_retry=torch.zeros_like(xs.footprint))
    fxf, _ = tref.pack_inputs(faulty)
    assert fxf.shape[-1] == xf.shape[-1] + 4
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.soc_step_episode(fxf, xi, consts, qt, ex, faulted=True,
                                 **kw)
    ts, learned, tw, q0, e0, _ = _port_inputs(args)
    tops.reset_launches()
    got = tops.fused_episode(ts, learned, tw, q0, e0, faulty)
    want = tops.fused_episode(ts, learned, tw, q0, e0, xs)
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    assert (tops.launches, tops.fault_launches) == (0, 0)
