"""The control of the comparison: the reference's step loops computed one
precision below the configuration's float32, in bfloat16.

After every step the carried state (the Q-table, the reward extrema and
the slot table) and the step's outputs are rounded to bfloat16, as a program that kept its state in
bfloat16 would hold them.  Put in the program's place, a run must come
out not correct.
"""
from __future__ import annotations

import torch

from perfbench.reference import rewards, step as ref_step
from perfbench.reference.memsys import static_tensors


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def episode_lowp(s, learned, weights, qtable0, extrema0, xs, *,
                 gated=False, ddr_attribution=False, **_):
    """:func:`~perfbench.reference.step.episode_ref` in bfloat16 state."""
    dev = qtable0.device
    b, n_steps = xs.acc_id.shape
    f32 = torch.float32
    st = static_tensors(s, b, dev)
    learned_t = torch.as_tensor(learned, device=dev).to(torch.bool).expand(b)
    w = rewards.RewardWeights(*(
        torch.as_tensor(v, device=dev).to(f32).expand(b) for v in weights))
    geom, warm_cap = ref_step.derive_geom(st)
    qtable = _bf16(qtable0.to(f32))
    rs = rewards.RewardState(extrema=_bf16(extrema0.to(f32)))
    tbl = ref_step.init_slot_table(xs.others.shape[-1], xs.tiles.shape[-1],
                                   b, dev)
    ys = []
    for i in range(n_steps):
        rs, y = ref_step.fused_step(st, geom, warm_cap, learned_t, w, qtable,
                                    rs, tbl, ref_step.step_slice(xs, i),
                                    ddr_attribution=ddr_attribution,
                                    gated=gated)
        qtable.copy_(_bf16(qtable))
        tbl.copy_(_bf16(tbl))
        rs = rewards.RewardState(extrema=_bf16(rs.extrema))
        ys.append(_bf16(y))
    return qtable, ref_step.unpack_ys(torch.stack(ys, dim=1))
