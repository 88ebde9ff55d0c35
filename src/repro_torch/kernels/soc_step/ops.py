"""Public entry point of the fused SoC episode step.

:func:`fused_episode` dispatches by where the tensors lie: CUDA tensors
launch the hand-written kernel (:mod:`.kernel`), CPU tensors take the
plain PyTorch version (:func:`~repro_torch.kernels.soc_step.ref.
episode_ref`).  There is no fallback between them: a CUDA call that
cannot launch raises.  :data:`launches` counts kernel launches, so a run
can show that its episodes went through the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.soc_step import kernel as _kernel
from repro_torch.kernels.soc_step.ref import (StepInputs, episode_ref,
                                              pack_consts, pack_inputs,
                                              unpack_ys)
from repro_torch.soc.memsys import SoCStatic

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def fused_episode(s: SoCStatic, learned, weights, qtable0, extrema0,
                  xs: StepInputs, *, ddr_attribution: bool = False,
                  gated: bool = False):
    """Run ``B`` fused episodes; returns ``(qtable_final, ys)``.

    ``xs`` leaves are ``(B, S, ...)``; ``qtable0 (B, 243, A)``,
    ``extrema0 (B, 4, n_accs)``; ``learned`` and the weight leaves are
    ``(B,)`` tensors or numbers.  ``ys`` is the ``(B, S)`` per-step
    ``(mode, state_idx, action, exec_cycles, offchip, reward)`` tuple with
    integer columns as int32."""
    global launches
    if qtable0.device.type != "cuda":
        return episode_ref(s, learned, weights, qtable0, extrema0, xs,
                           ddr_attribution=ddr_attribution, gated=gated)
    b = qtable0.shape[0]
    xf, xi = pack_inputs(xs)
    consts = pack_consts(s, learned, weights, b, qtable0.device)
    qtable, y = _kernel.soc_step_episode(
        xf, xi, consts, qtable0.to(torch.float32).contiguous(),
        extrema0.to(torch.float32).contiguous(),
        n_threads=xs.others.shape[-1], n_tiles=xs.tiles.shape[-1],
        n_actions=xs.avail.shape[-1], ddr_attribution=ddr_attribution,
        gated=gated, faulted=xs.f_exec is not None)
    launches += 1
    return qtable, unpack_ys(y)
