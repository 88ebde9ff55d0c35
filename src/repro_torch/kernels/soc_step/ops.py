"""Public entry points of the fused SoC step.

:func:`fused_episode` and :func:`fused_serve_episode` dispatch by where
the tensors lie: CUDA tensors launch the hand-written kernels
(:mod:`.kernel`), CPU tensors take the plain PyTorch versions
(:func:`~repro_torch.kernels.soc_step.ref.episode_ref`,
:func:`~repro_torch.kernels.soc_step.ref.serve_episode_ref`).  There is no
fallback between them: a CUDA call that cannot launch raises.  Inputs
with fault columns (``xs.f_exec`` set) take the kernels' faulted
instantiations, calls with MLP agents (``mlp=``) the kernels' MLP
instantiations.  :data:`launches` and :data:`serve_launches` count the
healthy table kernels' launches, :data:`fault_launches` and
:data:`fault_serve_launches` the faulted ones', :data:`mlp_launches` and
:data:`mlp_fault_launches` the MLP episode kernel's (K1m),
:data:`mlp_serve_launches` and :data:`mlp_fault_serve_launches` the MLP
serve kernel's (K2m), so a run can show that it went through the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.soc_step import kernel as _kernel
from repro_torch.kernels.soc_step.ref import (ServeCarry, ServeParams,
                                              StepInputs, episode_ref,
                                              pack_consts, pack_inputs,
                                              pack_serve_consts,
                                              pack_serve_rows,
                                              serve_episode_ref, unpack_ys)
from repro_torch.soc import nn as socnn
from repro_torch.soc.memsys import SoCStatic

launches = 0
serve_launches = 0
fault_launches = 0
fault_serve_launches = 0
mlp_launches = 0
mlp_fault_launches = 0
mlp_serve_launches = 0
mlp_fault_serve_launches = 0


def reset_launches() -> None:
    global launches, serve_launches, fault_launches, fault_serve_launches
    global mlp_launches, mlp_fault_launches, mlp_serve_launches
    global mlp_fault_serve_launches
    launches = serve_launches = fault_launches = fault_serve_launches = 0
    mlp_launches = mlp_fault_launches = 0
    mlp_serve_launches = mlp_fault_serve_launches = 0


def fused_episode(s: SoCStatic, learned, weights, qtable0, extrema0,
                  xs: StepInputs, *, ddr_attribution: bool = False,
                  gated: bool = False, qfun=None, mlp=None):
    """Run ``B`` fused episodes; returns ``(qtable_final, ys)``.

    ``xs`` leaves are ``(B, S, ...)``; ``qtable0 (B, 243, A)``,
    ``extrema0 (B, 4, n_accs)``; ``learned`` and the weight leaves are
    ``(B,)`` tensors or numbers.  ``ys`` is the ``(B, S)`` per-step
    ``(mode, state_idx, action, exec_cycles, offchip, reward)`` tuple with
    integer columns as int32.  With ``mlp`` (a :class:`~repro_torch.soc.
    nn.MLPQState` of ``B`` networks) and ``qfun (B,)`` the packed weights
    ride the episode and the return is ``(qtable_final, wpack_final,
    ys)``."""
    global launches, fault_launches, mlp_launches, mlp_fault_launches
    mlp_kw = {}
    if mlp is not None:
        mlp_kw = dict(mlp_dims=socnn.mlp_dims(mlp.cfg),
                      mlp_feats=mlp.cfg.features)
    if qtable0.device.type != "cuda":
        plain_kw = {} if mlp is None else dict(
            wpack0=mlp.wpack, qfun=qfun, mlp_lr=mlp.lr, **mlp_kw)
        return episode_ref(s, learned, weights, qtable0, extrema0, xs,
                           ddr_attribution=ddr_attribution, gated=gated,
                           **plain_kw)
    b = qtable0.shape[0]
    xf, xi = pack_inputs(xs)
    consts = pack_consts(s, learned, weights, b, qtable0.device,
                         *(() if mlp is None else (qfun, mlp.lr)))
    out = _kernel.soc_step_episode(
        xf, xi, consts, qtable0.to(torch.float32).contiguous(),
        extrema0.to(torch.float32).contiguous(),
        None if mlp is None else mlp.wpack.to(torch.float32).contiguous(),
        n_threads=xs.others.shape[-1], n_tiles=xs.tiles.shape[-1],
        n_actions=xs.avail.shape[-1], ddr_attribution=ddr_attribution,
        gated=gated, faulted=xs.faulted, **mlp_kw)
    if mlp is not None:
        if xs.faulted:
            mlp_fault_launches += 1
        else:
            mlp_launches += 1
        return out[0], out[1], unpack_ys(out[2])
    if xs.faulted:
        fault_launches += 1
    else:
        launches += 1
    return out[0], unpack_ys(out[1])


def fused_serve_episode(s: SoCStatic, learned, weights, sp: ServeParams,
                        carry0: ServeCarry, xs: StepInputs, t_arr, deadline,
                        priority, *, ddr_attribution: bool = False,
                        qfun=None, mlp=None):
    """Run ``B`` arrival-stream chunks through the serving step; returns
    ``(carry_final, ys (B, S, 13))``.

    ``xs`` is a ``(B, S)``-leading :class:`StepInputs` whose thread/fresh/
    others/valid/eps/alpha columns are placeholders (``others`` of width
    ``n_accs``) the serve step owns; ``t_arr``/``deadline``/``priority``
    are ``(B, S)``; ``carry0`` a :class:`ServeCarry` of ``B`` streams.
    With ``mlp`` (a :class:`~repro_torch.soc.nn.MLPQState` giving the
    learning rates and the architecture) and ``qfun (B,)`` the streams
    serve networks whose packed weights ride ``carry0.wpack``."""
    global serve_launches, fault_serve_launches
    global mlp_serve_launches, mlp_fault_serve_launches
    if (mlp is None) != (carry0.wpack is None):
        raise ValueError("MLP serving needs both mlp= and a carry holding "
                         "the weight pack")
    mlp_kw = {}
    if mlp is not None:
        mlp_kw = dict(mlp_dims=socnn.mlp_dims(mlp.cfg),
                      mlp_feats=mlp.cfg.features)
    if carry0.qtable.device.type != "cuda":
        plain_kw = {} if mlp is None else dict(qfun=qfun, mlp_lr=mlp.lr,
                                               **mlp_kw)
        return serve_episode_ref(s, learned, weights, sp, carry0, xs, t_arr,
                                 deadline, priority,
                                 ddr_attribution=ddr_attribution, **plain_kw)
    b = carry0.qtable.shape[0]
    dev = carry0.qtable.device
    xf, xi = pack_inputs(xs)
    consts = pack_serve_consts(s, learned, weights, sp, b, dev,
                               *(() if mlp is None else (qfun, mlp.lr)))
    xv = pack_serve_rows(t_arr, deadline, priority)
    carry, y = _kernel.soc_step_serve(
        xf, xi, xv, consts, carry0.map(torch.Tensor.contiguous),
        n_tiles=xs.tiles.shape[-1], n_actions=xs.avail.shape[-1],
        ddr_attribution=ddr_attribution, faulted=xs.faulted, **mlp_kw)
    if mlp is not None:
        if xs.faulted:
            mlp_fault_serve_launches += 1
        else:
            mlp_serve_launches += 1
    elif xs.faulted:
        fault_serve_launches += 1
    else:
        serve_launches += 1
    return carry, y
