"""ctypes wrappers of the CUDA ``soc_step_episode`` and ``soc_step_serve``
kernels.

``csrc/soc_step.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with plain C entry points, on first use (never at
import), into ``build/repro_torch/soc_step-<hash of the source>/`` at the
root of the checkout.  A missing ``nvcc`` raises: there is no fallback.

:func:`soc_step_episode` launches the episode kernel on PyTorch's current
stream for ``B`` episodes at once, :func:`soc_step_serve` the serving
kernel for ``B`` arrival streams; ``faulted=True`` launches each kernel's
fault-injected instantiation, which reads four more float columns per
row, and ``wpack0`` the episode kernel's MLP instantiation, which keeps
``B`` packed Q-networks resident beside the Q-tables.  The source's notes
say what bounds each and how it is laid out.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.soc_step.ref import (N_CONSTS, N_SERVE_CONSTS,
                                              SERVE_YCOLS, ServeCarry, YCOLS)
from repro_torch.soc.nn import pack_shape

SOURCE = Path(__file__).resolve().parent / "csrc" / "soc_step.cu"
NVCC_FLAGS = nvcc.SM90A + ("--fmad=false",)

_lib = None


def build(verbose: bool = False) -> Path:
    """Compile the kernel (if this source has not been built yet) and
    return the shared library's path."""
    return nvcc.build(SOURCE, "soc_step", NVCC_FLAGS, verbose)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.soc_step_episode_launch
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 15
                       + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
        fn = lib.soc_step_serve_launch
        fn.argtypes = ([ctypes.c_void_p] * 21 + [ctypes.c_int] * 12
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(name, t, dtype, ndim):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor (got {t.device}); "
                         "CPU tensors take the plain version via ops")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_xi(xi, limits):
    """The kernels index their shared-memory tables with these columns."""
    if xi.numel() == 0:
        return
    lo = xi.amin((0, 1)).tolist()
    hi = xi.amax((0, 1)).tolist()
    for col, limit in limits:
        if not (0 <= lo[col] and hi[col] < limit):
            raise ValueError(f"xi column {col} outside [0, {limit}): "
                             f"[{lo[col]}, {hi[col]}]")


def soc_step_episode(xf, xi, consts, qtable0, extrema0, wpack0=None, *,
                     n_threads: int, n_tiles: int, n_actions: int,
                     ddr_attribution: bool = False, gated: bool = False,
                     faulted: bool = False, mlp_dims=None,
                     mlp_feats: str = "sense"):
    """Run ``B`` packed episodes through the CUDA kernel.

    ``xf (B, S, NF)`` f32 / ``xi (B, S, 5)`` i32 are the packed step rows
    (:func:`~repro_torch.kernels.soc_step.ref.pack_inputs`), ``consts
    (B, 25)`` f32 (:func:`~repro_torch.kernels.soc_step.ref.pack_consts`),
    ``qtable0 (B, 243, A)`` and ``extrema0 (B, 4, n_accs)`` f32.  With
    ``faulted`` the rows end in the four fault columns.  Returns
    ``(qtable_final (B, 243, A), y (B, S, 6))``.

    The MLP instantiation takes ``wpack0 (B, R, C)`` f32 packed networks
    of layer widths ``mlp_dims`` (at most 4 layers, widths at most 243)
    over the ``mlp_feats`` embedding, and ``consts (B, 27)`` ending in
    ``[qfun, mlp_lr]``; it returns ``(qtable_final, wpack_final, y)``."""
    _check("xf", xf, torch.float32, 3)
    _check("xi", xi, torch.int32, 3)
    _check("consts", consts, torch.float32, 2)
    _check("qtable0", qtable0, torch.float32, 3)
    _check("extrema0", extrema0, torch.float32, 3)
    mlp = wpack0 is not None
    if mlp:
        _check("wpack0", wpack0, torch.float32, 3)
        if mlp_dims is None or mlp_feats not in ("sense", "onehot"):
            raise ValueError("the MLP variant needs mlp_dims and mlp_feats "
                             "'sense' or 'onehot'")
        dims = [int(d) for d in mlp_dims]
        if (tuple(wpack0.shape[1:]) != pack_shape(dims)
                or wpack0.shape[0] != xf.shape[0] or not 2 <= len(dims) <= 5
                or max(dims) > 243):
            raise ValueError(f"wpack0 {tuple(wpack0.shape)} does not hold "
                             f"B networks of widths {dims} (at most 4 "
                             "layers of at most 243)")
    b, s, nf = xf.shape
    n_states, n_a = qtable0.shape[1:]
    n_accs = extrema0.shape[2]
    n_feat = (nf - 4 - n_tiles - n_threads - 3 * n_actions
              - (4 if faulted else 0))
    devs = {t.device for t in (xf, xi, consts, qtable0, extrema0)
            + ((wpack0,) if mlp else ())}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    n_consts = N_CONSTS + (2 if mlp else 0)
    if (tuple(xi.shape) != (b, s, 5) or tuple(consts.shape) != (b, n_consts)
            or qtable0.shape[0] != b or n_a != n_actions
            or tuple(extrema0.shape[:2]) != (b, 4) or n_feat < 9):
        raise ValueError(
            f"inconsistent shapes xf={tuple(xf.shape)} "
            f"xi={tuple(xi.shape)} consts={tuple(consts.shape)} "
            f"qtable0={tuple(qtable0.shape)} "
            f"extrema0={tuple(extrema0.shape)} for n_threads={n_threads} "
            f"n_tiles={n_tiles} n_actions={n_actions}")
    _check_xi(xi, ((0, n_accs), (1, n_threads), (4, n_actions)))
    lib = _load()
    y = torch.empty((b, s, len(YCOLS)), dtype=torch.float32,
                    device=xf.device)
    qtable = torch.empty_like(qtable0)
    wpack = torch.empty_like(wpack0) if mlp else None
    dims_arr = (ctypes.c_int * 5)(*(dims if mlp else []))
    with torch.cuda.device(xf.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.soc_step_episode_launch(
            xf.data_ptr(), xi.data_ptr(), consts.data_ptr(),
            qtable0.data_ptr(), extrema0.data_ptr(),
            wpack0.data_ptr() if mlp else None, y.data_ptr(),
            qtable.data_ptr(), wpack.data_ptr() if mlp else None, b, s, nf,
            n_consts, n_tiles, n_threads, n_feat, n_actions, n_states,
            n_accs, int(ddr_attribution), int(gated), int(faulted),
            ("sense", "onehot").index(mlp_feats) if mlp else -1,
            len(dims) if mlp else 0, ctypes.cast(dims_arr, ctypes.c_void_p),
            stream)
    if err != 0:
        raise RuntimeError(f"soc_step_episode launch failed: CUDA error "
                           f"{err}")
    return (qtable, wpack, y) if mlp else (qtable, y)


def soc_step_serve(xf, xi, xv, consts, carry0: ServeCarry, *, n_tiles: int,
                   n_actions: int, ddr_attribution: bool = False,
                   faulted: bool = False):
    """Run ``B`` packed arrival-stream chunks through the CUDA kernel.

    ``xf (B, S, NF)`` f32 / ``xi (B, S, 5)`` i32 are the packed step rows
    with a placeholder ``others`` block of width ``n_accs``, ``xv (B, S,
    3)`` f32 the ``[t_arr, deadline, priority]`` rows
    (:func:`~repro_torch.kernels.soc_step.ref.pack_serve_rows`), ``consts
    (B, 34)`` f32 (:func:`~repro_torch.kernels.soc_step.ref.
    pack_serve_consts`) and ``carry0`` a
    :class:`~repro_torch.kernels.soc_step.ref.ServeCarry` of CUDA tensors.
    With ``faulted`` the rows of ``xf`` end in the four fault columns.
    Returns ``(carry_final, y (B, S, 13))``."""
    c = carry0
    for name, t, dt, nd in (
            ("xf", xf, torch.float32, 3), ("xi", xi, torch.int32, 3),
            ("xv", xv, torch.float32, 3), ("consts", consts, torch.float32,
                                           2),
            ("qtable", c.qtable, torch.float32, 3),
            ("extrema", c.extrema, torch.float32, 3),
            ("tbl", c.tbl, torch.float32, 3),
            ("busy", c.busy, torch.float32, 2),
            ("fin", c.fin, torch.float32, 3),
            ("head", c.head, torch.int32, 2),
            ("pressure", c.pressure, torch.float32, 1),
            ("tripped", c.tripped, torch.float32, 1),
            ("step", c.step, torch.int32, 1)):
        _check(name, t, dt, nd)
    b, s, nf = xf.shape
    n_states, n_a = c.qtable.shape[1:]
    n_accs = c.busy.shape[1]
    queue_cap = c.fin.shape[2]
    n_feat = (nf - 4 - n_tiles - n_accs - 3 * n_actions
              - (4 if faulted else 0))
    devs = {t.device for t in (xf, xi, xv, consts, *c)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    if (tuple(xi.shape) != (b, s, 5) or tuple(xv.shape) != (b, s, 3)
            or tuple(consts.shape) != (b, N_SERVE_CONSTS)
            or c.qtable.shape[0] != b or n_a != n_actions
            or tuple(c.extrema.shape) != (b, 4, n_accs)
            or tuple(c.tbl.shape) != (b, n_accs, 6 + n_tiles)
            or tuple(c.fin.shape[:2]) != (b, n_accs)
            or tuple(c.head.shape) != (b, n_accs)
            or any(t.shape != (b,) for t in (c.pressure, c.tripped, c.step))
            or n_feat < 9):
        raise ValueError(
            f"inconsistent shapes xf={tuple(xf.shape)} xi={tuple(xi.shape)} "
            f"xv={tuple(xv.shape)} consts={tuple(consts.shape)} carry="
            f"{[tuple(t.shape) for t in c]} for n_tiles={n_tiles} "
            f"n_actions={n_actions}")
    _check_xi(xi, ((0, n_accs), (4, n_actions)))
    lib = _load()
    y = torch.empty((b, s, len(SERVE_YCOLS)), dtype=torch.float32,
                    device=xf.device)
    misc0 = torch.stack([c.pressure, c.tripped], dim=-1).contiguous()
    out = ServeCarry(*(torch.empty_like(t) for t in c))
    misc = torch.empty_like(misc0)
    with torch.cuda.device(xf.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.soc_step_serve_launch(
            xf.data_ptr(), xi.data_ptr(), xv.data_ptr(), consts.data_ptr(),
            c.qtable.data_ptr(), c.extrema.data_ptr(), c.tbl.data_ptr(),
            c.busy.data_ptr(), c.fin.data_ptr(), c.head.data_ptr(),
            misc0.data_ptr(), c.step.data_ptr(), y.data_ptr(),
            out.qtable.data_ptr(), out.extrema.data_ptr(),
            out.tbl.data_ptr(), out.busy.data_ptr(), out.fin.data_ptr(),
            out.head.data_ptr(), misc.data_ptr(), out.step.data_ptr(),
            b, s, nf, N_SERVE_CONSTS, n_tiles, n_accs, n_feat, n_actions,
            n_states, queue_cap, int(ddr_attribution), int(faulted), stream)
    if err != 0:
        raise RuntimeError(f"soc_step_serve launch failed: CUDA error {err}")
    return out._replace(pressure=misc[:, 0].contiguous(),
                        tripped=misc[:, 1].contiguous()), y
