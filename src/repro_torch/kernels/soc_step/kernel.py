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
row, and a weight pack (``wpack0``, or a serve carry's ``wpack``) each
kernel's MLP instantiation, which keeps ``B`` packed Q-networks resident
beside the Q-tables.  The source's notes
say what bounds each and how it is laid out.  :func:`plan` gives the
episode kernel's block shape, ring depth and shared memory from shapes
alone, :func:`serve_plan` the serve kernel's; :func:`chain_cycles`
counts the dependent chain of one step that bounds the episode kernel,
:func:`serve_chain_cycles` that of one request of the serve kernel.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.soc_step.ref import (N_CONSTS, N_SERVE_CONSTS,
                                              SERVE_YCOLS, ServeCarry, YCOLS)
from repro_torch.soc.nn import pack_shape

SOURCE = Path(__file__).resolve().parent / "csrc" / "soc_step.cu"
NVCC_FLAGS = nvcc.SM90A + ("--fmad=false",)

_lib = None

# The source's limits and layout constants.
MAX_T, MAX_TILES, MAX_WIDTH = 64, 16, 243
N_MODES = 4              # actions: the four coherence modes
MAX_RING = 32            # steps a ring chunk stages
SMEM_LIMIT = 232448      # shared memory a block can use on an H100
N_TBL_COLS, N_YCOLS, N_SUMS, N_MLP_SUMS = 6, 6, 4, 5
WARP = 32
N_PUB = 11               # a K2m request's words for the network warp
NET_WORDS = 2 * N_PUB + 2  # two requests' (by parity), action and reward


class Plan(NamedTuple):
    """A kernel's launch: ``threads`` a block (one warp an episode or a
    stream; two, a step warp and a network warp, a K2m stream), ``ring``
    steps staged a chunk (two chunks in flight) and the block's
    ``smem_bytes``."""

    threads: int
    ring: int
    smem_bytes: int


def _scratch_words(T: int, n_tiles: int, mlp: bool) -> int:
    n_sums = n_tiles + N_SUMS + (N_MLP_SUMS if mlp else 0)
    tp = -(-T // WARP) * WARP + 1  # slot rows: whole warps, plus one
    return (n_sums * tp + 6 * n_tiles * tp + n_sums + 6 * n_tiles)


@functools.lru_cache(maxsize=None)
def plan(T: int, n_tiles: int, n_feat: int, n_actions: int, n_states: int,
         n_accs: int, S: int, *, faulted: bool = False,
         mlp_dims: tuple | None = None) -> Plan:
    """Block shape, ring depth and shared-memory bytes of the episode
    kernel (``csrc/soc_step.cu::episode_words`` counts the same words).

    One warp runs an episode: its lanes hold the slots (T <= 64, two a
    lane past 32) and the chain of steps is serial, so more warps would
    only wait.  A chunk of ``ring`` steps covers the rows' global-memory
    latency many times over (a step takes thousands of cycles, a row
    ~1,100 to arrive), so the ring is the largest of 32, S and what fits; a
    chunk boundary costs one wait and one coalesced store of the y rows.
    Raises ValueError where even a one-step ring does not fit (an MLP pack
    too large for shared memory) or a shape is past the kernel's limits.
    Cached: a path launches a few shapes many times (Fig. 9's 222
    one-step launches), and the wrapper's host work is their cost."""
    if not (1 <= T <= MAX_T and 1 <= n_tiles <= MAX_TILES
            and n_actions == N_MODES):
        raise ValueError(f"T={T}, n_tiles={n_tiles}, n_actions={n_actions} "
                         f"outside the kernel's limits (T <= {MAX_T}, "
                         f"n_tiles <= {MAX_TILES}, {N_MODES} actions)")
    mlp = mlp_dims is not None
    nf = 4 + n_tiles + T + n_feat + 3 * n_actions + (4 if faulted else 0)
    n_consts = N_CONSTS + (2 if mlp else 0)
    fixed = (n_states * n_actions + 4 * n_accs + T * (N_TBL_COLS + n_tiles)
             + n_consts + _scratch_words(T, n_tiles, mlp))
    if mlp:
        fixed += _mlp_words(mlp_dims)
    ring = max(1, min(MAX_RING, S))
    words = lambda r: fixed + 2 * r * (nf + 5) + r * N_YCOLS
    while ring > 1 and 4 * words(ring) > SMEM_LIMIT:
        ring //= 2
    if 4 * words(ring) > SMEM_LIMIT:
        raise ValueError(f"the episode needs {4 * words(ring)} bytes of "
                         f"shared memory, more than {SMEM_LIMIT}")
    return Plan(threads=WARP, ring=ring, smem_bytes=4 * words(ring))


N_SERVE_V = 3            # a request row: t_arr, deadline, priority


def _mlp_words(mlp_dims) -> int:
    """Shared-memory words of a network (``csrc/soc_step.cu::
    mlp_words``): the pack, every layer's output, two backward buffers."""
    dims = [int(d) for d in mlp_dims]
    rows, cols = pack_shape(dims)
    return rows * cols + sum(dims) + 2 * MAX_WIDTH


@functools.lru_cache(maxsize=None)
def serve_plan(n_tiles: int, n_feat: int, n_actions: int, n_states: int,
               n_accs: int, queue_cap: int, S: int, *,
               faulted: bool = False, mlp_dims: tuple | None = None) -> Plan:
    """Block shape, ring depth and shared-memory bytes of the serve kernel
    (``csrc/soc_step.cu::serve_words`` counts the same words): one warp a
    stream, a two-chunk ring of ``ring`` requests' xf, xi and xv rows
    (the largest of 32, S and what fits), the carry's tables and rings,
    the step's scratch for ``n_accs`` slots and, with ``mlp_dims`` (K2m),
    the network and its handoff words, run by a second warp (64
    threads).  Raises ValueError past the kernel's limits."""
    if not (1 <= n_accs <= MAX_T and 1 <= n_tiles <= MAX_TILES
            and n_actions == N_MODES and queue_cap >= 1):
        raise ValueError(f"n_accs={n_accs}, n_tiles={n_tiles}, n_actions="
                         f"{n_actions}, queue_cap={queue_cap} outside the "
                         f"kernel's limits (n_accs <= {MAX_T}, n_tiles <= "
                         f"{MAX_TILES}, {N_MODES} actions)")
    nf = 4 + n_tiles + n_accs + n_feat + 3 * n_actions + (4 if faulted
                                                          else 0)
    mlp = mlp_dims is not None
    fixed = (n_states * n_actions + 4 * n_accs
             + n_accs * (N_TBL_COLS + n_tiles) + n_accs + n_accs * queue_cap
             + N_SERVE_CONSTS + (2 if mlp else 0) + n_accs + N_YCOLS + n_accs
             + _scratch_words(n_accs, n_tiles, mlp)
             + (_mlp_words(mlp_dims) + NET_WORDS if mlp else 0))
    ring = max(1, min(MAX_RING, S))
    words = lambda r: (fixed + 2 * r * (nf + 5 + N_SERVE_V)
                       + r * len(SERVE_YCOLS))
    while ring > 1 and 4 * words(ring) > SMEM_LIMIT:
        ring //= 2
    if 4 * words(ring) > SMEM_LIMIT:
        raise ValueError(f"the stream needs {4 * words(ring)} bytes of "
                         f"shared memory, more than {SMEM_LIMIT}")
    return Plan(threads=2 * WARP if mlp else WARP, ring=ring,
                smem_bytes=4 * words(ring))


def serve_net_in_registers(mlp_dims) -> bool:
    """Whether K2m's network warp keeps its copy of the pack in registers
    (``csrc/soc_step.cu::sense_regs_fit``): the paths' (14, 16, 16, 4)
    sense network; every other network runs from shared memory."""
    return tuple(int(d) for d in mlp_dims) == (14, 16, 16, N_MODES)


# Latency in cycles of the operations on a step's chain, measured on an
# NVIDIA H100 80GB HBM3 (700 W) by benchmarks/torch_soc_step_phases.py
# --latency (4,096 dependent operations each): f32 add, multiply, the
# step's branch-free division (qdiv; IEEE division's own is 44.6), xla_log,
# tmin/tmax (NaN-propagating), a shared-memory load, __shfl_sync, a shared
# store and load across __syncwarp.
LATENCY = dict(add=4.10, mul=4.03, div=25.38, log=132.75, tmin=17.22,
               smem=29.01, shfl=26.0, sync=33.0)


def _ops(**kw) -> dict:
    return {k: kw.get(k, 0) for k in LATENCY}


def _add(*ds) -> dict:
    return {k: sum(d[k] for d in ds) for k in LATENCY}


def _cyc(d) -> float:
    return sum(d[k] * LATENCY[k] for k in LATENCY)


def _chain_parts(T: int, n_tiles: int, n_actions: int, ddr: bool,
                 mlp_dims, mlp_feats: str) -> dict:
    """The pieces of a step's chain, by kind (see :func:`chain_ops`)."""
    nt, A = n_tiles, n_actions
    ops = _ops
    parts = dict(slots=ops(smem=1, add=nt - 1, tmin=1, div=1, mul=1, sync=1),
                 sums=ops(add=T - 1, sync=1))
    timing = ops(add=8, mul=4, div=3, tmin=6)
    if ddr:
        attrib = ops(add=1 + (T - 1) + 1 + (nt - 1), shfl=1, div=2, mul=2,
                     sync=2)
        reward = ops(div=2, tmin=2, add=4, mul=1)
        parts["path_a"] = _add(timing, attrib, reward)
    else:
        parts["path_a"] = _add(timing, ops(tmin=2, div=2, add=3, mul=1))
    parts["observe"] = ops(smem=2, add=nt - 1 + 2, div=1)
    parts["select"] = ops(smem=1, tmin=A - 1, add=2 + A)
    parts["pick"] = ops(shfl=1, mul=1, add=1, sync=1)
    if mlp_dims is not None:
        dims = [int(d) for d in mlp_dims]
        parts["feats"] = (ops(add=1, log=1, div=1, mul=1, sync=1)
                          if mlp_feats == "sense" else ops(smem=1, sync=1))
        parts["fwd"] = _add(*(ops(smem=1, mul=1, add=nin + 1, tmin=1, sync=1)
                              for nin in dims[:-1]))
        # K2m's register forward: each layer's inputs by __shfl_sync
        parts["fwd_regs"] = _add(*(ops(shfl=1, mul=1, add=nin + 1, tmin=1)
                                   for nin in dims[:-1]))
        parts["td"] = _add(
            ops(smem=1, mul=2, add=dims[-1] + 1, sync=1),
            *(_add(ops(smem=1, mul=2, add=nout, sync=1) if l > 0 else ops(),
                   ops(smem=1, mul=2, add=1, sync=1))
              for l, nout in enumerate(dims[1:])))
    return parts


def chain_ops(T: int, n_tiles: int, n_actions: int, *, ddr: bool = False,
              mlp_dims=None, mlp_feats: str = "sense") -> dict:
    """Operations, by kind, on the longest dependent chain of one step of
    the episode kernel, counted from ``csrc/soc_step.cu``: from the reads
    of what the step before wrote (a slot row, the Q-row, the extrema
    column, with ``mlp_dims`` the weights of a ``qfun`` episode) to this
    step's writes of them.

    * per-slot terms: the slot read, the overlap's tile sum and division,
      the demand product, the store and ``__syncwarp``;
    * ordered sums: T - 1 adds, the store and ``__syncwarp``;
    * then the longer of (a) the timing's longest path, the coherent-DMA
      mode's (pressure, directory cost, controller bandwidth, hit
      bandwidth, the hit bytes' division, the five-term sum, the
      compute/communication overlap), and the reward's (the communication
      share, its extremum, its ratio, the weighted sum), with ``ddr`` the
      attribution between them (the four exec times shuffled, a division
      and a product per slot, the store, T - 1 adds, the tile's share,
      the store, n_tiles - 1 adds, the division by the line) and the
      memory ratio's path instead; (b) the observation (the tile sum, its
      division, the buckets), the Q-row read and the selection (A - 1
      maxima, the tie threshold, A argmax compares), for a ``qfun``
      episode with the features, the forward (per layer a product, nin
      adds, the bias, the ReLU, ``__syncwarp``) and the network's Q-row
      read between;
    * the pick (one shuffle), the blend of the Q-row, the store and
      ``__syncwarp``; with ``mlp_dims`` the TD update (Q(s, a), delta, per
      layer the gradient sum and the weight update, each ending in
      ``__syncwarp``)."""
    p = _chain_parts(T, n_tiles, n_actions, ddr, mlp_dims, mlp_feats)
    path_b = _add(p["observe"], p["select"])
    td = _ops()
    if mlp_dims is not None:
        path_b = _add(p["observe"], p["feats"], p["fwd"], _ops(smem=1),
                      p["select"])
        td = p["td"]
    longer = p["path_a"] if _cyc(p["path_a"]) >= _cyc(path_b) else path_b
    return _add(p["slots"], p["sums"], longer, p["pick"], td)


def chain_cycles(T: int, n_tiles: int, n_actions: int, **kw) -> float:
    """Cycles of one step's chain (:func:`chain_ops` priced at
    :data:`LATENCY`); times S over the SM clock, the least time an
    episode can take."""
    return _cyc(chain_ops(T, n_tiles, n_actions, **kw))


# the admission's part of a request's chain (serve_chain_ops)
ADMISSION = dict(smem=2, add=5, shfl=1, tmin=1, sync=2)


def serve_chain_ops(n_accs: int, n_tiles: int, n_actions: int, *,
                    ddr: bool = False, mlp_dims=None,
                    mlp_feats: str = "sense") -> dict:
    """Operations, by kind, on the longest dependent chain of one request
    of the serve kernel, counted from ``csrc/soc_step.cu``: what the
    request before wrote (the finish-time ring and busy times, beside the
    step's tables) is read by the admission (the ring slot's shared load,
    its compare, the ballot (priced as a shuffle) and its count, the
    count's compare, the start time's ``tmax``, the first admissible
    retry's select), the ``oth`` flags (the busy times' load, the compare,
    the store and ``__syncwarp``), then the gated step over ``n_accs``
    slots (:func:`chain_ops`), the finish time's add and the ring write's
    store and ``__syncwarp``.

    With ``mlp_dims`` (a ``qfun`` stream of K2m) the network runs in a
    second warp and the chain is the longer of two loops over two
    consecutive requests: the step warp's (the admission, the step up to
    the observation, the handoff to the network warp (a named barrier,
    priced as ``sync``), the features, the forward (in registers, each
    layer's inputs by ``__shfl_sync``, for the paths' sense network), the
    Q-row's handoff and read, the selection and pick) and the network
    warp's (request i's TD update, then request i + 1's handoff,
    features, forward, Q-row handoff, selection and pick and the action's
    handoff): request i's update runs beside request i + 1's admission and
    step."""
    if mlp_dims is None:
        return _add(chain_ops(n_accs, n_tiles, n_actions, ddr=ddr),
                    _ops(**ADMISSION))
    p = _chain_parts(n_accs, n_tiles, n_actions, ddr, mlp_dims, mlp_feats)
    handoff = _ops(sync=1)
    fwd = (p["fwd_regs"] if serve_net_in_registers(mlp_dims)
           else p["fwd"])
    net = _add(handoff, p["feats"], fwd, handoff, _ops(smem=1), p["select"])
    path_b = _add(p["observe"], net)
    longer = p["path_a"] if _cyc(p["path_a"]) >= _cyc(path_b) else path_b
    step_loop = _add(_ops(**ADMISSION), p["slots"], p["sums"], longer,
                     p["pick"])
    net_loop = _add(p["td"], net, p["pick"], handoff)
    return step_loop if _cyc(step_loop) >= _cyc(net_loop) else net_loop


def serve_chain_cycles(n_accs: int, n_tiles: int, n_actions: int,
                       **kw) -> float:
    """Cycles of one request's chain (:func:`serve_chain_ops` priced at
    :data:`LATENCY`); times S over the SM clock, the least time a stream
    can take."""
    return _cyc(serve_chain_ops(n_accs, n_tiles, n_actions, **kw))


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
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fn = lib.soc_step_serve_launch
        fn.argtypes = ([ctypes.c_void_p] * 23 + [ctypes.c_int] * 14
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fn = lib.soc_step_qdiv_probe
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
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


def _check_mlp(wpack, b, mlp_dims, mlp_feats) -> list:
    """The layer widths, after checking that ``wpack`` holds ``b``
    networks of those widths the kernels take."""
    _check("wpack", wpack, torch.float32, 3)
    if mlp_dims is None or mlp_feats not in ("sense", "onehot"):
        raise ValueError("the MLP variant needs mlp_dims and mlp_feats "
                         "'sense' or 'onehot'")
    dims = [int(d) for d in mlp_dims]
    if (tuple(wpack.shape[1:]) != pack_shape(dims) or wpack.shape[0] != b
            or not 2 <= len(dims) <= 5 or max(dims) > MAX_WIDTH):
        raise ValueError(f"wpack {tuple(wpack.shape)} does not hold {b} "
                         f"networks of widths {dims} (at most 4 layers of "
                         f"at most {MAX_WIDTH})")
    return dims


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
        dims = _check_mlp(wpack0, xf.shape[0], mlp_dims, mlp_feats)
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
    pl = plan(n_threads, n_tiles, n_feat, n_actions, n_states, n_accs, s,
              faulted=bool(faulted), mlp_dims=tuple(dims) if mlp else None)
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
            pl.ring, stream)
    if err != 0:
        raise RuntimeError(f"soc_step_episode launch failed: CUDA error "
                           f"{err}")
    return (qtable, wpack, y) if mlp else (qtable, y)


def qdiv_probe(a, b):
    """The episode step's branch-free division on CUDA float32 tensors:
    ``(q, ok)``, where ``ok`` marks the quotients the kernel trusts (the
    rest it recomputes with IEEE division); a test holds ``q[ok]`` against
    ``a / b``."""
    _check("a", a, torch.float32, 1)
    _check("b", b, torch.float32, 1)
    if a.shape != b.shape or a.device != b.device:
        raise ValueError("a and b must match in shape and device")
    lib = _load()
    q = torch.empty_like(a)
    ok = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        err = lib.soc_step_qdiv_probe(
            a.data_ptr(), b.data_ptr(), q.data_ptr(), ok.data_ptr(),
            a.numel(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"soc_step_qdiv_probe failed: CUDA error {err}")
    return q, ok.bool()


def qdiv_probe_inputs(n: int, seed: int = 0):
    """``n`` float32 pairs for :func:`qdiv_probe` (numpy, from a seed):
    exponents across and past the trusted range [2^-60, 2^60) on both
    sides, random mantissas and signs, zeros, the range's edges, powers of
    two and quotients near exact; and the range flag each pair should
    get."""
    import numpy as np
    rng = np.random.default_rng(seed)
    def draw(m):
        e = rng.integers(-66, 67, m)
        v = np.ldexp(rng.uniform(1.0, 2.0, m), e).astype(np.float32)
        v[rng.random(m) < 0.1] = np.float32(1.0)
        return np.where(rng.random(m) < 0.5, -v, v).astype(np.float32)
    a, b = draw(n), draw(n)
    a[rng.random(n) < 0.02] = 0.0
    a[rng.random(n) < 0.01] = -0.0
    k = min(n, 8)
    a[:k] = np.float32([2.0 ** -60, 2.0 ** 60 * (1 - 2 ** -24), 3.0, 1.0,
                        -0.0, 0.0, 2.0 ** 59, 7.0])[:k]
    b[:k] = np.float32([2.0 ** 60 * (1 - 2 ** -24), 2.0 ** -60, 3.0, 3.0,
                        5.0, -5.0, 2.0 ** -59, 2.0 ** 60])[:k]
    lo, hi = np.float32(2.0 ** -60), np.float32(2.0 ** 60)
    inr = lambda v: (np.abs(v) >= lo) & (np.abs(v) < hi)
    ok = inr(b) & ((a == 0) | inr(a))
    return a, b, ok


def soc_step_serve(xf, xi, xv, consts, carry0: ServeCarry, *, n_tiles: int,
                   n_actions: int, ddr_attribution: bool = False,
                   faulted: bool = False, mlp_dims=None,
                   mlp_feats: str = "sense"):
    """Run ``B`` packed arrival-stream chunks through the CUDA kernel.

    ``xf (B, S, NF)`` f32 / ``xi (B, S, 5)`` i32 are the packed step rows
    with a placeholder ``others`` block of width ``n_accs``, ``xv (B, S,
    3)`` f32 the ``[t_arr, deadline, priority]`` rows
    (:func:`~repro_torch.kernels.soc_step.ref.pack_serve_rows`), ``consts
    (B, 34)`` f32 (:func:`~repro_torch.kernels.soc_step.ref.
    pack_serve_consts`) and ``carry0`` a
    :class:`~repro_torch.kernels.soc_step.ref.ServeCarry` of CUDA tensors.
    With ``faulted`` the rows of ``xf`` end in the four fault columns.
    Returns ``(carry_final, y (B, S, 13))``.

    A carry with ``wpack (B, R, C)`` launches the MLP instantiation (K2m,
    faulted K2m-faulted): networks of layer widths ``mlp_dims`` over the
    ``mlp_feats`` embedding, ``consts (B, 36)`` ending in ``[qfun,
    mlp_lr]``; the trained pack comes back in the carry."""
    c = carry0
    mlp = c.wpack is not None
    if mlp:
        dims = _check_mlp(c.wpack, xf.shape[0], mlp_dims, mlp_feats)
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
    devs = {t.device for t in (xf, xi, xv, consts, *c) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    n_consts = N_SERVE_CONSTS + (2 if mlp else 0)
    if (tuple(xi.shape) != (b, s, 5) or tuple(xv.shape) != (b, s, 3)
            or tuple(consts.shape) != (b, n_consts)
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
            f"{[tuple(t.shape) for t in c if t is not None]} for "
            f"n_tiles={n_tiles} n_actions={n_actions}")
    _check_xi(xi, ((0, n_accs), (4, n_actions)))
    pl = serve_plan(n_tiles, n_feat, n_actions, n_states, n_accs, queue_cap,
                    s, faulted=bool(faulted),
                    mlp_dims=tuple(dims) if mlp else None)
    lib = _load()
    y = torch.empty((b, s, len(SERVE_YCOLS)), dtype=torch.float32,
                    device=xf.device)
    misc0 = torch.stack([c.pressure, c.tripped], dim=-1).contiguous()
    out = c.map(torch.empty_like)
    misc = torch.empty_like(misc0)
    dims_arr = (ctypes.c_int * 5)(*(dims if mlp else []))
    with torch.cuda.device(xf.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.soc_step_serve_launch(
            xf.data_ptr(), xi.data_ptr(), xv.data_ptr(), consts.data_ptr(),
            c.qtable.data_ptr(), c.extrema.data_ptr(), c.tbl.data_ptr(),
            c.busy.data_ptr(), c.fin.data_ptr(), c.head.data_ptr(),
            misc0.data_ptr(), c.step.data_ptr(),
            c.wpack.data_ptr() if mlp else None, y.data_ptr(),
            out.qtable.data_ptr(), out.extrema.data_ptr(),
            out.tbl.data_ptr(), out.busy.data_ptr(), out.fin.data_ptr(),
            out.head.data_ptr(), misc.data_ptr(), out.step.data_ptr(),
            out.wpack.data_ptr() if mlp else None,
            b, s, nf, n_consts, n_tiles, n_accs, n_feat, n_actions,
            n_states, queue_cap, int(ddr_attribution), int(faulted),
            ("sense", "onehot").index(mlp_feats) if mlp else -1,
            len(dims) if mlp else 0, ctypes.cast(dims_arr, ctypes.c_void_p),
            pl.ring, stream)
    if err != 0:
        raise RuntimeError(f"soc_step_serve launch failed: CUDA error {err}")
    return out._replace(pressure=misc[:, 0].contiguous(),
                        tripped=misc[:, 1].contiguous()), y
