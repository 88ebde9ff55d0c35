"""Roofline terms of a step on the H100, counted from the port's own
program (``repro.launch.roofline``).

Three terms per (arch x shape x mesh) cell, as the reference's:

    T_comp = flops / (chips * 989e12)        [bf16 dense tensor-core peak]
    T_mem  = bytes / (chips * 3.35e12)       [HBM bandwidth]
    T_coll = collective bytes / 450e9        [NVLink, each way, per card]

The constants are the H100 SXM's datasheet figures, not measurements.
NVLink joins the eight cards of one host; a 16-wide mesh axis spans two
hosts, whose collectives cross the slower network between them, so
``t_coll`` is a lower bound there.

The reference reads XLA's ``cost_analysis`` and the optimized HLO text.
The port has no compiler between it and the card, so :class:`Counter`
counts the program as it runs, one dispatched op at a time, under real
tensors on the CPU or the card or under fake tensors (the dry-run,
:mod:`repro_torch.launch.dryrun`), with the same result on all three
(the kernels K3-K6 are registered ops with fake implementations and
FLOP formulas: :mod:`repro_torch.kernels.flash_attention.ops` and its
siblings).  It counts a rank's local work: an op whose arguments are
DTensors is handed on (the mode returns ``NotImplemented``), and the
local ops DTensor runs for it come back through the mode and are
counted.  The fields keep the reference's names so the table reads
alike, but two mean something else:

* ``hlo_flops`` is the counted matmul-class FLOPs
  (``torch.utils.flop_counter``'s formulas: products, convolutions,
  attention) plus the kernels' formulas, times the chips; XLA's counts
  every op.
* ``hlo_bytes`` is the operand plus result bytes of every op that moves
  data, times the chips: views (reshapes that are views, ``expand``,
  ``as_strided``) and allocations count 0, an in-place op's result is
  its operand (counted once), a copy between devices (a host constant
  sent to the card) counts 0, and a kernel op counts its inputs and
  outputs once.
"""
from __future__ import annotations

import collections
import dataclasses
import sys
import weakref

import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# NVIDIA H100 SXM per-card datasheet figures (dense, 700 W)
PEAK_FLOPS = 989e12       # bf16 tensor cores
HBM_BW = 3.35e12          # bytes/s
LINK_BW = 450e9           # bytes/s, NVLink each way

# functional collectives (``torch.ops._c10d_functional``) by the
# reference's HLO names; ``wait_tensor`` and the rest count nothing
COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
KERNEL_NAMESPACE = "repro_torch"

_aten = torch.ops.aten
# ops that allocate or relabel without moving data (views aside)
_FREE = {_aten.empty.memory_format, _aten.empty_strided.default,
         _aten.new_empty.default, _aten.new_empty_strided.default,
         _aten.empty_like.default, _aten._unsafe_view.default,
         _aten.lift_fresh.default}
_COPIES = {_aten._to_copy.default, _aten.copy_.default}


_SHARDING_PROP = "torch.distributed.tensor._sharding_prop"


def _inferring_shapes() -> bool:
    """Whether DTensor's sharding propagation is on the stack: it runs an
    op once on fake tensors of the global shapes to learn the output's
    (on its first call for those shapes only, whatever the tensors), which
    is no rank's work."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_globals.get("__name__") == _SHARDING_PROP:
            return True
        f = f.f_back
    return False


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Counter(TorchDispatchMode):
    """Counts a rank's local work while active: ``flops``, ``bytes``,
    ``coll`` (collective result bytes by kind), ``kernels`` (launches of
    each kernel op by name), ``by_op`` (``[calls, flops, bytes]`` by op
    name) and, with ``track_memory``, ``peak_bytes``: the most bytes of
    storage made inside the window alive at once."""

    def __init__(self, track_memory: bool = True):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.coll: dict = {}
        self.kernels: collections.Counter = collections.Counter()
        self.by_op: dict = {}
        self.track_memory = track_memory
        self.live = 0
        self.peak_bytes = 0
        self._seen: dict = {}      # id(storage) -> its finalizer

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        ns = func.namespace
        outs = _tensors(out)
        ins = _tensors((args, kwargs))
        if (not outs or any(t.device.type == "meta" for t in ins + outs)
                or _inferring_shapes()):
            # metadata (prim.device, sizes) and DTensor's own shape
            # inference: no work
            return
        if ns == "_c10d_functional":
            kind = COLLECTIVES.get(func._opname)
            if kind is not None:
                self.coll[kind] = (self.coll.get(kind, 0)
                                   + sum(_nbytes(t) for t in outs))
            self._track(outs)
            return
        if ns == KERNEL_NAMESPACE:
            self.kernels[func._opname] += 1
        formula = flop_registry.get(func._overloadpacket)
        flops = 0 if formula is None else formula(*args, **kwargs,
                                                  out_val=out)
        moved = self._moved(func, ins, outs)
        self.flops += flops
        self.bytes += moved
        row = self.by_op.setdefault(str(func), [0, 0, 0])
        row[0] += 1
        row[1] += flops
        row[2] += moved
        self._track(outs)

    @staticmethod
    def _moved(func, ins, outs) -> int:
        if func.is_view or func in _FREE:
            return 0
        if func in _COPIES and len({t.device for t in ins + outs}) > 1:
            return 0
        seen = {id(t) for t in ins}
        return (sum(_nbytes(t) for t in ins)
                + sum(_nbytes(t) for t in outs if id(t) not in seen))

    def _track(self, outs) -> None:
        if not self.track_memory:
            return
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen and self._seen[key].alive:
                continue
            n = st.nbytes()
            self.live += n
            self.peak_bytes = max(self.peak_bytes, self.live)
            self._seen[key] = weakref.finalize(st, self._free, key, n)

    def _free(self, key, n) -> None:
        self.live -= n
        self._seen.pop(key, None)


def local_bytes(tree) -> int:
    """The bytes this rank holds of every tensor in ``tree`` (a DTensor's
    local shard), each storage once."""
    from torch.distributed.tensor import DTensor
    seen = {}           # id -> storage, held so that no id is reused
    for t in _tensors(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        st = t.untyped_storage()
        seen.setdefault(id(st), st)
    return sum(st.nbytes() for st in seen.values())


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float          # counted FLOPs, all chips
    hlo_bytes: float          # counted bytes moved, all chips
    coll_bytes: float         # per-rank collective bytes
    coll_breakdown: dict
    model_flops: float        # 6*N*D (or 6*N_active*D)
    bytes_per_device: float   # arguments + traced peak of live bytes

    @property
    def t_comp(self) -> float:
        return self.hlo_flops / (self.chips * PEAK_FLOPS)

    @property
    def t_mem(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def t_coll(self) -> float:
        # counted per rank already
        return self.coll_bytes / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_comp, "memory": self.t_mem,
                 "collective": self.t_coll}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / max(self.hlo_flops, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """T_comp / max-term: 1.0 = compute-bound at peak."""
        t = max(self.t_comp, self.t_mem, self.t_coll)
        return self.t_comp / t if t > 0 else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "coll_bytes": self.coll_bytes,
            "coll_breakdown": self.coll_breakdown,
            "model_flops": self.model_flops,
            "bytes_per_device": self.bytes_per_device,
            "t_comp": self.t_comp, "t_mem": self.t_mem,
            "t_coll": self.t_coll, "dominant": self.dominant,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops_for(cfg, spec) -> float:
    """MODEL_FLOPS: 6*N*D training / 2*N*D inference (N = active params
    EXCLUDING embedding tables, Kaplan convention) + explicit lm-head
    matmul flops (the head is a real matmul even when tied)."""
    n = cfg.active_nonembed_param_count()
    heads = cfg.n_codebooks or 1
    head_flops_per_tok = 2.0 * cfg.d_model * cfg.vocab * heads
    if spec.kind == "train":
        tokens = spec.global_batch * spec.seq_len
        return (6.0 * n + 3.0 * head_flops_per_tok) * tokens
    if spec.kind == "prefill":
        tokens = spec.global_batch * spec.seq_len
        # prefill computes the head only for the last token per sequence
        return (2.0 * n * tokens
                + head_flops_per_tok * spec.global_batch)
    tokens = spec.global_batch   # decode: one token per sequence
    return (2.0 * n + head_flops_per_tok) * tokens
