"""Sharding rules: parameter, batch, cache and activation axes -> mesh
axes (``repro.distributed.sharding``), for DTensor.

The reference's scheme (MaxText-style, 2-D):

  * batch                          -> ("pod", "data")  data parallel
  * d_model of a weight            -> "data"   FSDP: parameters, gradients
                                                and moments shard over
                                                data, gathered at use
  * heads / d_ff / vocab / experts -> "model"  tensor / expert parallel
  * seq                            -> None

A spec is a plain tuple, one entry per tensor dimension: ``None``, a mesh
axis name or a tuple of names, the twin of a ``PartitionSpec`` (so a
spec compares equal to ``tuple(P(...))`` of the reference's).
:func:`placements` turns one into DTensor placements on a mesh.  A mesh
is a ``DeviceMesh`` or a :class:`~repro_torch.launch.mesh.AbstractMesh`;
the rules read only its axis names and sizes.

The parameter rules key on the reference's leaf path (a regex, first hit
wins), where every superblock's tensor is one leaf stacked along a
leading layer axis.  The port keeps a tensor per layer: its name maps
onto the reference's path through :func:`repro_torch.models.convert.
_ref_path`, and a per-layer tensor of a stacked leaf takes the stacked
leaf's spec (fitted to the stacked shape) without its leading axis.
"""
from __future__ import annotations

import dataclasses
import math
import re

import torch

# (path regex, spec) -- matched in order, first hit wins; written for the
# logical (data, model) axes, the pod axis folded in by _expand_pod.
_PARAM_RULES: list[tuple[str, tuple]] = [
    # vocab on model, d_model replicated: the head's logits stay sharded
    # with no forward collective
    (r"(^|\.)embed$", ("model", None)),
    (r"codebook", (None, "model", None)),
    (r"lm_head$", (None, "model")),
    (r"vision_proj$", (None, "data")),
    # attention projections (stacked: leading layer axis)
    (r"\bwq$", (None, "data", "model", None)),
    (r"\bwk$", (None, "data", "model", None)),
    (r"\bwv$", (None, "data", "model", None)),
    (r"\bwo$", (None, "model", None, "data")),
    # MoE: experts on model, d_model on data
    (r"moe\.router$", (None, "data", None)),
    (r"moe\.w_(gate|up)$", (None, "model", "data", None)),
    (r"moe\.w_down$", (None, "model", None, "data")),
    # dense FFN: d_ff on model, d_model on data
    (r"mlp\.w_(gate|up)$", (None, "data", "model")),
    (r"mlp\.w_down$", (None, "model", "data")),
    # rwkv time/channel mix square matrices: both dims
    (r"(tm|cm)\.w[rkvgo]$", (None, "data", "model")),
    (r"(tm|cm)\.wk$", (None, "data", "model")),
    (r"cm\.wv$", (None, "model", "data")),
    # rg-lru
    (r"rg\.w_(in|gate)$", (None, "data", "model")),
    (r"rg\.w_out$", (None, "model", "data")),
    (r"rg\.w[ax]$", (None, "data", "model")),
    # everything small (norms, biases, decays, LoRAs): replicated
]


def _mesh_axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axes(ax) -> tuple:
    return ax if isinstance(ax, tuple) else (ax,)


def _fit_spec(spec: tuple, shape, mesh) -> tuple:
    """Keep a spec's axis on a dimension only where the axis size divides
    it (an input placement must split evenly); other dimensions, and
    those past the spec, are replicated.  The spec is cut or padded with
    None to the tensor's rank."""
    sizes = _mesh_axis_sizes(mesh)
    out = []
    for i, ax in enumerate(spec):
        if ax is None or i >= len(shape):
            out.append(None)
            continue
        total = math.prod(sizes[a] for a in _axes(ax))
        dim = shape[i]
        out.append(ax if dim >= total and dim % total == 0 else None)
    while len(out) < len(shape):
        out.append(None)
    return tuple(out[:len(shape)])


def activation_spec(mesh, shape, *, batch_dim: int = 0,
                    head_dim: int | None = None) -> tuple:
    """Spec of an activation constraint: the batch over (pod, data), the
    heads over model where the padded split uses at least half of it
    (an activation, unlike an input placement, may split unevenly)."""
    sizes = _mesh_axis_sizes(mesh)
    spec: list = [None] * len(shape)
    names = tuple(mesh.mesh_dim_names)
    batch_axes = ("pod", "data") if "pod" in names else ("data",)
    total_b = math.prod(sizes[a] for a in batch_axes)
    if shape[batch_dim] % total_b == 0 or shape[batch_dim] >= total_b:
        spec[batch_dim] = batch_axes if len(batch_axes) > 1 else "data"
    if head_dim is not None and "model" in sizes:
        n = sizes["model"]
        d = shape[head_dim]
        padded = -(-d // n) * n
        if d / padded >= 0.5:
            spec[head_dim] = "model"
    return tuple(spec)


_ACTIVE_MESH: list = []   # set by the train step around its forward


class activation_mesh:
    """Context manager naming the mesh that :func:`constrain` places
    activations on."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        _ACTIVE_MESH.append(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        _ACTIVE_MESH.pop()


def active_mesh():
    """The innermost :class:`activation_mesh`'s mesh, or None."""
    return _ACTIVE_MESH[-1] if _ACTIVE_MESH else None


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: per mesh axis,
    ``Shard(d)`` where dimension ``d`` of the spec names the axis, else
    ``Replicate()`` (also on an axis of size 1, where the two hold the
    same data and DTensor's view rules take a replicated dimension more
    readily).  A dimension over several axes (``("pod", "data")``) is
    split by them in mesh order, as a ``PartitionSpec``'s tuple is."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name, size in zip(mesh.mesh_dim_names, mesh.shape):
        dims = [d for d, ax in enumerate(spec)
                if ax is not None and name in _axes(ax)]
        out.append(Shard(dims[0]) if dims and size > 1 else Replicate())
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the twin of ``jax.sharding.NamedSharding``)."""
    mesh: object
    spec: tuple

    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def place(self, t: torch.Tensor):
        """``t`` (the same full value on every rank) on the mesh's device
        as a DTensor holding this rank's shard, taken from the local
        copy with no communication; a 0-d tensor stays the plain tensor
        every rank holds."""
        from repro_torch.launch.mesh import mesh_device
        t = t.to(mesh_device(self.mesh))
        if t.dim() == 0:
            return t
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(t, self.mesh, self.placements(),
                                 src_data_rank=None)


def place(tree, shardings):
    """``tree`` with each tensor that ``shardings`` (a tree of the same
    structure, :class:`NamedSharding` leaves, None for a subtree left as
    it is) names placed by it (the reference's ``device_put``)."""
    from repro_torch.checkpoint import ckpt
    if shardings is None:
        return tree
    where = dict(ckpt.flatten(shardings))
    leaves = [where[k].place(v) if torch.is_tensor(v) and k in where else v
              for k, v in ckpt.flatten(tree)]
    return ckpt.rebuild(tree, iter(leaves))


class _Constrain(torch.autograd.Function):
    """A DTensor redistributed to ``want``, and its gradient too."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.want = want
        return _placed_as(x, want).view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _placed_as(g, ctx.want), None


def _placed_as(x, want):
    return x if tuple(x.placements) == want else x.redistribute(
        x.device_mesh, want)


def constrain(x, *, batch_dim: int = 0, head_dim: int | None = None):
    """``x`` redistributed to :func:`activation_spec`'s placements on the
    active mesh, and its gradient to the same placements in the backward
    pass (the reference's ``with_sharding_constraint``, which constrains
    the cotangent as well: without it a partial sum flows back through
    the layers and DTensor may gather whole weights to meet it).
    Outside an :class:`activation_mesh`, on a mesh of one rank or
    without both a data and a model axis, or on a plain tensor, ``x``
    itself."""
    mesh = active_mesh()
    if (mesh is None or mesh.size() == 1 or not is_dtensor(x)
            or not {"data", "model"} <= set(mesh.mesh_dim_names)):
        return x
    spec = activation_spec(mesh, x.shape, batch_dim=batch_dim,
                           head_dim=head_dim)
    want = placements(spec, mesh)
    # an uneven split (heads padded over model) is left to the forward:
    # DTensor's views refuse a gradient split so
    if (not (torch.is_grad_enabled() and x.requires_grad)
            or _fit_spec(spec, x.shape, mesh) != spec):
        return _placed_as(x, want)
    return _Constrain.apply(x, want)


def whole_heads(x, n_heads: int):
    """``x`` (B, S, n_heads * hd) as a view into heads can take it: under a
    mesh whose model axis does not divide ``n_heads``, redistributed to
    its batch split alone (a last dimension split over model would cut
    heads, which DTensor's reshape refuses); else ``x`` itself."""
    mesh = active_mesh()
    if (mesh is None or not is_dtensor(x)
            or n_heads % _mesh_axis_sizes(mesh).get("model", 1) == 0):
        return x
    return constrain(x, batch_dim=0)


def _expand_pod(spec: tuple, mesh, batch_axes: bool = False) -> tuple:
    """Fold the pod axis in: batch dimensions split over ("pod", "data");
    parameters are replicated over pods."""
    if "pod" not in tuple(mesh.mesh_dim_names):
        return spec
    return tuple(("pod", "data") if batch_axes and ax == "data" else ax
                 for ax in spec)


def leaf_spec(mesh, key: str, shape) -> tuple:
    """The fitted spec of the reference's parameter leaf ``key`` (its
    path) of ``shape`` (stacked leaves with their layer axis)."""
    if key.endswith("embed") and len(shape) == 3:      # K audio codebooks
        spec = (None, "model", None)
    elif key.endswith("lm_head") and len(shape) == 3:
        spec = (None, None, "model")
    else:
        spec = next((s for pat, s in _PARAM_RULES if re.search(pat, key)),
                    None)
    if spec is None:
        return ()
    return _expand_pod(_fit_spec(spec, shape, mesh), mesh)


def param_shardings(mesh, cfg, shapes: dict) -> dict:
    """``{port parameter name: spec}`` for ``shapes`` (``{name: shape or
    tensor}``, or a module's parameters): each name's reference leaf
    path and shape (a stacked leaf's ``(n_super, *shape)``), its spec
    there, and for a stacked leaf that spec without the layer axis.
    Replicated leaves get ``()``."""
    from repro_torch.models import convert, transformer
    if isinstance(shapes, torch.nn.Module):
        shapes = dict(shapes.named_parameters())
    n_super = transformer.superblock_layout(cfg)[1]
    out = {}
    for name, t in shapes.items():
        shape = tuple(getattr(t, "shape", t))
        _, key, s = convert._ref_path(cfg, name)
        if s is None:
            out[name] = leaf_spec(mesh, key, shape)
        else:
            spec = leaf_spec(mesh, key, (n_super,) + shape)
            out[name] = spec[1:] if spec else ()
    return out


def batch_shardings(mesh, batch_shapes: dict) -> dict:
    """``{key: spec}`` of a batch: the leading dimension over (pod,
    data); M-RoPE positions ``(3, B, S)`` have the batch second."""
    out = {}
    for key, x in batch_shapes.items():
        shape = tuple(getattr(x, "shape", x))
        spec = (None, "data") if "mrope" in key else ("data",)
        out[key] = _expand_pod(_fit_spec(spec, shape, mesh), mesh,
                               batch_axes=True)
    return out


def cache_leaves(cfg, cache: list) -> list:
    """``(reference path, stacked, leaf)`` of every tensor of the port's
    per-layer cache (:func:`repro_torch.models.transformer.init_cache`),
    in layer order: an attention layer's ``.0`` / ``.1`` (K / V; an int8
    entry's ``.0.0`` values and ``.0.1`` scales), a recurrent layer's
    state fields by name, each under the reference's ``blocks.l<i>_<kind>``
    (stacked) or ``tail.t<i>_<kind>``."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.models import transformer
    pattern, n_super, _ = transformer.superblock_layout(cfg)
    span = len(pattern)
    out = []
    for n, entry in enumerate(cache):
        if n < n_super * span:
            i = n % span
            top, stacked = f"blocks.l{i}_{pattern[i]}", True
        else:
            i = n - n_super * span
            top, stacked = f"tail.t{i}_{pattern[i]}", False
        for path, leaf in ckpt.flatten(entry):
            out.append((f"{top}.{path}", stacked, leaf))
    return out


def cache_spec(mesh, shape, stacked: bool) -> tuple:
    """The reference's cache rule for one leaf of ``shape`` (a stacked
    leaf's with its layer axis): the batch over (pod, data); a 4-D leaf
    (a KV cache ``(B, S, K, hd)``, but a recurrent state of that rank as
    well) its third dimension over model."""
    nd = len(shape)
    batch_dim = 1 if stacked else 0
    spec: list = [None] * nd
    if nd > batch_dim:
        spec[batch_dim] = "data"
    if nd - (1 if stacked else 0) == 4:
        spec[batch_dim + 2] = "model"
    return _expand_pod(_fit_spec(tuple(spec), shape, mesh), mesh,
                       batch_axes=True)


def cache_shardings(mesh, cfg, cache: list) -> list:
    """Specs of the port's per-layer cache, as :func:`cache_leaves`
    lists its tensors: ``(reference path, spec)``, a stacked leaf's spec
    fitted to the stacked shape and given without the layer axis."""
    from repro_torch.models import transformer
    n_super = transformer.superblock_layout(cfg)[1]
    out = []
    for path, stacked, leaf in cache_leaves(cfg, cache):
        shape = tuple(leaf.shape)
        if stacked:
            out.append((path, cache_spec(mesh, (n_super,) + shape, True)[1:]))
        else:
            out.append((path, cache_spec(mesh, shape, False)))
    return out


def replicated(mesh) -> tuple:
    """The spec of a leaf every rank holds whole."""
    return ()


def lane_mesh(devices=None):
    """A 1-D ``("lanes",)`` mesh over independent batch lanes: the
    default group's ranks where one is up, else an
    :class:`~repro_torch.launch.mesh.AbstractMesh` over ``devices``
    (default every card, or the CPU without one).  The SoC trainer's
    scale-out (:mod:`repro_torch.soc.shard`) is pure data parallelism,
    lanes that never communicate."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    if devices is None and dist.is_initialized():
        from torch.distributed.device_mesh import init_device_mesh
        dev = "cuda" if torch.cuda.is_available() else "cpu"
        return init_device_mesh(dev, (dist.get_world_size(),),
                                mesh_dim_names=("lanes",))
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    else:
        n = len(list(devices))
    return mesh_lib.AbstractMesh((n,), ("lanes",))


# --------------------------------------------------------------------------
# Kernels on each rank's shard
# --------------------------------------------------------------------------
def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def kernel_placements(mesh, shape, *, batch_dim: int = 0,
                      head_dim: int | None = None) -> tuple:
    """Placements a kernel takes its operand in: the batch over (pod,
    data) and the heads (or channels) over model, each only where the
    axes divide it evenly; every other axis replicated."""
    spec = activation_spec(mesh, shape, batch_dim=batch_dim,
                           head_dim=head_dim)
    return placements(_fit_spec(spec, shape, mesh), mesh)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def local_call(fn, args, in_placements, out_placements, mesh):
    """``fn(*args)`` on each rank's local shards (``local_map``): DTensor
    arguments redistributed to ``in_placements``, plain tensors taken as
    the global value every rank holds (replicated), None passed through
    (its placement None); the outputs wrapped as DTensors placed by
    ``out_placements``, one placement tuple per output (one output: a
    tensor, not a tuple).  An argument replicated on a mesh axis along
    which another argument is split gets its gradient as a ``Partial``
    sum over that axis (each rank's backward sees only its part of the
    work); a split argument's gradient is split as the argument is.
    The local gradients are handed back contiguous: DTensor takes a
    local tensor's layout to be its global one."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    rep = [Replicate()] * mesh.ndim
    args = [DTensor.from_local(x, mesh, rep, run_check=False)
            if torch.is_tensor(x) and not is_dtensor(x) else x
            for x in args]
    split = [any(pl is not None and pl[i].is_shard() for pl in in_placements)
             for i in range(mesh.ndim)]
    grads = tuple(None if pl is None else tuple(
        Partial() if p.is_replicate() and split[i] else p
        for i, p in enumerate(pl)) for pl in in_placements)
    outs = tuple(list(pl) for pl in out_placements)
    local = lambda *a: fn(*(_ContiguousGrad.apply(x)
                            if torch.is_tensor(x) and x.requires_grad else x
                            for x in a))
    return local_map(local, out_placements=outs[0] if len(outs) == 1 else outs,
                     in_placements=tuple(in_placements),
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def embedding_lookup(table, ids):
    """``table[ids]`` on DTensors, each rank on its shards: its rows of
    ``ids`` (the batch over (pod, data)) looked up in its slice of the
    table's rows (the vocab over model, where the table is split so),
    rows outside the slice zero, the slices' outputs summed over model
    (a ``Partial`` the next constraint reduces).  DTensor's own indexing
    rule lacks a working backward (the gradient's ``index_put``) in some
    PyTorch releases; this one differentiates on local tensors."""
    from torch.distributed.tensor import Partial, Replicate
    mesh = table.device_mesh
    tp = tuple(table.placements)
    model = list(mesh.mesh_dim_names).index("model")
    split = tp[model].is_shard(0)
    ip = kernel_placements(mesh, ids.shape, batch_dim=0)
    op = tuple(Partial() if split and i == model else
               (Replicate() if i == model else p)
               for i, p in enumerate(sharded_like(ip, {0: 0})))
    rows = table.shape[0] // mesh.size(model) if split else 0
    first = mesh.get_local_rank(model) * rows if split else 0

    def local(t, i):
        if not split:
            return t[i]
        i = i - first
        inside = (i >= 0) & (i < t.shape[0])
        out = t[torch.where(inside, i, 0)]
        return torch.where(inside[..., None], out, 0)

    tp_in = tuple(Replicate() if i != model else p
                  for i, p in enumerate(tp))
    return local_call(local, (table, ids), (tp_in, ip), (op,), mesh)


def sharded_like(pls: tuple, dims: dict) -> tuple:
    """``pls`` with each ``Shard(d)`` renumbered to ``Shard(dims[d])``
    (a placement of another tensor that splits the same axes), dropped to
    ``Replicate()`` where ``dims`` has no ``d``."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(dims[p.dim]) if p.is_shard() and p.dim in dims
                 else (Replicate() if p.is_shard() else p) for p in pls)
