"""Function-approximation agent: a tiny packed ReLU MLP Q-network.

The tabular agent (:mod:`repro_torch.core.qlearn`) serves only the 243
Table-3 buckets it has visited; this agent maps normalized *sense
features* (footprint, tile count, active-accelerator, LLC and DDR
pressure, warmth, access pattern, compute per byte, deadline slack and
reuse distance) to a Q-row, trained by the paper's contextual-bandit
semi-gradient TD update ``delta = Q(s, a) - R``.  The same semantics as
``repro.soc.nn``:

  * every layer lives in one ``(rows, cols)`` float32 ``wpack`` (per
    layer ``nin`` weight rows then one bias row, columns padded to the
    widest output), which the fused episode keeps resident beside the
    Q-table;
  * the output layer starts at ``W = 0, b = q_init``, so an untrained
    network is an all-tie row (the Random policy under the randomized
    argmax), and a ``frozen_mlp_qstate`` placeholder attached to a table
    spec is a bitwise no-op;
  * non-finite weights give a non-finite Q-row, which the step's
    selection turns into NON_COH.

An :class:`MLPQState` carries a leading agent axis ``B`` on its tensor
leaves (``wpack (B, R, C)``, ``step (B,)``), as ``qlearn.QState`` does;
:func:`mlp_from_numpy` converts a reference ``MLPQState``.  The forward,
the TD update and the features run over that axis; every float sum runs
left to right, the order the reference compiled without fused
multiply-add uses, and ``log2`` is XLA's ``log``
(:mod:`repro_torch.xla_math`) times the float32 reciprocal of ``log(2)``,
the product XLA folds ``jnp.log2``'s division by that constant into, so
the plain version, the CUDA kernel and that reference round alike.

:func:`train_portfolio` trains ONE network across (SoC x app) pairs with
per-iteration federated averaging; ``benchmarks/torch_fig13_generalize.
py`` scores it and a shared Q-table on held-out apps and SoCs.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch import xla_math
from repro_torch.xla_math import f32 as _f32
from repro_torch.core.modes import N_MODES
from repro_torch.core.policies import Policy
from repro_torch.core.state import N_STATES
from repro_torch.ordered import seqsum, true_div, xla_sum
from repro_torch.soc.accelerators import IRREGULAR, PF

# Width of the "sense" embedding; the order of the features is part of
# the spec (the CUDA kernel builds the same vector).
N_SENSE_FEATURES = 14
# jnp.log2 is log(x) / log(2); XLA turns a division by a constant into a
# product with its float32 reciprocal (also the tile fraction's 1 / n_tiles).
_INV_LN2 = float(np.float32(1.0) / np.float32(np.log(2.0)))


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    """Network architecture.  ``features`` is ``"sense"`` (the 14
    normalized features) or ``"onehot"`` (the Table-3 state index as a
    243-wide one-hot vector: with ``hidden=()`` an exact
    re-parameterization of a Q-table); ``lr`` is the default learning
    rate scale :func:`init_mlp_qstate` gives the state."""

    features: str = "sense"
    hidden: tuple = (16, 16)
    lr: float = 0.05

    def __post_init__(self):
        object.__setattr__(self, "hidden", tuple(int(h) for h in self.hidden))
        if self.features not in ("sense", "onehot"):
            raise ValueError(f"unknown feature embedding {self.features!r}")


class MLPQState(NamedTuple):
    """``B`` function-approximation agents.  ``lr`` scales the decayed
    alpha of the tabular schedule into the TD step size; ``step`` and
    ``frozen`` drive that schedule as the tabular counters do."""

    wpack: torch.Tensor   # (B, R, C) float32 packed weights
    lr: torch.Tensor      # (B,) float32
    step: torch.Tensor    # (B,) int32
    frozen: torch.Tensor  # (B,) bool
    cfg: MLPConfig


def mlp_dims(cfg: MLPConfig) -> tuple:
    """Layer widths ``(n_in, *hidden, n_actions)``."""
    n_in = N_SENSE_FEATURES if cfg.features == "sense" else N_STATES
    return (n_in, *cfg.hidden, N_MODES)


def pack_shape(dims: Sequence[int]) -> tuple:
    """``(rows, cols)`` of the packed weights: ``dims[l]`` weight rows and
    one bias row per layer, columns padded to the widest output."""
    return sum(d + 1 for d in dims[:-1]), max(dims[1:])


def _layers(dims):
    """``(row offset, nin, nout)`` of each layer in the pack."""
    out, off = [], 0
    for nin, nout in zip(dims[:-1], dims[1:]):
        out.append((off, nin, nout))
        off += nin + 1
    return out


def forward_layers(wpack, x, dims):
    """Every layer's output of ``B`` networks: ``[x, h1, ..., q]``."""
    hs = [x]
    last = len(dims) - 2
    for l, (off, nin, nout) in enumerate(_layers(dims)):
        w = wpack[:, off:off + nin, :nout]
        z = (xla_sum((w * hs[-1][:, :, None]).transpose(1, 2))
             + wpack[:, off + nin, :nout])
        hs.append(z if l == last else torch.clamp(z, min=0.0))
    return hs


def forward_packed(wpack, x, dims) -> torch.Tensor:
    """Q-rows ``(B, n_actions)`` of ``B`` networks ``wpack (B, R, C)`` at
    features ``x (B, n_in)``; each layer's product is the broadcast sum
    ``sum(W * h[:, None], 0)`` over the rows in the order the reference's
    ``jnp.sum`` takes on the CPU (:func:`~repro_torch.ordered.xla_sum`: in
    order up to 32 rows, in windows of 32 past that; exact for one-hot
    inputs, where the off rows add signed zeros)."""
    return forward_layers(wpack, x, dims)[-1]


def td_update_packed(wpack, x, action, reward, lr_eff, dims, gate):
    """One semi-gradient TD step of ``B`` networks: ``delta = Q(x, a) -
    R`` backpropagated by hand over the pack.  ``action``, ``reward``,
    ``lr_eff`` and ``gate`` are ``(B,)``.  A network is updated only where
    ``gate`` holds, ``lr_eff > 0`` and ``delta`` is finite, by selecting
    (``0 * NaN`` is NaN, so a multiplicative gate would poison the
    pack)."""
    return td_update_from(wpack, forward_layers(wpack, x, dims), action,
                          reward, lr_eff, dims, gate)


def td_update_from(wpack, hs, action, reward, lr_eff, dims, gate):
    """:func:`td_update_packed` from the forward's layer outputs ``hs``
    (:func:`forward_layers`), which the fused step has already computed.
    The backward sums a row over a layer's outputs as the reference's
    ``jnp.sum`` over that minor axis runs on the CPU
    (:func:`~repro_torch.ordered.xla_sum`: in order up to 32 outputs, in
    windows of 32 past that)."""
    f32 = torch.float32
    n_act = dims[-1]
    hot = (torch.arange(n_act, device=wpack.device)[None, :]
           == action[:, None].long()).to(f32)
    delta = seqsum(hs[-1] * hot, -1) - reward
    g = hot * delta[:, None]
    grad = torch.zeros_like(wpack)
    layers = _layers(dims)
    for l in range(len(layers) - 1, -1, -1):
        off, nin, nout = layers[l]
        grad[:, off:off + nin, :nout] = hs[l][:, :, None] * g[:, None, :]
        grad[:, off + nin, :nout] = g
        if l > 0:
            w = wpack[:, off:off + nin, :nout]
            g = xla_sum(w * g[:, None, :]) * (hs[l] > 0.0).to(f32)
    ok = gate & torch.isfinite(delta) & (lr_eff > 0.0)
    return torch.where(ok[:, None, None],
                       wpack - lr_eff[:, None, None] * grad, wpack)


def step_features(feats: str, s, state_idx, *, footprint, tiles, omask,
                  omodes, ofps, odram, warm_t, profile, slack, reuse):
    """The per-invocation input embedding of ``B`` steps, ``(B, n_in)``.

    ``"onehot"`` embeds the sensed Table-3 index; ``"sense"`` builds the
    14 features from the step's own footprint, tiles and profile, the
    concurrent slots (``omask``, ``omodes``, ``ofps``, ``odram``, each
    ``(B, T)``, inactive slots masked), the warmth and the serving
    signals ``slack``/``reuse`` (zero on the episodic path).  ``s`` holds
    ``(B,)`` SoCStatic scalars."""
    f32 = torch.float32
    if feats == "onehot":
        return (torch.arange(N_STATES, device=state_idx.device)[None, :]
                == state_idx[:, None].long()).to(f32)
    llc_total = s.llc_slice_bytes * s.n_mem_tiles
    inv_nt = float(np.float32(1.0) / np.float32(tiles.shape[-1]))
    fp = footprint.to(f32)
    cached = omask & (omodes > 0)
    non_coh = omask & (omodes == 0)
    slack = torch.as_tensor(slack, dtype=f32, device=fp.device)
    reuse = torch.as_tensor(reuse, dtype=f32, device=fp.device)
    sl = (slack * _f32(1e-6)).expand_as(fp)
    ru = (reuse * _f32(1e-6)).expand_as(fp)
    clip4 = lambda v: torch.clamp(v, 0.0, 4.0) * 0.25
    log2 = lambda v: xla_math.log(v) * _INV_LN2
    cols = [
        log2(1.0 + fp) * _f32(1.0 / 32.0),
        clip4(fp / s.l2_bytes),
        clip4(fp / llc_total),
        seqsum(tiles.to(f32), -1) * inv_nt,
        seqsum(omask.to(f32), -1) * 0.125,
        seqsum(cached.to(f32), -1) * 0.125,
        seqsum(non_coh.to(f32), -1) * 0.125,
        clip4(seqsum(ofps, -1) / llc_total),
        clip4(seqsum(odram, -1) / s.dram_bw),
        warm_t.to(f32),
        (profile[:, PF.PATTERN] == float(IRREGULAR)).to(f32),
        log2(1.0 + profile[:, PF.COMPUTE]) * 0.125,
        sl / (1.0 + sl.abs()),
        ru / (1.0 + ru.abs()),
    ]
    return torch.stack(cols, dim=-1)


# --------------------------------------------------------------------------
# State constructors
# --------------------------------------------------------------------------

def _state(wpack, lr, frozen: bool, cfg: MLPConfig) -> MLPQState:
    b, dev = wpack.shape[0], wpack.device
    return MLPQState(
        wpack=wpack,
        lr=torch.as_tensor(lr, dtype=torch.float32, device=dev).expand(
            b).clone(),
        step=torch.zeros((b,), dtype=torch.int32, device=dev),
        frozen=torch.full((b,), frozen, dtype=torch.bool, device=dev),
        cfg=cfg)


def init_mlp_qstate(key, cfg: MLPConfig = MLPConfig(),
                    q_init: float = 1.0) -> MLPQState:
    """Fresh trainable networks, one per key (``key (2,)`` gives a batch
    of one, ``(B, 2)`` a batch of B), on the key's device: He-scaled
    Gaussian hidden layers, the output layer ``W = 0, b = q_init`` (an
    all-tie Q-row everywhere)."""
    key = key.reshape(-1, 2)
    dims = mlp_dims(cfg)
    rows, cols = pack_shape(dims)
    wpack = torch.zeros((key.shape[0], rows, cols), dtype=torch.float32,
                        device=key.device)
    layers = _layers(dims)
    for l, (off, nin, nout) in enumerate(layers):
        if l == len(layers) - 1:
            wpack[:, off + nin, :nout] = _f32(q_init)
        else:
            ks = prng.split(key)
            key, sub = ks[:, 0], ks[:, 1]
            w = prng.normal(sub, (nin, nout))
            wpack[:, off:off + nin, :nout] = w * _f32(np.sqrt(2.0 / nin))
    return _state(wpack, _f32(cfg.lr), False, cfg)


def frozen_mlp_qstate(cfg: MLPConfig = MLPConfig(), q_init: float = 1.0,
                      device=None) -> MLPQState:
    """The inert placeholder (a batch of one) of table specs that share a
    batch with MLP specs: deterministic, frozen, zero learning rate."""
    dims = mlp_dims(cfg)
    rows, cols = pack_shape(dims)
    wpack = torch.zeros((1, rows, cols), dtype=torch.float32, device=device)
    wpack[:, rows - 1, :dims[-1]] = _f32(q_init)
    return _state(wpack, 0.0, True, cfg)


def freeze(mlp: MLPQState) -> MLPQState:
    """Disable further updates (evaluate the converged networks)."""
    return mlp._replace(frozen=torch.ones_like(mlp.frozen))


def mlp_from_qtable(qtable, lr: float = 0.0) -> MLPQState:
    """Distill Q-tables ``(243, A)`` or ``(B, 243, A)`` into exactly
    equivalent linear networks: one-hot embedding, no hidden layer,
    weights = the table, biases = 0 (the forward reduces to the table row
    plus signed zeros)."""
    qtable = torch.as_tensor(qtable, dtype=torch.float32)
    if qtable.dim() == 2:
        qtable = qtable[None]
    b, n_states, n_actions = qtable.shape
    cfg = MLPConfig(features="onehot", hidden=(), lr=float(lr))
    rows, cols = pack_shape(mlp_dims(cfg))
    assert (rows, cols) == (n_states + 1, n_actions)
    wpack = torch.zeros((b, rows, cols), dtype=torch.float32,
                        device=qtable.device)
    wpack[:, :n_states] = qtable
    return _state(wpack, _f32(lr), False, cfg)


def mlp_from_numpy(wpack, lr, step, frozen, cfg, device=None) -> MLPQState:
    """A port MLPQState from a reference ``MLPQState``'s leaves (numpy
    arrays with leading batch axes or none: an unbatched state gains a
    batch axis of one) and its config (anything with ``features``,
    ``hidden`` and ``lr``)."""
    batched = np.ndim(wpack) >= 3

    def lift(a, dt):
        a = np.array(a, dt)
        return torch.as_tensor(a if batched else a[None], device=device)

    return MLPQState(wpack=lift(wpack, np.float32), lr=lift(lr, np.float32),
                     step=lift(step, np.int32), frozen=lift(frozen, np.bool_),
                     cfg=MLPConfig(features=cfg.features,
                                   hidden=tuple(cfg.hidden),
                                   lr=float(cfg.lr)))


def cat_mlps(states: Sequence[MLPQState]) -> MLPQState:
    """Concatenate batches of agents of one architecture."""
    cfg = states[0].cfg
    if any(s.cfg != cfg for s in states):
        raise ValueError("cannot batch networks of different architectures: "
                         f"{sorted({str(s.cfg) for s in states})}")
    return MLPQState(*(torch.cat(vs) for vs in zip(*(s[:4] for s in states))),
                     cfg=cfg)


def expand_mlp(mlp: MLPQState, n: int) -> MLPQState:
    """A batch of one repeated ``n`` times."""
    return MLPQState(*(v.expand(n, *v.shape[1:]).contiguous()
                       for v in mlp[:4]), cfg=mlp.cfg)


class MLPQPolicy(Policy):
    """The function-approximation agent behind the Policy interface.

    ``decide`` (the discrete-event simulator's hook) builds the feature
    vector the batched step feeds :func:`step_features` — the concurrent
    set in ``n_accs`` slots, zero DDR demand — and takes the greedy
    argmax of the network's Q-row over the available modes, NON_COH on a
    non-finite row; it runs where the network lives.  ``lower`` emits the
    ``qfun`` spec (greedy once the network is frozen)."""

    name = "cohmeleon-mlp"

    def __init__(self, mlp: MLPQState | None = None,
                 cfg: MLPConfig = MLPConfig(), seed: int = 0, device=None):
        self.mlp = (mlp if mlp is not None else init_mlp_qstate(
            prng.PRNGKey(seed, device=device), cfg))
        self._static = (None, None, None)   # (SoC, device, its constants)

    def decide(self, ctx) -> int:
        from repro_torch.soc.memsys import SoCStatic, static_tensors
        dev = self.mlp.wpack.device
        if self._static[0] is not ctx.soc or self._static[1] != dev:
            self._static = (ctx.soc, dev, static_tensors(
                SoCStatic.from_config(ctx.soc), 1, dev))
        s = self._static[2]
        n_accs = ctx.soc.n_accs
        omodes = np.full((1, n_accs), -1, np.int32)
        ofps = np.zeros((1, n_accs), np.float32)
        afps = (ctx.active_footprints if ctx.active_footprints is not None
                else [0.0] * len(ctx.active_modes))
        for i, (m, fp) in enumerate(zip(ctx.active_modes, afps)):
            if i >= n_accs:
                break
            omodes[0, i] = m
            ofps[0, i] = fp
        tiles = (np.asarray(ctx.target_tiles, bool)
                 if ctx.target_tiles is not None
                 else np.zeros((ctx.soc.n_mem_tiles,), bool))
        profile = (np.asarray(ctx.profile, np.float32)
                   if ctx.profile is not None
                   else np.zeros((len(PF._fields),), np.float32))
        t = lambda a: torch.as_tensor(np.asarray(a), device=dev)
        omodes_t = t(omodes)
        feats = step_features(
            self.mlp.cfg.features, s,
            t(np.asarray([ctx.state_idx], np.int32)),
            footprint=t(np.asarray([ctx.footprint], np.float32)),
            tiles=t(tiles[None]), omask=omodes_t >= 0, omodes=omodes_t,
            ofps=t(ofps), odram=torch.zeros((1, n_accs), device=dev),
            warm_t=t(np.asarray([ctx.warm], np.float32)),
            profile=t(profile[None]),
            slack=t(np.float32(ctx.slack)), reuse=t(np.float32(ctx.reuse)))
        row = forward_packed(self.mlp.wpack, feats,
                             mlp_dims(self.mlp.cfg))[0].cpu().numpy()
        if not np.all(np.isfinite(row)):
            return 0  # NON_COH fallback, as the batched selection does
        return int(np.argmax(np.where(np.asarray(ctx.available, bool), row,
                                      -np.inf)))

    def lower(self, env, compiled):
        from repro_torch.soc import vecenv as vec
        mlp = MLPQState(*(v.to(env.device) for v in self.mlp[:4]),
                        cfg=self.mlp.cfg)
        return vec.mlp_policy_spec(mlp, env._sched(compiled))


# --------------------------------------------------------------------------
# Portfolio training: one shared network across (apps x SoCs)
# --------------------------------------------------------------------------

def train_portfolio(items, cfg, *, iterations: int = 6, batch: int = 2,
                    mcfg: MLPConfig = MLPConfig(), key=None,
                    weights=None, mlp: MLPQState | None = None,
                    manager=None):
    """Train ONE shared network across a portfolio of ``(VecEnv,
    [CompiledApp, ...])`` pairs, ``repro.soc.nn.train_portfolio``'s
    protocol.

    Each iteration runs, for every pair, one launch of ``batch`` training
    episodes (keys split from ``key`` folded with the iteration and the
    pair; the pair's apps rotate by iteration) from the current shared
    weights, then averages the ``pairs x batch`` trained packs (FedAvg,
    summed in lane order) and advances the shared step by the mean
    increment (truncated).  ``cfg`` is the tabular ``QConfig`` whose
    decay protocol the network follows.  With ``manager`` (a
    :class:`~repro_torch.checkpoint.manager.CheckpointManager`) the
    ``(network, history, iterations done)`` snapshot is saved after each
    iteration and restored on entry, so a killed and resumed run ends
    bitwise equal to an uninterrupted one.  Returns ``(mlp (a batch of
    one), history (iterations,))``, the history being the mean training
    reward across the portfolio."""
    from repro_torch.core import rewards
    from repro_torch.soc import vecenv as vec
    dev = items[0][0].device
    key = (prng.PRNGKey(0) if key is None else key).to(dev)
    weights = weights if weights is not None else (
        rewards.PAPER_DEFAULT_WEIGHTS)
    if mlp is None:
        ks = prng.split(key)
        key, mlp = ks[0], init_mlp_qstate(ks[1], mcfg)
    hist = torch.zeros((iterations,), dtype=torch.float32)
    done = 0
    if manager is not None and manager.latest_step() is not None:
        state = manager.restore({"mlp": mlp._replace(cfg=None), "hist": hist,
                                 "done": 0})
        mlp = state["mlp"]._replace(cfg=mlp.cfg)
        hist, done = state["hist"], int(state["done"])
    n_items = len(items)
    for it in range(done, iterations):
        packs, steps, rs = [], [], []
        for j, (env, comps) in enumerate(items):
            comp = comps[it % len(comps)]
            sched = env._sched(comp)
            spec = vec.expand_spec(vec.mlp_policy_spec(mlp, sched), batch)
            ks = prng.split(prng.fold_in(key, it * n_items + j), batch)
            (_, mlp_f), res = env._run(comp, sched, spec, cfg, weights, ks)
            valid = sched.valid
            mean_r = (xla_sum(torch.where(valid, res.reward, 0.0))
                      / torch.clamp(valid.to(torch.float32).sum(), min=1.0))
            packs.append(mlp_f.wpack)
            steps.append(mlp_f.step)
            rs.append(mean_r)
        wall = torch.cat(packs)
        n = float(wall.shape[0])
        step = true_div(seqsum(torch.cat(steps).to(torch.float32), 0),
                        n).to(torch.int32)
        mlp = mlp._replace(wpack=true_div(seqsum(wall, 0), n)[None],
                           step=step.reshape(1))
        hist[it] = true_div(xla_sum(torch.cat(rs)), n).cpu()
        if manager is not None:
            manager.save(it + 1, {"mlp": mlp._replace(cfg=None),
                                  "hist": hist, "done": it + 1})
    if manager is not None:
        manager.wait()
    return mlp, hist
