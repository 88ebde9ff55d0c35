"""Tabular Q-learning agent (paper §4.2), batched over agents.

  * Q-table of |S| x |A| = 243 x 4 entries, optimistically initialized.
  * epsilon-greedy selection with presampled randomness
    (:class:`SelectNoise`): explore with probability epsilon, otherwise a
    randomized argmax over the masked Q-row.
  * Update ``Q(s,a) <- (1-alpha) Q(s,a) + alpha R(s,a)`` with the paper's
    immediate reward (no bootstrapped term).
  * epsilon and alpha decay linearly to zero over ``decay_steps``
    invocations; the fused episode precomputes them per step
    (:func:`decay_arrays`) and rebuilds visit counts from the trace
    (:func:`replay_visits`).
  * the discrete-event simulator's agent decides and learns one
    invocation at a time (:func:`schedule`, :func:`select`,
    :func:`update`), drawing its select randomness from a key per call.

A :class:`QState` here carries a leading agent axis ``B`` on every leaf
(``qtable (B, S, A)``, ``step (B,)``); :func:`qstate_from_numpy` /
:func:`qstate_to_numpy` convert the arrays of a JAX ``QState``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from perfbench.reference import prng
from perfbench.reference.modes import CoherenceMode, N_MODES
from perfbench.reference.state import N_STATES
from perfbench.reference.ordered import true_div

_NEG = float(np.float32(-3.4e38))
_TIE = float(np.float32(1e-9))
# The degradation-safe fallback action: always available by construction.
_FALLBACK = int(CoherenceMode.NON_COH_DMA)


class QConfig(NamedTuple):
    n_states: int = N_STATES
    n_actions: int = N_MODES
    epsilon0: float = 0.5
    alpha0: float = 0.25
    decay_steps: int = 3000
    q_init: float = 1.0
    collapse_frac: float = 0.0
    reopen_frac: float = 0.5


class QState(NamedTuple):
    qtable: torch.Tensor   # (B, S, A) float32
    visits: torch.Tensor   # (B, S, A) int32
    step: torch.Tensor     # (B,) int32
    frozen: torch.Tensor   # (B,) bool


def init_qstate_batch(cfg: QConfig, batch: int, device=None) -> QState:
    """``batch`` fresh agents."""
    return QState(
        qtable=torch.full((batch, cfg.n_states, cfg.n_actions), cfg.q_init,
                          dtype=torch.float32, device=device),
        visits=torch.zeros((batch, cfg.n_states, cfg.n_actions),
                           dtype=torch.int32, device=device),
        step=torch.zeros((batch,), dtype=torch.int32, device=device),
        frozen=torch.zeros((batch,), dtype=torch.bool, device=device))


def init_qstate(cfg: QConfig = QConfig(), device=None) -> QState:
    """One fresh agent (a batch of one)."""
    return init_qstate_batch(cfg, 1, device)


def freeze(qs: QState) -> QState:
    """Disable further updates (paper: evaluate the converged model)."""
    return qs._replace(frozen=torch.ones_like(qs.frozen))


def frozen_qstate(cfg: QConfig = QConfig(), device=None) -> QState:
    """A frozen, untrained table: the Random policy's lowering and the
    inert placeholder agent of non-learned policy specs."""
    return freeze(init_qstate(cfg, device))


def qstate_from_numpy(qtable, visits, step, frozen, device=None) -> QState:
    """A port QState from a JAX QState's arrays, batched or not (an
    unbatched state gains a batch axis of one)."""
    batched = np.ndim(qtable) == 3

    def lift(a, dt):
        a = np.array(a, dt)
        return torch.as_tensor(a if batched else a[None], device=device)

    return QState(qtable=lift(qtable, np.float32),
                  visits=lift(visits, np.int32),
                  step=lift(step, np.int32),
                  frozen=lift(frozen, np.bool_))


def qstate_to_numpy(qs: QState) -> dict:
    """The four leaves as numpy arrays (batched)."""
    return {k: v.detach().cpu().numpy() for k, v in qs._asdict().items()}


def cat_qstates(states) -> QState:
    return QState(*(torch.cat(vs) for vs in zip(*states)))


class SelectNoise(NamedTuple):
    """Presampled select randomness: ``u_explore (..., )`` uniform,
    ``g_pick``/``g_tie (..., A)`` gumbel."""

    u_explore: torch.Tensor
    g_pick: torch.Tensor
    g_tie: torch.Tensor


def sample_select_noise(key: torch.Tensor, shape_prefix: tuple,
                        n_actions: int = N_MODES) -> SelectNoise:
    """One episode's select noise per key: ``key (..., 2)`` gives leaves
    ``(..., *shape_prefix[, A])``, the same variates
    ``repro.core.qlearn.sample_select_noise`` draws from that key."""
    ks = prng.split(key, 3)
    return SelectNoise(
        u_explore=prng.uniform(ks[..., 0, :], tuple(shape_prefix)),
        g_pick=prng.gumbel(ks[..., 1, :], (*shape_prefix, n_actions)),
        g_tie=prng.gumbel(ks[..., 2, :], (*shape_prefix, n_actions)))


def _recip_f32(d) -> float:
    """``1 / d`` rounded to float32, as XLA folds a division by the
    compile-time constant ``d`` into a product with its reciprocal."""
    return float(np.float32(1.0) / np.float32(d))


def schedule(cfg: QConfig, step):
    """Linearly decayed ``(epsilon, alpha)`` at ``step (B,)``, as the
    reference's per-decision agent computes them: its jitted ``select``
    and ``update`` hold ``cfg.decay_steps`` as a compile-time constant, so
    ``step / decay_steps`` runs as ``step * float32(1 / decay_steps)``
    (the batched episode, which passes ``cfg`` as an argument, divides:
    :func:`decay_arrays`)."""
    frac = torch.clamp(1.0 - step.to(torch.float32)
                       * _recip_f32(cfg.decay_steps), 0.0, 1.0)
    return frac * float(np.float32(cfg.epsilon0)), frac * float(
        np.float32(cfg.alpha0))


def select(qs: QState, cfg: QConfig, state_idx, key, action_mask=None):
    """epsilon-greedy actions ``(B,)`` of ``B`` agents in states
    ``state_idx (B,)`` from keys ``key (B, 2)``: each key splits three
    ways (explore, pick, tie), and ``categorical(k, logits)`` is
    ``argmax(logits + gumbel(k))`` as in ``jax.random``.  Ties within
    1e-9 of the masked row's max break at random; a non-finite row falls
    back to NON_COH."""
    if action_mask is None:
        action_mask = torch.ones((cfg.n_actions,), dtype=torch.bool,
                                 device=qs.qtable.device)
    eps, _ = schedule(cfg, qs.step)
    eps = torch.where(qs.frozen, 0.0, eps)
    row = qs.qtable[torch.arange(qs.qtable.shape[0],
                                 device=qs.qtable.device), state_idx.long()]
    return row_select_presampled(row, eps, key_noise(key, cfg.n_actions),
                                 action_mask)


def key_noise(key, n_actions: int = N_MODES) -> SelectNoise:
    """The select randomness one key ``(..., 2)`` gives ``select``: the
    key splits three ways (explore, pick, tie) and ``categorical(k,
    logits)`` is ``argmax(logits + gumbel(k))`` as in ``jax.random``.  The
    three draws run in one hash: a draw of shape () is counter 0 of its
    key, a draw of shape (A,) counters 0..A-1."""
    bits = prng.random_bits(prng.split(key, 3), (n_actions,))
    g = prng.gumbel_from_bits(bits[..., 1:, :])
    return SelectNoise(u_explore=prng.uniform_from_bits(bits[..., 0, 0]),
                       g_pick=g[..., 0, :], g_tie=g[..., 1, :])


def update(qs: QState, cfg: QConfig, state_idx, action, reward) -> QState:
    """The paper update of ``B`` agents at ``(state_idx, action)`` with
    ``reward`` (each ``(B,)``): the decayed alpha blends the reward into
    the row (:func:`row_update`; a non-finite reward leaves it intact);
    a frozen agent's table, visits and step stay as they are."""
    _, alpha = schedule(cfg, qs.step)
    alpha = torch.where(qs.frozen, 0.0, alpha)
    b = torch.arange(qs.qtable.shape[0], device=qs.qtable.device)
    s_idx = state_idx.long()
    new_row = row_update(qs.qtable[b, s_idx], alpha, action,
                         reward.to(torch.float32))
    inc = (~qs.frozen).to(torch.int32)
    hot = (torch.arange(qs.visits.shape[-1], device=qs.visits.device)
           == action[..., None]).to(torch.int32)
    qtable = qs.qtable.clone()
    visits = qs.visits.clone()
    qtable[b, s_idx] = new_row
    visits[b, s_idx] = qs.visits[b, s_idx] + hot * inc[:, None]
    return QState(qtable=qtable, visits=visits, step=qs.step + inc,
                  frozen=qs.frozen)


def _argmax_first(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum along the last axis."""
    best = x[..., 0]
    idx = torch.zeros(x.shape[:-1], dtype=torch.int32, device=x.device)
    for a in range(1, x.shape[-1]):
        better = x[..., a] > best
        best = torch.where(better, x[..., a], best)
        idx = torch.where(better, a, idx)
    return idx


def row_select_presampled(row, eps, noise: SelectNoise, action_mask):
    """epsilon-greedy action from a pre-gathered Q-row ``(..., A)`` with
    precomputed ``eps (...)``; ties within 1e-9 of the row max break by
    ``g_tie``, exploration draws by ``g_pick``, and a non-finite row falls
    back to NON_COH."""
    mrow = torch.where(action_mask, row, _NEG)
    is_max = mrow >= mrow.amax(-1, keepdim=True) - _TIE
    tie_logits = torch.where(is_max & action_mask, 0.0, _NEG)
    greedy = _argmax_first(tie_logits + noise.g_tie)
    logits = torch.where(action_mask, 0.0, _NEG)
    random_action = _argmax_first(logits + noise.g_pick)
    choice = torch.where(noise.u_explore < eps, random_action, greedy)
    finite = torch.isfinite(row).all(-1)
    return torch.where(finite, choice, _FALLBACK).to(torch.int32)


def row_update(row, alpha, action, reward):
    """The paper update on a pre-gathered row ``(..., A)``: the blended row
    to write back.  A non-finite reward leaves the row intact."""
    ok = torch.isfinite(reward)
    alpha = torch.where(ok, alpha, 0.0)
    reward = torch.where(ok, reward, 0.0)
    hot = (torch.arange(row.shape[-1], device=row.device)
           == action[..., None])
    blend = ((1.0 - alpha)[..., None] * row
             + (alpha * reward)[..., None])
    return torch.where(hot, blend, row)


def _decay_steps_f32(cfg: QConfig):
    """``cfg.decay_steps`` as float32: a number, or a ``(B,)`` tensor of
    per-agent horizons shaped to broadcast over a ``(B, S)`` trace."""
    if torch.is_tensor(cfg.decay_steps):
        return cfg.decay_steps.to(torch.float32)[:, None]
    return float(np.float32(cfg.decay_steps))


def decay_arrays(cfg: QConfig, step0, frozen, inc):
    """Per-step ``(eps_t, alpha_t)`` over an episode, ``inc (B, S)`` the
    per-step counter increments, ``step0``/``frozen (B,)``;
    ``cfg.decay_steps`` may be a ``(B,)`` tensor."""
    inc = inc.to(torch.int32)
    step_t = step0[:, None] + torch.cumsum(inc, -1, dtype=torch.int32) - inc
    d = _decay_steps_f32(cfg)
    step_f = step_t.to(torch.float32)
    frac = torch.clamp(1.0 - (step_f / d if torch.is_tensor(d)
                              else true_div(step_f, d)), 0.0, 1.0)
    fz = frozen[:, None]
    eps_t = torch.where(fz, 0.0, cfg.epsilon0 * frac)
    alpha_t = torch.where(fz, 0.0, cfg.alpha0 * frac)
    return eps_t, alpha_t


def replay_visits(qs0: QState, qtable, state_idx, action, inc) -> QState:
    """The post-episode QState: the trained table plus visits/step rebuilt
    from the ``(B, S)`` trace with one scatter-add (integer adds commute,
    so this equals in-scan accumulation)."""
    inc = inc.to(torch.int32)
    b, n_s, n_a = qs0.visits.shape
    flat = qs0.visits.reshape(b, n_s * n_a).clone()
    flat.scatter_add_(1, (state_idx.long() * n_a + action.long()), inc)
    return QState(qtable=qtable, visits=flat.reshape(b, n_s, n_a),
                  step=qs0.step + inc.sum(-1, dtype=torch.int32),
                  frozen=qs0.frozen)


def reopen_step(cfg: QConfig, step):
    """The decay-counter value that re-opens epsilon/alpha to
    ``cfg.reopen_frac`` of their initial values (never advancing)."""
    target = int(np.float32(np.float32(cfg.decay_steps)
                            * np.float32(1.0 - cfg.reopen_frac)))
    return torch.clamp(step, max=target)


def reward_watchdog(cfg: QConfig, qs: QState, ep_reward, best):
    """Reward-collapse watchdog: wind the decay counter back when an
    episode's mean reward ``ep_reward (B,)`` drops below
    ``collapse_frac`` of the running ``best (B,)``.  With
    ``collapse_frac == 0`` (the default) the state is returned unchanged.
    Returns ``(new_qs, new_best)``."""
    ep_reward = ep_reward.to(torch.float32)
    enabled = float(np.float32(cfg.collapse_frac)) > 0.0
    collapsed = (enabled & ~qs.frozen & (best > 0.0)
                 & (ep_reward < float(np.float32(cfg.collapse_frac))
                    * best))
    new_qs = qs._replace(step=torch.where(collapsed, reopen_step(cfg,
                                                                 qs.step),
                                          qs.step))
    new_best = torch.where(collapsed, ep_reward,
                           torch.maximum(best, ep_reward))
    return new_qs, new_best


