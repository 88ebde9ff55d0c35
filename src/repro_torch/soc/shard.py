"""Data-parallel scale-out of the batched SoC entry points over devices.

:class:`~repro_torch.soc.vecenv.VecEnv` and
:class:`~repro_torch.soc.stacked.StackedVecEnv` already batch (SoC lanes
x reward weights x seeds) into one kernel launch; this module splits that
batch across devices.  The batch entries are fully independent (no
collectives), so the batch axis is cut into one contiguous chunk per
device, each chunk runs the unmodified call on its device (an environment
twin there, built from the same SoCs and profiles) and the results are
concatenated on the first device:

  * :func:`sharded_train_batched` splits ``VecEnv.train_batched`` over the
    agent axis B;
  * :func:`sharded_train_batched_stacked` splits
    ``StackedVecEnv.train_batched`` over the agent axis B of its (K, B)
    grid (every device keeps all K lanes);
  * :func:`sharded_episodes` and :func:`sharded_serve` split
    ``StackedVecEnv.episodes`` / ``serve`` over the policy axis N of
    their (K, N) spec grid (the whole offered stream on every device).

A ``FaultSpec`` or ``TrafficSpec`` is copied to every device.  With one
device, or a batch that does not divide the device count, the wrappers
make the plain call.  ``force=True`` splits even on one device; passing
``devices`` such as ``[cuda:0, cuda:0]`` (or ``[cpu, cpu]``) runs two
chunks on one device.  Each episode runs one warp of the episode kernel
and the plain path's reductions are per agent, so a split equals the
plain call bitwise.
"""
from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["lane_devices", "sharded_train_batched",
           "sharded_train_batched_stacked", "sharded_episodes",
           "sharded_serve"]


def lane_devices(devices: Sequence | None = None) -> list[torch.device]:
    """The devices a batch is split over: ``devices`` as given, else
    every visible CUDA device."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def _use_devices(devices, batch: int, force: bool):
    """The device list, or None for the plain call."""
    devs = lane_devices(devices)
    n = len(devs)
    if n == 0 or batch % n != 0 or (n == 1 and not force):
        return None
    return devs


def _same_device(a, b) -> bool:
    """``a`` and ``b`` name one device; a CUDA device without an index is
    the current one (``cuda`` and ``cuda:0`` agree on card 0)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device
    return ((cur() if a.index is None else a.index)
            == (cur() if b.index is None else b.index))


def _env_on(env, dev: torch.device):
    """``env`` itself on its own device, else a twin on ``dev`` (same
    SoCs, resolved profiles and step flags)."""
    if _same_device(dev, env.device):
        return env
    from repro_torch.soc import stacked, vecenv
    if isinstance(env, stacked.StackedVecEnv):
        return stacked.StackedVecEnv(
            env.socs, envs=[_env_on(e, dev) for e in env.envs],
            cycle_time=env.cycle_time, fused_step=env.fused_step)
    return vecenv.VecEnv(
        env.soc, profiles=env.profiles, cycle_time=env.cycle_time,
        demand_cache=env.demand_cache, presample_noise=env.presample_noise,
        ddr_attribution=env.ddr_attribution, fused_step=env.fused_step,
        debug_finite=env.debug_finite, device=dev)


def _map(fn, tree):
    """``fn`` over the tensor leaves of nested tuples (NamedTuples kept)."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, tuple):
        vals = [_map(fn, v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else \
            tuple(vals)
    return tree


def _chunk(tree, axis: int, i: int, n: int, dev):
    """Chunk ``i`` of ``n`` along ``axis`` of every tensor leaf, on
    ``dev``; other leaves pass through."""
    def cut(t):
        if t.dim() <= axis:
            return t.to(dev)
        size = t.shape[axis] // n
        return t.narrow(axis, i * size, size).to(dev)
    return _map(cut, tree)


def _concat(parts, axis: int, dev):
    """The chunks' results joined along ``axis`` on ``dev``."""
    first = parts[0]
    if first is None:
        return None
    if torch.is_tensor(first):
        if first.dim() <= axis:
            return first.to(dev)
        return torch.cat([p.to(dev) for p in parts], dim=axis)
    if isinstance(first, tuple):
        vals = [_concat([p[j] for p in parts], axis, dev)
                for j in range(len(first))]
        return type(first)(*vals) if hasattr(first, "_fields") else \
            tuple(vals)
    return first


def _to(spec, dev):
    """A FaultSpec (or None) on ``dev``."""
    return None if spec is None else spec.to(dev)


def _cfg_to(cfg, dev):
    if cfg is not None and torch.is_tensor(cfg.decay_steps):
        return cfg._replace(decay_steps=cfg.decay_steps.to(dev))
    return cfg


def _split(env, devs, batched: dict, out_axis: int, call):
    """Run ``call(env_d, **chunk_d, dev=d)`` per device on the chunks of
    the ``batched`` arguments (``name: (value, axis)``, each split along
    its axis); join the results along ``out_axis`` on ``devs[0]``."""
    n = len(devs)
    parts = [call(_env_on(env, d),
                  **{k: _chunk(v, ax, i, n, d)
                     for k, (v, ax) in batched.items()}, dev=d)
             for i, d in enumerate(devs)]
    return _concat(parts, out_axis, devs[0])


def _weights(weights_batch, b: int):
    """Reward weights with ``(b,)`` tensor leaves, so they split."""
    return type(weights_batch)(*(torch.as_tensor(
        v, dtype=torch.float32).expand(b) for v in weights_batch))


def sharded_train_batched(env, train_apps, cfg, weights_batch, keys, *,
                          eval_app=None, faults=None, devices=None,
                          force: bool = False):
    """``VecEnv.train_batched`` with the B agents split across devices.

    Same signature and results as the method; ``devices`` defaults to
    :func:`lane_devices`.  The plain call when there is one device (unless
    ``force``) or B does not divide the device count."""
    devs = _use_devices(devices, int(keys.shape[0]), force)
    if devs is None:
        return env.train_batched(train_apps, cfg, weights_batch, keys,
                                 eval_app, faults)

    def call(e, w, k, dev):
        return e.train_batched(train_apps, _cfg_to(cfg, dev), w, k,
                               eval_app, _to(faults, dev))

    return _split(env, devs, {"w": (_weights(weights_batch, keys.shape[0]),
                                    0), "k": (keys, 0)}, 0, call)


def sharded_train_batched_stacked(env, stacked_iters, cfg, weights_batch,
                                  keys, *, eval_stacked=None, faults=None,
                                  devices=None, force: bool = False):
    """``StackedVecEnv.train_batched`` with the B agents split across
    devices (``keys (K, B, 2)``; every device keeps all K lanes)."""
    devs = _use_devices(devices, int(keys.shape[1]), force)
    if devs is None:
        return env.train_batched(stacked_iters, cfg, weights_batch, keys,
                                 eval_stacked, faults)

    def call(e, w, k, dev):
        return e.train_batched(stacked_iters, _cfg_to(cfg, dev), w, k,
                               eval_stacked, _to(faults, dev))

    return _split(env, devs, {"w": (_weights(weights_batch, keys.shape[1]),
                                    0), "k": (keys, 1)}, 1, call)


def sharded_episodes(env, stacked, specs, cfg=None, keys=None, *,
                     devices=None, force: bool = False):
    """``StackedVecEnv.episodes`` with the N policies split across
    devices (specs are (K, N); every device keeps all K lanes)."""
    if keys is None:
        keys = env._default_keys(*specs.learned.shape)
    devs = _use_devices(devices, int(specs.learned.shape[1]), force)
    if devs is None:
        return env.episodes(stacked, specs, cfg, keys)

    def call(e, sp, k, dev):
        return e.episodes(stacked, sp, _cfg_to(cfg, dev), k)

    return _split(env, devs, {"sp": (specs, 1), "k": (keys, 1)}, 1, call)


def sharded_serve(env, stacked, specs, traffic, cfg=None, keys=None, *,
                  queue_cap: int = 8, n_requests: int = 1024,
                  devices=None, force: bool = False):
    """``StackedVecEnv.serve`` with the N policies split across devices
    (specs are (K, N); every device keeps all K lanes and the whole
    offered stream)."""
    if keys is None:
        keys = env._default_keys(*specs.learned.shape)
    devs = _use_devices(devices, int(specs.learned.shape[1]), force)
    if devs is None:
        return env.serve(stacked, specs, traffic, cfg, keys,
                         queue_cap=queue_cap, n_requests=n_requests)

    def call(e, sp, k, dev):
        return e.serve(stacked, sp, traffic.to(dev), _cfg_to(cfg, dev), k,
                       queue_cap=queue_cap, n_requests=n_requests)

    return _split(env, devs, {"sp": (specs, 1), "k": (keys, 1)}, 1, call)
