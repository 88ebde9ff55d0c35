"""What the benchmark makes and hands to both sides: SoCs, applications
and keys, all from a configuration file, a traffic file and ``--seed``.

The reference's own generators make them (:mod:`perfbench.reference`);
:func:`port_soc` and :func:`port_app` convert the records to the
program's types, so the program and the reference start from the same
SoCs, the same applications and the same keys, and each works out the
rest (schedules, profiles, noise, lowered policies) by itself.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from perfbench.reference import apps as ref_apps
from perfbench.reference import prng
from perfbench.reference.config import MemTimings, SoCConfig

HERE = Path(__file__).resolve().parent
_M32 = (1 << 32) - 1


def load_json(kind: str, name: str) -> dict:
    """``perfbench/<kind>/<name>.json``."""
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def ref_soc(row: dict, timings: dict) -> SoCConfig:
    """A configuration's SoC row as the reference's record."""
    return SoCConfig(**{**row, "accelerators": tuple(row["accelerators"]),
                        "no_private_cache": tuple(row["no_private_cache"]),
                        "timings": MemTimings(**timings)})


def port_soc(soc: SoCConfig):
    """The same SoC as the program's record."""
    from repro_torch.soc import config as pc
    return pc.SoCConfig(
        name=soc.name, n_accs=soc.n_accs, noc_rows=soc.noc_rows,
        noc_cols=soc.noc_cols, n_cpus=soc.n_cpus,
        n_mem_tiles=soc.n_mem_tiles, llc_slice_bytes=soc.llc_slice_bytes,
        l2_bytes=soc.l2_bytes, accelerators=soc.accelerators,
        no_private_cache=soc.no_private_cache,
        timings=pc.MemTimings(**vars(soc.timings)))


def port_app(app):
    """A reference application record as the program's record."""
    from repro_torch.soc import des
    return des.Application(name=app.name, phases=[
        des.Phase(name=ph.name, threads=[
            des.Thread(chain=[des.Invocation(acc_id=inv.acc_id,
                                             footprint=inv.footprint)
                              for inv in th.chain], loops=th.loops)
            for th in ph.threads])
        for ph in app.phases])


def lanes(config: dict) -> list[dict]:
    """Each lane of a configuration with its SoC record: ``soc``,
    ``flavor``, ``profile_seed``."""
    socs = {r["name"]: r for r in config["socs"]}
    return [{**lane, "soc": ref_soc(socs[lane["soc"]], config["timings"])}
            for lane in config["lanes"]]


def make_app(soc: SoCConfig, spec: dict):
    """An application from a traffic file's app entry: ``{"seed",
    "n_phases"}``, with ``"case_study"`` naming the SoCs that run their
    domain pipelines instead (paper section 5)."""
    if soc.name in spec.get("case_study", ()):
        return ref_apps.make_case_study_app(soc, seed=spec["seed"])
    return ref_apps.make_application(soc, seed=spec["seed"],
                                     n_phases=spec["n_phases"])


def app_steps(app) -> int:
    """The invocations an application issues: each thread's chain times
    its loops, over every phase (an episode's valid steps)."""
    return sum(len(th.chain) * th.loops for ph in app.phases
               for th in ph.threads)


def app_threads(app) -> int:
    """The widest phase's thread count (an episode's slot count)."""
    return max((len(ph.threads) for ph in app.phases), default=1)


def run_key(seed: int, stream: int) -> torch.Tensor:
    """The ``(2,)`` key of one stream of a run: ``--seed`` as a 64-bit
    JAX-style seed (high and low words), folded with ``stream``."""
    s = int(seed)
    base = torch.tensor([(s >> 32) & _M32, s & _M32], dtype=torch.int64)
    return prng.fold_in(base, stream)


def unit_keys(seed: int, stream: int, unit: int, shape: tuple) -> torch.Tensor:
    """``shape + (2,)`` keys of one unit (a job or a chunk) of a stream."""
    n = int(np.prod(shape))
    ks = prng.split(prng.fold_in(run_key(seed, stream), unit), n)
    return ks.reshape(*shape, 2)
