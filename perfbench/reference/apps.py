"""Evaluation applications (paper §5, "Applications").

An application is a set of *phases*, each meant to represent a real
multithreaded program: a phase has N threads, each thread owns a dataset and
runs a chain of accelerators serially over it (output of one is input of the
next), optionally looping.  Instances vary thread counts, workload sizes and
accelerator parameters so that the policies are exercised across operating
conditions.

Workload-size characterization (paper §5): Small (< accelerator L2),
Medium (< one LLC partition), Large (< aggregate LLC), Extra-Large (> LLC).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from perfbench.reference.config import SoCConfig
from perfbench.reference.appdefs import Application, Invocation, Phase, Thread

SIZE_CLASSES = ("S", "M", "L", "XL")


def sample_footprint(rng: np.random.Generator, soc: SoCConfig,
                     size_class: str) -> float:
    l2, slice_, llc = soc.l2_bytes, soc.llc_slice_bytes, soc.llc_total_bytes
    lo, hi = {
        "S": (2 * 1024, l2),
        "M": (l2, slice_),
        "L": (slice_, llc),
        "XL": (llc, 4 * llc),
    }[size_class]
    return float(np.exp(rng.uniform(np.log(lo), np.log(hi))))


# Loop counts per size class: small-workload threads iterate more (as in
# the paper's apps, where accelerators are "invoked multiple times in a
# row"), keeping phase contributions comparable across classes.
LOOPS_BY_CLASS = {"S": 6, "M": 4, "L": 2, "XL": 1}


def make_phase(rng: np.random.Generator, soc: SoCConfig, *, name: str,
               n_threads: int, size_classes: Sequence[str],
               chain_len: int = 3, loops: int | None = None) -> Phase:
    """Random phase: each thread chains ``chain_len`` random accelerators.

    Threads start on distinct accelerator instances (a round-robin over a
    random permutation) so parallelism is real; the device-locking in the
    simulator still serializes any residual collisions.
    """
    threads = []
    perm = rng.permutation(soc.n_accs)
    for t in range(n_threads):
        size_class = size_classes[t % len(size_classes)]
        fp = sample_footprint(rng, soc, size_class)
        chain = [
            Invocation(acc_id=int(perm[(t + j) % soc.n_accs]), footprint=fp)
            for j in range(chain_len)
        ]
        threads.append(Thread(
            chain=chain,
            loops=loops if loops is not None else LOOPS_BY_CLASS[size_class]))
    return Phase(name=name, threads=threads)


def make_application(soc: SoCConfig, seed: int = 0, n_phases: int = 8,
                     max_threads: int | None = None) -> Application:
    """Randomly-configured evaluation-application instance (paper §5).

    Phases sweep thread counts and size classes so that several hundred
    invocations cover the operating space; different seeds give the
    train/test instance split used in the paper.
    """
    rng = np.random.default_rng(seed)
    max_threads = max_threads or min(12, soc.n_accs)
    phases = []
    for p in range(n_phases):
        n_threads = int(rng.integers(1, max_threads + 1))
        # Each phase stresses one workload-size class (the paper's phases
        # are "meant to represent a real application"); round-robin over
        # classes guarantees coverage of all operating conditions.
        sizes = [SIZE_CLASSES[p % len(SIZE_CLASSES)]]
        if rng.uniform() < 0.25:    # occasional mixed-size phase
            sizes.append(str(rng.choice(SIZE_CLASSES)))
        phases.append(make_phase(
            rng, soc, name=f"phase{p}({n_threads}t,{'/'.join(sizes)})",
            n_threads=n_threads, size_classes=sizes,
            chain_len=int(rng.integers(2, 5))))
    return Application(name=f"{soc.name}-app-seed{seed}", phases=phases)


def make_case_study_app(soc: SoCConfig, seed: int = 0,
                        loops: int = 2) -> Application:
    """Domain-appropriate pipelines for the case-study SoCs (paper §5).

    SoC5 (autonomous vehicles): FFT->Viterbi V2V chains + Conv2D->GEMM CNN
    chains.  SoC6 (computer vision): night-vision -> autoencoder -> MLP
    image pipelines, parallelized across the three copies.  SoC4 (one of
    each): mixed chains across all accelerators.
    """
    rng = np.random.default_rng(seed)
    name_to_ids: dict[str, list[int]] = {}
    for i, n in enumerate(soc.accelerators):
        name_to_ids.setdefault(n, []).append(i)

    def chain_of(names: Sequence[str], copy: int, fp: float) -> Thread:
        chain = [
            Invocation(acc_id=name_to_ids[n][copy % len(name_to_ids[n])],
                       footprint=fp)
            for n in names
        ]
        return Thread(chain=chain, loops=loops)

    phases = []
    if soc.name == "SoC6":
        pipeline = ("nightvision", "autoencoder", "mlp")
        for p, sizes in enumerate((("S",), ("M",), ("L",), ("M", "XL"))):
            threads = [
                chain_of(pipeline, c,
                         sample_footprint(rng, soc, sizes[c % len(sizes)]))
                for c in range(3)
            ]
            phases.append(Phase(name=f"cv-phase{p}", threads=threads))
    elif soc.name == "SoC5":
        v2v = ("fft", "viterbi")
        cnn = ("conv2d", "gemm")
        for p, sizes in enumerate((("S",), ("M",), ("L",), ("XL",))):
            threads = []
            for c in range(2):
                threads.append(chain_of(
                    v2v, c, sample_footprint(rng, soc, sizes[0])))
                threads.append(chain_of(
                    cnn, c, sample_footprint(rng, soc, sizes[0])))
            phases.append(Phase(name=f"av-phase{p}", threads=threads))
    else:  # SoC4 and any generic case
        for p, sizes in enumerate((("S", "M"), ("M",), ("L",), ("M", "XL"))):
            n_threads = min(6, soc.n_accs)
            threads = []
            for t in range(n_threads):
                names = [soc.accelerators[int(rng.integers(0, soc.n_accs))]
                         for _ in range(3)]
                threads.append(chain_of(
                    names, 0,
                    sample_footprint(rng, soc, sizes[t % len(sizes)])))
            phases.append(Phase(name=f"mixed-phase{p}", threads=threads))
    return Application(name=f"{soc.name}-casestudy", phases=phases)
