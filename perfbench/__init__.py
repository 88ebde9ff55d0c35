"""The benchmark of the PyTorch/CUDA port (``repro_torch``): a harness
(:mod:`perfbench.harness`, entry ``perfbench/run.py``) driven by the
configurations, traffic mixes, drivers and per-layer metric readers in
this folder's subfolders, and a frozen plain reference
(:mod:`perfbench.reference`) that decides whether a run is correct."""
