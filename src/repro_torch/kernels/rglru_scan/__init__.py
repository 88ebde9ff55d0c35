"""RG-LRU diagonal linear recurrence: ``ref`` (plain PyTorch, step by
step), ``kernel`` (CUDA C++ for sm_90a, ``csrc/rglru_scan.cu``) and
``ops`` (dispatch)."""
